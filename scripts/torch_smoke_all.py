"""Build and run every reduced arch x graph kind through the torch backend
(the port of ``scripts/smoke_all.py``; imports only ``repro_torch``).

``python scripts/torch_smoke_all.py [ARCH ...] [--device cpu]``
compiles each arch's reduced config as a train step (IR autodiff +
AdamW), a prefill, a decode and, where the arch is sub-quadratic, a
long decode with ``Backend.create("torch")`` -- on the card unless
``--device cpu`` -- runs it on seeded inputs, requires a finite loss and
finite outputs, and prints ``ALL OK``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

B, S = 2, 16
SKV = 32


def data_for(cfg, b):
    """numpy inputs for the builder's data inputs."""
    rng = np.random.default_rng(0)
    out = []
    for node in b.inputs:
        name = node.name
        t = node.out_types[0]
        if name in ("tokens", "labels", "token"):
            out.append(rng.integers(0, cfg.vocab, size=t.shape)
                       .astype(np.int32))
        elif name == "pos":
            out.append(np.int32(SKV // 2))
        else:  # caches / frames / images
            if np.issubdtype(t.dtype, np.integer):
                out.append(np.zeros(t.shape, t.dtype))
            else:
                out.append((rng.normal(size=t.shape) * 0.01).astype(t.dtype))
    return out


def _host(x) -> np.ndarray:
    """An output (a device tensor or a host array) as f32 numpy."""
    import torch
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def run(arch: str, device: str) -> None:
    from repro_torch.backend import Backend
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs
    from repro_torch.models.train_graph import init_opt_state, make_train_step

    cfg = get_config(arch).reduced()
    backend = Backend.create("torch", device=device)
    for kind, seq in (("train", S), ("prefill", S), ("decode", SKV),
                      ("long_decode", SKV)):
        if kind == "long_decode" and not cfg.sub_quadratic:
            continue
        g = build_graphs(cfg, ShapeConfig(kind, kind, seq, B), B)
        params = g.builder.init_params(0)
        data = data_for(cfg, g.builder)
        if kind == "train":
            ts = make_train_step(g, cfg)
            m, v = init_opt_state(g.builder, cfg, params)
            ex = backend.compile(ts.fn)
            outs = ex(*(data + [np.int32(0)]
                        + [params[n] for n in ts.param_names]
                        + [m[n] for n in ts.param_names]
                        + [v[n] for n in ts.param_names]))
            loss = float(_host(outs[0]))
            assert np.isfinite(loss), f"{arch} {kind}: loss={loss}"
            print(f"  {arch:24s} {kind:12s} loss={loss:.4f} "
                  f"nodes={len(ts.fn.nodes())}", flush=True)
        else:
            ex = backend.compile(g.fn)
            outs = ex(*(data + [params[n] for n in g.builder.param_names()]))
            for o in outs:
                assert np.all(np.isfinite(_host(o))), \
                    f"{arch} {kind}: non-finite output"
            print(f"  {arch:24s} {kind:12s} out0={tuple(outs[0].shape)} "
                  f"nodes={len(g.fn.nodes())}", flush=True)


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda', 'cuda:i' or 'cpu' (default: the card)")
    args = ap.parse_args(argv)
    for a in args.archs or ARCHS:
        run(a, args.device)
    print("ALL OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
