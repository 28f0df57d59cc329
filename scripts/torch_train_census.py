"""The kernel launches of one train step, by shape and route, counted from
the compiled graph on the meta device (no card, no memory, seconds).

The step is ``chip_smoke.py``'s phase 8 by default: deepseek-7b at full
width cut to 4 layers, batch 4 x 512 tokens, IR autodiff + AdamW at O2
with the kernels.  Each kernel wrapper is replaced by its plain version
for the walk and counts its calls by operand shapes and types; each line
also names the route the kernel's plan (``kernels/ops.py``) takes there:

    PYTHONPATH=src python scripts/torch_train_census.py
    -> [train_census] norm_matmul x (2048, 4096) bfloat16 g (4096,) float32 w (4096, 102400): 1 a step, route wgmma
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

PLAIN = {"matmul": ref.matmul_ref, "norm_matmul": ref.norm_matmul_ref,
         "swiglu": ref.swiglu_ref, "rmsnorm": ref.rmsnorm_ref,
         "flash_attention": ref.flash_attention_ref,
         "batched_matmul": ref.batched_matmul_ref}


def _route(name: str, ts) -> str:
    """The route of ``name``'s plan for operands ``ts`` (2-D products)."""
    dt = ts[0].dtype
    if name == "matmul":
        return ops.matmul_plan(*ts[0].shape, ts[1].shape[1], dt).route
    if name == "norm_matmul":
        return ops.norm_matmul_plan(*ts[0].shape, ts[2].shape[1], dt,
                                    ts[1].dtype).route
    if name == "swiglu":
        return ops.swiglu_plan(*ts[0].shape, ts[1].shape[1],
                               ts[3].shape[1], dt).route
    return "-"


def census(arch: str, layers: int, batch: int, seq: int) -> dict:
    """{(kernel, operand shapes and types, route): calls} of one step."""
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs
    from repro_torch.models.train_graph import make_train_step
    from repro_torch.transformers.torch_emit import torch_dtype

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    ts = make_train_step(build_graphs(
        cfg, ShapeConfig("train", "train", seq, batch), batch), cfg)
    cf = Backend.create("torch", device="meta").compile(
        ts.fn, CompileOptions(level="O2", use_pallas=True, static_jit=False))
    seen = collections.Counter()
    saved = []
    for name, mod in kernels.MODULES.items():
        saved.append((mod, name, getattr(mod, name)))

        def call(*a, _n=name, **kw):
            ts_ = [t for t in a if isinstance(t, torch.Tensor)]
            key = " ".join(f"{tuple(t.shape)} {str(t.dtype)[6:]}"
                           for t in ts_)
            seen[(_n, key, _route(_n, ts_))] += 1
            return PLAIN[_n](*a, **kw)
        setattr(mod, name, call)
    try:
        cf(*[torch.empty(p.out_types[0].shape,
                         dtype=torch_dtype(p.out_types[0].dtype),
                         device="meta") for p in ts.fn.parameters])
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return dict(seen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)
    seen = census(args.arch, args.layers, args.batch, args.seq)
    for (name, shapes, route), n in sorted(seen.items()):
        print(f"[train_census] {name} {shapes}: {n} a step, route {route}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
