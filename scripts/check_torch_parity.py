"""Parity gate of the torch port against the JAX package on the serving
graphs (the port's counterpart of ``scripts/check_kernel_parity.py``).

This is the one file outside the tests that imports both packages: it
holds ``repro_torch`` to ``repro``, as the reference's parity scripts
hold one lowering to another.  The port itself imports neither ``jax``
nor ``repro``.

For each serving graph kind of the dense family -- ``prefill``,
``decode``, ``serve``, the paged decode chunk and the paged prefill
chunk -- the same graph is built by both packages (their structural
signatures must agree) and run on the same numpy inputs (the recipe of
``check_kernel_parity.make_args``: the builder's seeded weights, integer
inputs drawn below ``min(vocab, 100)``, float inputs zero) three ways:
JAX at O1, torch at O1, and torch at O2 with ``use_pallas=True`` (the
fused compounds through the Hopper kernels on the card, their plain
versions on the CPU).  The gate fails unless

  * the O2 pipeline formed at least the compounds of ``EXPECTED``;
  * each torch output agrees with JAX's: integer outputs exactly, float
    outputs within 1e-4 of scale in f32 and 3e-2 in bf16, and logits
    (last dim the vocabulary) with the same argmax (``compare``, as in
    ``check_kernel_parity``);
  * on a CUDA device, every kernel on a graph's path launched at least
    once in its O2 run (the launch counters; the reduced vocabulary's
    unembed is refused by the kernels' shape rule and runs plain).

Run (the port's device defaults to the card):

    PYTHONPATH=src python scripts/check_torch_parity.py --device cpu
    PYTHONPATH=src python scripts/check_torch_parity.py --device cpu \
        --width dh128
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

# per-kind minimum fusion hit counts (rotary+QKV only matches the batch
# rope tables of the prefill path; decode/serve and the paged graphs use
# per-row or sliced tables the compound rejects); the train graph waits
# for the training slice of the port
EXPECTED = {
    "prefill": {"swiglu": 1, "norm_matmul": 1, "rotary_qkv": 1},
    "decode": {"swiglu": 1, "norm_matmul": 1},
    "serve": {"swiglu": 1, "norm_matmul": 1},
    "paged_chunk": {"swiglu": 1, "norm_matmul": 1},
    "paged_prefill": {"swiglu": 1, "norm_matmul": 1},
}
# the graph kinds that hold an Attention op, which the flash kernel
# carries at head widths of a multiple of 128; the others attend through
# IR compositions
ATTENTION_KINDS = ("prefill", "decode")
# max_len, batch, and the paged graphs' shape: n_pages and max_len cover
# every page id and position below 100 that make_args may draw
MAX_LEN, BATCH = 16, 2
PAGED_MAX_LEN, PAGE_SIZE, N_PAGES, STEPS, CHUNK = 128, 8, 100, 2, 16
WIDTHS = {"reduced": {},
          "dh128": dict(d_model=256, n_heads=2, n_kv_heads=2, d_head=128,
                        d_ff=256)}


def build(lm, shape_config, cfg, kind):
    """One serving graph of ``kind``, built by the package whose
    ``models.lm`` and ``ShapeConfig`` are ``lm`` and ``shape_config``."""
    if kind == "paged_chunk":
        return lm.build_dense_chunk(cfg, PAGED_MAX_LEN, BATCH, STEPS,
                                    page_size=PAGE_SIZE, n_pages=N_PAGES)
    if kind == "paged_prefill":
        return lm.build_dense_paged_prefill(cfg, PAGED_MAX_LEN, CHUNK,
                                            page_size=PAGE_SIZE,
                                            n_pages=N_PAGES)
    return lm.build_graphs(cfg, shape_config(kind, kind, MAX_LEN, BATCH),
                           BATCH)


def make_args(g, cfg, rng):
    params = g.builder.init_params(0)
    args = []
    for node in g.fn.parameters:
        t = node.out_types[0]
        if node.name in params:
            args.append(params[node.name])
        elif "int" in str(t.dtype):
            args.append(rng.integers(
                0, min(cfg.vocab, 100), size=t.shape).astype(str(t.dtype)))
        else:
            args.append(np.zeros(t.shape, str(t.dtype)))
    return args


def compare(where, a, b, vocab, errors):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        errors.append(f"{where}: {b.shape} {b.dtype} against JAX's "
                      f"{a.shape} {a.dtype}")
        return
    if a.dtype.kind in "iub":
        if not np.array_equal(a, b):
            errors.append(f"{where}: integer outputs differ")
        return
    af = a.astype(np.float64)
    bf = b.astype(np.float64)
    # bf16 storage: one ulp of headroom on top of accumulated error
    tol = 3e-2 if "bfloat16" in str(a.dtype) else 1e-4
    scale = max(float(np.abs(af).max()), 1.0)
    diff = float(np.abs(af - bf).max())
    if diff > tol * scale:
        errors.append(f"{where}: max |jax - torch| = {diff:.3e} "
                      f"(tol {tol * scale:.3e})")
    # logits: greedy parity.  The reference's rule finds logits by a last
    # dim over 100, which at d_head 128 also takes the KV caches, whose
    # head-dim argmax means nothing; the vocabulary names them exactly
    if af.ndim >= 2 and af.shape[-1] == vocab:
        if not np.array_equal(af.argmax(-1), bf.argmax(-1)):
            errors.append(f"{where}: greedy argmax differs")


def required_kernels(kind: str, cfg) -> List[str]:
    need = ["matmul", "norm_matmul", "swiglu", "rmsnorm"]
    if kind in ATTENTION_KINDS and cfg.head_dim % 128 == 0:
        need.append("flash_attention")
    return need


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the torch side's device: 'cuda', 'cuda:i' or "
                         "'cpu' (default: the card)")
    ap.add_argument("--width", choices=sorted(WIDTHS), default="reduced",
                    help="reduced deepseek-7b as it stands, or at d_head "
                         "128 (d_model 256, 2 heads), where the flash "
                         "kernel carries the Attention op")
    args = ap.parse_args(argv)

    from repro.backend import Backend as JBackend
    from repro.backend import CompileOptions as JOptions
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.models import lm as j_lm
    from repro_torch import kernels
    from repro_torch.backend import Backend, CompileOptions
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm as t_lm

    over = WIDTHS[args.width]
    jcfg = j_get_config("deepseek-7b").reduced(**over)
    tcfg = get_config("deepseek-7b").reduced(**over)
    jbe = JBackend.create("jax")
    tbe = Backend.create("torch", device=args.device)
    on_card = tbe.device.type == "cuda"
    rng = np.random.default_rng(0)
    errors: List[str] = []
    for kind, expected in EXPECTED.items():
        jg = build(j_lm, JShapeConfig, jcfg, kind)
        tg = build(t_lm, ShapeConfig, tcfg, kind)
        if jg.fn.signature() != tg.fn.signature():
            errors.append(f"{kind}: the two packages built different "
                          f"graphs")
            continue
        args_np = make_args(jg, jcfg, rng)
        ref = jbe.compile(jg.fn, JOptions(level="O1"))(*args_np)
        o1 = tbe.compile(tg.fn, CompileOptions(level="O1"))(*args_np)
        fused = tbe.compile(tg.fn, CompileOptions(level="O2",
                                                  use_pallas=True))
        kernels.reset_counters()
        o2 = fused(*args_np)
        counts = kernels.counters()
        hits = dict(fused.report.stats).get("fuse-compounds", {})
        for compound, n in expected.items():
            if hits.get(compound, 0) < n:
                errors.append(f"{kind}: expected >= {n} {compound} "
                              f"fusions, got {hits.get(compound, 0)} "
                              f"(hits: {hits})")
        for label, outs in (("O1", o1), ("O2", o2)):
            if len(outs) != len(ref):
                errors.append(f"{kind} {label}: {len(outs)} outputs, JAX "
                              f"gives {len(ref)}")
                continue
            for i, (a, b) in enumerate(zip(ref, outs)):
                compare(f"{kind} torch {label} output {i}", a, b,
                        tcfg.vocab, errors)
        launched = {k: c["launches"] for k, c in counts.items()}
        if on_card:
            for name in required_kernels(kind, tcfg):
                if launched[name] == 0:
                    errors.append(f"{kind}: kernel {name} never launched "
                                  f"on the card ({counts})")
        shown = {k: v for k, v in hits.items() if v}
        print(f"{kind}: fused {shown}, torch O1 and O2 match JAX O1 "
              f"on {tbe.device}; launches {launched}")
    if errors:
        for e in errors:
            print(f"PARITY FAIL: {e}", file=sys.stderr)
        return 1
    print(f"torch parity ok ({args.width}, {tbe.device}): O1 and O2 "
          f"(kernels) match JAX O1 on every dense serving graph")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
