"""The port's hand-written Hopper kernels (CUDA C++ for sm_90a, built from
``csrc/`` at first use; see :mod:`._build`): the five ports of the
reference's Pallas kernels, and ``batched_matmul``, which replaces no
TPU kernel (the emitter's fixed-order route for every other floating
contraction).

Each kernel module holds one wrapper, its plain PyTorch version (in
:mod:`.ref`) for CPU tensors, a ``supported`` shape predicate, and two
counters: ``launches`` (one per kernel launch, nowhere else) and
``rejected`` (CUDA calls whose shape the predicate refused).
"""
from __future__ import annotations

from typing import Dict

from . import batched_matmul as _batched_matmul
from . import flash_attention as _flash_attention
from . import matmul as _matmul
from . import norm_matmul as _norm_matmul
from . import rmsnorm as _rmsnorm
from . import swiglu as _swiglu

# kernel name -> wrapper module
MODULES = {
    "matmul": _matmul,
    "norm_matmul": _norm_matmul,
    "swiglu": _swiglu,
    "rmsnorm": _rmsnorm,
    "flash_attention": _flash_attention,
    "batched_matmul": _batched_matmul,
}


def counters() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"launches": n, "rejected": n}}``."""
    return {k: {"launches": m.launches, "rejected": m.rejected}
            for k, m in MODULES.items()}


def reset_counters() -> None:
    for m in MODULES.values():
        m.launches = 0
        m.rejected = 0


def set_counters(counts: Dict[str, Dict[str, int]]) -> None:
    """Put the counters back to a :func:`counters` snapshot."""
    for k, c in counts.items():
        MODULES[k].launches = c["launches"]
        MODULES[k].rejected = c["rejected"]


def counter_delta(before: Dict[str, Dict[str, int]],
                  after: Dict[str, Dict[str, int]]
                  ) -> Dict[str, Dict[str, int]]:
    """``after - before`` per kernel and counter (two :func:`counters`)."""
    return {k: {c: after[k][c] - before[k][c] for c in after[k]}
            for k in after}


def add_counts(delta: Dict[str, Dict[str, int]]) -> None:
    """Add a :func:`counter_delta` to the counters: a CUDA-graph replay
    runs the launches its capture recorded without passing through the
    wrappers, so the replayer adds the capture's delta each time."""
    for k, d in delta.items():
        MODULES[k].launches += d["launches"]
        MODULES[k].rejected += d["rejected"]
