"""The port's hand-written Hopper kernels (CUDA C++ for sm_90a, built from
``csrc/`` at first use; see :mod:`._build`).

Each kernel module holds one wrapper, its plain PyTorch version (in
:mod:`.ref`) for CPU tensors, a ``supported`` shape predicate, and two
counters: ``launches`` (one per kernel launch, nowhere else) and
``rejected`` (CUDA calls whose shape the predicate refused).
"""
from __future__ import annotations

from typing import Dict

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
}


def counters() -> Dict[str, Dict[str, int]]:
    """``{kernel: {"launches": n, "rejected": n}}``."""
    return {k: {"launches": m.launches, "rejected": m.rejected}
            for k, m in MODULES.items()}


def reset_counters() -> None:
    for m in MODULES.values():
        m.launches = 0
        m.rejected = 0
