"""Tiled matmul: (M, K) @ (K, N) with f32 accumulation, out in a's dtype.

Replaces ``repro/kernels/matmul.py:matmul`` (the Pallas TPU kernel); the
CUDA source is ``csrc/matmul.cu``.  On a CPU tensor the wrapper runs the
plain version (:func:`ref.matmul_ref`); on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build, ops
from .ref import matmul_ref

launches = 0   # kernel launches (CUDA only)
rejected = 0   # CUDA calls whose shape the predicate refused


def supported(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The kernel's shape predicate for a 2-D ``a @ b``; a refusal of a
    CUDA operand is counted in :data:`rejected`."""
    global rejected
    ok = ops.matmul_supported(a.shape[0], a.shape[1], b.shape[1], a.dtype)
    if not ok and a.is_cuda:
        rejected += 1
    return ok


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global launches
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    M, K = a.shape
    K2, N = b.shape
    if K != K2 or a.dtype != b.dtype:
        raise ValueError(f"matmul: {tuple(a.shape)} {a.dtype} @ "
                         f"{tuple(b.shape)} {b.dtype}")
    if not ops.matmul_supported(M, K, N, a.dtype):
        raise ValueError(f"matmul kernel does not take M={M} K={K} N={N} "
                         f"{a.dtype}")
    a = _build.operand(a, "matmul", a.device)
    b = _build.operand(b, "matmul", a.device)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    rc = _build.lib().repro_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
        _build.dtype_code(a, "matmul"), _build.stream(a))
    _build.check(rc, "matmul")
    launches += 1
    return out
