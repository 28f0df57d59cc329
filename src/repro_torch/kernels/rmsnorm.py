"""RMSNorm: x * rsqrt(mean(x^2) + eps) * w, the mean of squares in f32,
out in x's dtype; any row count (the TPU kernel raised when the rows did
not divide its block).

Replaces ``repro/kernels/rmsnorm.py:rmsnorm_fwd``; the CUDA source is
``csrc/rmsnorm.cu``.  CPU tensors take the plain version
(:func:`ref.rmsnorm_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import _build, ops
from .ref import rmsnorm_ref

launches = 0
rejected = 0


def supported(x: torch.Tensor, w: torch.Tensor) -> bool:
    global rejected
    ok = ops.rmsnorm_supported(tuple(x.shape), x.dtype, w.dtype)
    if not ok and x.is_cuda:
        rejected += 1
    return ok


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    global launches
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    d = x.shape[-1]
    if tuple(w.shape) != (d,) or \
            not ops.rmsnorm_supported(tuple(x.shape), x.dtype, w.dtype):
        raise ValueError(f"rmsnorm kernel does not take x "
                         f"{tuple(x.shape)} {x.dtype}, w {tuple(w.shape)} "
                         f"{w.dtype}")
    shape = x.shape
    rows = x.numel() // d
    x = _build.operand(x, "rmsnorm", x.device)
    w = _build.operand(w, "rmsnorm", x.device)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    rc = _build.lib().repro_rmsnorm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, float(eps),
        _build.dtype_code(x, "rmsnorm"), _build.dtype_code(w, "rmsnorm"),
        _build.stream(x))
    _build.check(rc, "rmsnorm")
    launches += 1
    return out
