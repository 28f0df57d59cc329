"""Fused RMSNorm + matmul: (rmsnorm(x, g) rounded to x's dtype) @ w, f32
accumulation, out in x's dtype.  ``g`` may be f32 while x and w are bf16
(the final norm before the unembed).

Replaces ``repro/kernels/norm_matmul.py:norm_matmul``; the CUDA source
is ``csrc/norm_matmul.cu``.  CPU tensors take the plain version
(:func:`ref.norm_matmul_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import _build, ops
from .ref import norm_matmul_ref

launches = 0
rejected = 0


def supported(x: torch.Tensor, w: torch.Tensor) -> bool:
    global rejected
    ok = ops.norm_matmul_supported(x.shape[0], x.shape[1], w.shape[1],
                                   x.dtype)
    if not ok and x.is_cuda:
        rejected += 1
    return ok


def norm_matmul(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    global launches
    if x.device.type == "cpu":
        return norm_matmul_ref(x, g, w, eps=eps)
    M, D = x.shape
    D2, N = w.shape
    if D != D2 or tuple(g.shape) != (D,) or x.dtype != w.dtype:
        raise ValueError(
            f"norm_matmul: x {tuple(x.shape)} {x.dtype}, g "
            f"{tuple(g.shape)}, w {tuple(w.shape)} {w.dtype}")
    bm = ops.norm_matmul_tile(M, D, x.dtype)
    if bm is None or not ops.norm_matmul_supported(M, D, N, x.dtype):
        raise ValueError(f"norm_matmul kernel does not take M={M} D={D} "
                         f"N={N} {x.dtype}")
    x = _build.operand(x, "norm_matmul", x.device)
    g = _build.operand(g, "norm_matmul", x.device)
    w = _build.operand(w, "norm_matmul", x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = _build.lib().repro_norm_matmul(
        x.data_ptr(), g.data_ptr(), w.data_ptr(), out.data_ptr(), M, D, N,
        bm, float(eps), _build.dtype_code(x, "norm_matmul"),
        _build.dtype_code(g, "norm_matmul"), _build.stream(x))
    _build.check(rc, "norm_matmul")
    launches += 1
    return out
