"""Fused RMSNorm + matmul: (rmsnorm(x, g) rounded to x's dtype) @ w, f32
accumulation, out in x's dtype.  ``g`` may be f32 while x and w are bf16
(the final norm before the unembed).

Replaces ``repro/kernels/norm_matmul.py:_norm_matmul_kernel`` (the
Pallas TPU kernel behind ``norm_matmul``); the CUDA source is
``csrc/norm_matmul.cu``.  CPU tensors take the plain version
(:func:`ref.norm_matmul_ref`); CUDA tensors launch the kernel or raise.

What bounds it on the H100: the bytes of w, read once (a 32 MB
projection or the 839 MB unembed) for 2 * M flops per element, far
below the tensor cores' rate at M = 4 or 64.  For bf16 and f16 a small
kernel computes each row's inverse RMS once (one order fixed by D), and
the GEMM -- matmul's tensor-core mainloop (``csrc/tc_gemm.cuh``: a ring
of ``cp.async`` stages, ``mma.sync`` into f32) with the norm as its A
transform -- launches as its programmatic dependent: it streams its
first stages of w while the first kernel runs and waits for it only to
read inv; each warp then normalises the A fragments of x it reads, in
registers, so no normalised row is held whole and M = 64 takes matmul's
64-row tile.  The wrapper counts the pair as one launch.  Each output is
reduced in matmul's K order, fixed by D alone, so a row gives the same
bits alone or in any batch.  f32 stays on the CUDA cores with its rows
normalised into shared memory (``ops.norm_matmul_plan``).
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
    plan = ops.norm_matmul_plan(M, D, N, x.dtype, g.dtype)
    if plan is None or not ops.matmul_supported(M, D, N, x.dtype):
        raise ValueError(f"norm_matmul kernel does not take M={M} D={D} "
                         f"N={N} {x.dtype}")
    x = _build.operand(x, "norm_matmul", x.device)
    g = _build.operand(g, "norm_matmul", x.device)
    w = _build.operand(w, "norm_matmul", x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    # the rows' inverse RMS, between the tensor-core route's two kernels
    inv = (torch.empty((M,), dtype=torch.float32, device=x.device)
           if plan.route == "tensor_core" else None)
    _build.launch(
        "repro_norm_matmul", x.device, x.data_ptr(), g.data_ptr(),
        w.data_ptr(), out.data_ptr(),
        inv.data_ptr() if inv is not None else None, M, D, N, plan.bm,
        float(eps), _build.dtype_code(x, "norm_matmul"),
        _build.dtype_code(g, "norm_matmul"), _build.stream(x))
    launches += 1
    return out
