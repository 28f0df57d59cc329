"""Fused RMSNorm + matmul: (rmsnorm(x, g) rounded to x's dtype) @ w, f32
accumulation, out in x's dtype.  ``g`` may be f32 while x and w are bf16
(the final norm before the unembed).

Replaces ``repro/kernels/norm_matmul.py:_norm_matmul_kernel`` (the
Pallas TPU kernel behind ``norm_matmul``); the CUDA source is
``csrc/norm_matmul.cu``.  CPU tensors take the plain version
(:func:`ref.norm_matmul_ref`); CUDA tensors launch the kernel or raise.

What bounds it on the H100: the bytes of w, read once (a 32 MB
projection or the 839 MB unembed) for 2 * M flops per element, far
below the tensor cores' rate at M = 4 or 64.  For bf16 and f16 up to
``ops.WG_MIN_ROWS`` rows (decode, a prefill chunk) a small
kernel computes each row's inverse RMS once (one order fixed by D), and
the GEMM -- matmul's tensor-core mainloop (``csrc/tc_gemm.cuh``: a ring
of ``cp.async`` stages, ``mma.sync`` into f32) with the norm as its A
transform -- launches as its programmatic dependent: it streams its
first stages of w while the first kernel runs and waits for it only to
read inv; each warp then normalises the A fragments of x it reads, in
registers, so no normalised row is held whole and M = 64 takes matmul's
64-row tile.  Above the threshold (a dense prefill, a train step's 2048
rows), where the tensor cores bind, the small kernel writes each row
normalised and rounded to x's dtype -- what those fragments hold -- to
an (M, D) workspace, and matmul's wgmma launch (``csrc/wg_gemm.cuh``) is
its programmatic dependent on those rows: 16-bit norm_matmul there is
bit for bit ``matmul(rows, w)``.  The wrapper counts the pair as one
launch.  Each output is reduced in matmul's K order, fixed by D alone,
so a row gives the same bits alone or in any batch.  For f32 the small
kernel writes the normalised rows (its inverse RMS in the order of
``common.cuh``'s ``row_sumsq``) to an (M, D) f32 workspace, and matmul's
f32 launch -- the port's one f32 order, ``ops.f32_k_order`` -- is its
programmatic dependent on them: f32 norm_matmul is bit for bit f32
``matmul`` of its normalised rows, at any D (``ops.norm_matmul_plan``).
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
    if x.device.type == "cpu":
        return norm_matmul_ref(x, g, w, eps=eps)
    return _launch(x, g, w, eps)[0]


def norm_matmul_with_rows(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                          eps: float = 1e-6):
    """(out, rows): :func:`norm_matmul` on CUDA tensors, and the
    normalised rows its first kernel wrote (f32, or 16-bit on the wgmma
    route, ``ops.norm_matmul_plan``), to check the product against
    ``matmul(rows, w)``.  For checks only; no path of the port calls
    it."""
    if x.device.type != "cuda" or ops.norm_matmul_plan(
            x.shape[0], x.shape[1], w.shape[1], x.dtype,
            g.dtype).route == "tensor_core":
        raise ValueError("norm_matmul_with_rows: CUDA tensors of a route "
                         "that writes the rows (f32, or 16-bit above "
                         f"{ops.WG_MIN_ROWS} rows where D % 8 == 0)")
    return _launch(x, g, w, eps)


def _launch(x, g, w, eps):
    global launches
    M, D = x.shape
    D2, N = w.shape
    if D != D2 or tuple(g.shape) != (D,) or x.dtype != w.dtype:
        raise ValueError(
            f"norm_matmul: x {tuple(x.shape)} {x.dtype}, g "
            f"{tuple(g.shape)}, w {tuple(w.shape)} {w.dtype}")
    if not ops.norm_matmul_supported(M, D, N, x.dtype):
        raise ValueError(f"norm_matmul kernel does not take M={M} D={D} "
                         f"N={N} {x.dtype}")
    x = _build.operand(x, "norm_matmul", x.device)
    g = _build.operand(g, "norm_matmul", x.device)
    w = _build.operand(w, "norm_matmul", x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    # between the two kernels: the normalised rows (f32; 16-bit above the
    # wgmma threshold), or the rows' inverse RMS (the 16-bit tiles)
    plan = ops.norm_matmul_plan(M, D, N, x.dtype, g.dtype)
    ws = torch.empty(plan.ws_shape, dtype=plan.ws_dtype, device=x.device)
    _build.launch(
        "repro_norm_matmul", x.device, x.data_ptr(), g.data_ptr(),
        w.data_ptr(), out.data_ptr(), ws.data_ptr(), M, D, N, float(eps),
        _build.dtype_code(x, "norm_matmul"),
        _build.dtype_code(g, "norm_matmul"), _build.stream(x))
    launches += 1
    return out, ws
