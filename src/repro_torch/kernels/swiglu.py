"""Fused SwiGLU MLP: (silu(x @ wg) * (x @ wu)) @ wd with the reference's
roundings (each product accumulated in f32 and rounded to x's dtype, the
down projection accumulated in f32); the (M, F) hidden activation never
reaches device memory.

Replaces ``repro/kernels/swiglu.py:swiglu``; the CUDA source is
``csrc/swiglu.cu``.  CPU tensors take the plain version
(:func:`ref.swiglu_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import _build, ops
from .ref import swiglu_ref

launches = 0
rejected = 0


def supported(x: torch.Tensor, wg: torch.Tensor, wd: torch.Tensor) -> bool:
    global rejected
    ok = ops.swiglu_supported(x.shape[0], x.shape[1], wg.shape[1],
                              wd.shape[1], x.dtype)
    if not ok and x.is_cuda:
        rejected += 1
    return ok


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    global launches
    if x.device.type == "cpu":
        return swiglu_ref(x, w_gate, w_up, w_down)
    M, D = x.shape
    F = w_gate.shape[1]
    Do = w_down.shape[1]
    if tuple(w_gate.shape) != (D, F) or tuple(w_up.shape) != (D, F) or \
            w_down.shape[0] != F or \
            not x.dtype == w_gate.dtype == w_up.dtype == w_down.dtype:
        raise ValueError(
            f"swiglu: x {tuple(x.shape)} {x.dtype}, wg "
            f"{tuple(w_gate.shape)}, wu {tuple(w_up.shape)}, wd "
            f"{tuple(w_down.shape)}")
    if not ops.swiglu_supported(M, D, F, Do, x.dtype):
        raise ValueError(f"swiglu kernel does not take M={M} D={D} F={F} "
                         f"Do={Do} {x.dtype}")
    dev = x.device
    x = _build.operand(x, "swiglu", dev)
    w_gate = _build.operand(w_gate, "swiglu", dev)
    w_up = _build.operand(w_up, "swiglu", dev)
    w_down = _build.operand(w_down, "swiglu", dev)
    # per-slice f32 partials of the down projection, summed in slice
    # order by the kernel's second pass (no atomics: deterministic)
    partial = torch.empty((ops.swiglu_slices(F, x.dtype), M, Do),
                          dtype=torch.float32, device=dev)
    out = torch.empty((M, Do), dtype=x.dtype, device=dev)
    rc = _build.lib().repro_swiglu(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        partial.data_ptr(), out.data_ptr(), M, D, F, Do,
        _build.dtype_code(x, "swiglu"), _build.stream(x))
    _build.check(rc, "swiglu")
    launches += 1
    return out
