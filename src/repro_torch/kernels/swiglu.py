"""Fused SwiGLU MLP: (silu(x @ wg) * (x @ wu)) @ wd with the reference's
roundings (each product accumulated in f32 and rounded to x's dtype, the
down projection accumulated in f32).  Two kernels: gate and up in one
pass that writes the (M, F) hidden activation h to a workspace small
enough to stay in L2, then the down product -- matmul's launch -- as its
programmatic dependent (``ops.swiglu_plan``).  bf16 and f16 run on the
tensor cores: up to ``ops.WG_MIN_ROWS`` rows on ``mma.sync`` tiles, above
them (a dense prefill, a train step's 2048 rows) both launches on the
wgmma mainloop (``csrc/wg_gemm.cuh``: the gate/up's B boxes paired from
wg and wu, h formed in registers), in the same K orders, so with the same
bits.  f32 on the CUDA cores in the port's one f32 order
(``ops.f32_k_order``: chunks of 256 k, each in sub-chains of 32), so f32
swiglu's output is bit for bit f32 ``matmul(h, wd)``.

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
    if x.device.type == "cpu":
        return swiglu_ref(x, w_gate, w_up, w_down)
    return _launch(x, w_gate, w_up, w_down)[0]


def swiglu_with_hidden(x: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, w_down: torch.Tensor):
    """(out, h): :func:`swiglu` on CUDA tensors, and the hidden
    activation its first kernel wrote, to check the down product against
    ``matmul(h, w_down)``.  For checks only; no path of the port calls
    it."""
    if x.device.type != "cuda":
        raise ValueError("swiglu_with_hidden: CUDA tensors only")
    return _launch(x, w_gate, w_up, w_down)


def _launch(x, w_gate, w_up, w_down):
    global launches
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
    # the hidden activation, written by the first kernel, read by the
    # second
    h = torch.empty((M, F), dtype=x.dtype, device=dev)
    out = torch.empty((M, Do), dtype=x.dtype, device=dev)
    _build.launch(
        "repro_swiglu", dev, x.data_ptr(), w_gate.data_ptr(),
        w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), out.data_ptr(),
        M, D, F, Do, _build.dtype_code(x, "swiglu"), _build.stream(x))
    launches += 1
    return out, h
