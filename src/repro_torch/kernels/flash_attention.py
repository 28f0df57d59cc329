"""Flash attention: BHSD online-softmax attention with GQA, a causal
and/or sliding-window mask on absolute positions, a decode offset read
on the device, Dv != Dk, and f32 scores, softmax and p.V; out in q's
dtype, a row that sees no key exactly 0.

Replaces ``repro/kernels/flash_attention.py:_flash_kernel`` (the Pallas
TPU kernel behind ``repro/kernels/ops.py:flash_attention``); the CUDA
source is ``csrc/flash_attention.cu``.  CPU tensors take the plain
version (:func:`ref.flash_attention_ref`); CUDA tensors launch the
kernel or raise.

What bounds it on the H100: device-memory bytes at every serving shape.
Decode (Sq 1) does about one flop per byte of K and V: at deepseek-7b's
width, 4 slots at position 255 read 16.8 MB of cache, ~5 us at 3.35
TB/s.  A 128-token prefill of 4 prompts moves 16.8 MB of q, k, v and
out for 0.54 GFLOP under the causal mask (0.55 us at the bf16 tensor
rate): the bytes again.  For bf16 and f16 the design keeps the cache
streaming and the arithmetic off the critical path: a ring of up to 4
64-key K/V tiles in flight (``cp.async``), scores and p.V on the tensor
cores (``mma.sync``) with the scores in registers and p kept at f32
precision as two 16-bit halves, 16 query rows per warp (64 per block in
prefill; at decode the query heads that share a kv head fill one
fragment, so K and V are read once for all of them).  The loop is
bounded by the causal and window limits, so decode at position p reads
only the first p + 1 rows of the cache.  A row's reduction order
depends only on Dk, Dv, Skv and the mask: decode at p gives row p of
the causal prefill bit for bit.  f32 stays on the CUDA cores.  The
offset is a device pointer: in the fused decode chunk the position is a
carry on the card, and reading it on the host would stall every step.
``ops.flash_plan`` mirrors the launch.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import _build, ops
from .ref import flash_attention_ref

launches = 0
rejected = 0

_MAX_WINDOW = 1 << 30   # wider windows hide nothing a 32-bit position sees


def supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The kernel's shape predicate; a refusal of a CUDA operand is
    counted in :data:`rejected`."""
    global rejected
    ok = (q.dtype == k.dtype == v.dtype and ops.attention_supported(
        tuple(q.shape), tuple(k.shape), tuple(v.shape), q.dtype))
    if not ok and q.is_cuda:
        rejected += 1
    return ok


def _offset(q_offset: Union[None, int, torch.Tensor],
            device: torch.device) -> Optional[torch.Tensor]:
    """The decode offset as a 1-element int32 tensor on ``device`` (or
    None for 0), without a host read of a device value.  An int becomes
    a fill kernel with the value as its argument, not a copy from host
    memory, so the call can be captured in a CUDA graph."""
    if q_offset is None:
        return None
    if isinstance(q_offset, torch.Tensor):
        if q_offset.numel() != 1:
            raise ValueError(f"flash_attention: q_offset must hold one "
                             f"value, got shape {tuple(q_offset.shape)}")
        return q_offset.reshape(1).to(device=device,
                                      dtype=torch.int32).contiguous()
    return torch.full((1,), int(q_offset), dtype=torch.int32, device=device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_offset: Union[None, int, torch.Tensor] = None
                    ) -> torch.Tensor:
    global launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset)
    if not (q.dtype == k.dtype == v.dtype and ops.attention_supported(
            tuple(q.shape), tuple(k.shape), tuple(v.shape), q.dtype)):
        raise ValueError(
            f"flash_attention kernel does not take q {tuple(q.shape)} "
            f"{q.dtype}, k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
            f"{v.dtype}")
    B, Hq, Sq, Dk = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if scale is None:
        scale = 1.0 / (Dk ** 0.5)
    # RotaryQKV hands over permuted views: the kernel reads dense BHSD
    q = _build.operand(q, "flash_attention", q.device)
    k = _build.operand(k, "flash_attention", q.device)
    v = _build.operand(v, "flash_attention", q.device)
    off = _offset(q_offset, q.device)
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    win = 0 if window is None else min(int(window), _MAX_WINDOW)
    rc = _build.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        off.data_ptr() if off is not None else None, B, Hq, Hkv, Sq, Skv,
        Dk, Dv, float(scale), int(bool(causal)), int(window is not None),
        win, _build.dtype_code(q, "flash_attention"), _build.stream(q))
    _build.check(rc, "flash_attention")
    launches += 1
    return out
