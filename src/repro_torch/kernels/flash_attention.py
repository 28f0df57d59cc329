"""Flash attention: BHSD online-softmax attention with GQA, a causal
and/or sliding-window mask on absolute positions, a decode offset read
on the device, Dv != Dk, and f32 scores, softmax and p.V; out in q's
dtype, a row that sees no key exactly 0.

Replaces ``repro/kernels/flash_attention.py:_flash_kernel`` (the Pallas
TPU kernel behind ``repro/kernels/ops.py:flash_attention``); the CUDA
source is ``csrc/flash_attention.cu``.  CPU tensors take the plain
version (:func:`ref.flash_attention_ref`); CUDA tensors launch the
kernel or raise.

What bounds it on the H100: device-memory bytes at the serving shapes,
the tensor cores at long prefills.  Decode (Sq 1) does about one flop
per byte of K and V: at deepseek-7b's width, 4 slots at position 255
read 16.8 MB of cache, ~5 us at 3.35 TB/s.  A 4,224-token prefill of
mixtral's 48 heads under its 4,096-token window does ~220 GFLOP of
scores and p.V, 0.22 ms at the bf16 tensor rate.  bf16 and f16 follow
one order (``ops.flash_16_order``): a row's keys in chunks of
``ops.FLASH_CHUNK`` keys by absolute key index, each chunk's tiles in
the unchunked order, the chunks' states merged in ascending order -- so
decode at p gives row p of the causal prefill bit for bit, and a row
that sees one chunk gets the unchunked bits.  Two routes take it
(``ops.flash_plan`` chooses): from ``ops.FLASH_WG_MIN_SQ`` query rows a
wgmma prefill (a TMA producer warpgroup and consumer warpgroups of 64
rows, scores and p.V on ``wgmma``, p from the score registers as two
16-bit halves, the next tile's scores in flight during this one's
softmax, the chunks merged inside the block); below it mma.sync (4
warps of 16 query rows, a ``cp.async`` ring of 64-key K/V tiles; at
decode the query heads that share a kv head fill one fragment, so K and
V are read once for all of them), a block per chunk of keys, whose
states a combine launch merges -- so a one-slot decode over 4,096 keys
runs 8 blocks a kv head.  The loop is bounded by the causal and window
limits, so decode at position p reads only the first p + 1 rows of the
cache.  f32 runs on the CUDA cores in f32
FMAs (no TF32): a warp owns 1, 2 or 4 query rows (at decode the query
heads of a kv head), its lanes hold a 64-key tile's scores in registers
(two keys a lane) and then the output columns (four a lane) for p.V, p
passed by shuffles; the TMA unit copies each tile in four groups (K's
and V's two 32-key halves) into a ring of up to 4 tiles, so a decode
block computes on its first keys while the rest land.
``ops.flash_f32_order`` states its order.  The offset is a device
pointer: in the fused decode chunk the position is a carry on the card,
and reading it on the host would stall every step.
``ops.flash_plan`` mirrors the launch; ``launches`` counts calls (a
split call launches the chunk kernel and, after it, the combine).
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
    plan = ops.flash_plan(tuple(q.shape), tuple(k.shape), tuple(v.shape),
                          q.dtype)
    if scale is None:
        scale = 1.0 / (Dk ** 0.5)
    # RotaryQKV hands over permuted views: the kernel reads dense BHSD
    q = _build.operand(q, "flash_attention", q.device)
    k = _build.operand(k, "flash_attention", q.device)
    v = _build.operand(v, "flash_attention", q.device)
    off = _offset(q_offset, q.device)
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    # the chunk states of a split mma.sync launch, from the caching
    # allocator (inside a CUDA graph, from its pool)
    ws = (torch.empty(plan.workspace, dtype=torch.uint8, device=q.device)
          if plan.workspace else None)
    win = 0 if window is None else min(int(window), _MAX_WINDOW)
    _build.launch(
        "repro_flash_attention", q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(),
        off.data_ptr() if off is not None else None,
        ws.data_ptr() if ws is not None else None, plan.workspace, B, Hq,
        Hkv, Sq, Skv, Dk, Dv, float(scale), int(bool(causal)),
        int(window is not None), win,
        _build.dtype_code(q, "flash_attention"),
        ops.FLASH_ROUTES.get(plan.route, 0), _build.stream(q))
    launches += 1
    return out
