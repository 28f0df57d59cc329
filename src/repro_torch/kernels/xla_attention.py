"""Memory-efficient (chunked online-softmax) attention in plain PyTorch.

The port of ``repro/kernels/xla_attention.py:chunked_attention``, kept
under the reference's name so a reader finds it: not a kernel, a torch
composition.  The flash algorithm is a loop over KV chunks of ``bk``
keys, so peak memory is O(Sq * bk) instead of O(Sq * Skv).  The emitter
selects it where the reference does (``attn_impl="chunked"``, or
``"auto"`` with Sq > 1 and Skv > 2048 a multiple of the chunk).

Semantics of ``attention_ref``: GQA without repeating heads, causal,
sliding window, a decode ``q_offset`` (read on the device), Dv != Dk;
f32 scores, max, sum and p.V; a row that sees no key gives 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import NEG_INF, attention_mask


class ChunkError(ValueError):
    """A chunk size that the KV length does not divide: these options
    refuse these shapes (the autotuner skips such a candidate)."""


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None, q_offset=None,
                      bk: int = 1024) -> torch.Tensor:
    B, Hq, Sq, Dk = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if scale is None:
        scale = 1.0 / (Dk ** 0.5)
    rep = Hq // Hkv
    bk = min(bk, Skv)
    if Skv % bk:
        raise ChunkError(f"Skv={Skv} not divisible by chunk {bk}")
    dev = q.device
    # grouped query layout (B, Hkv, rep, Sq, Dk): contraction against
    # un-repeated kv
    qg = q.float().reshape(B, Hkv, rep, Sq, Dk)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    zero = torch.zeros((), device=dev)
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, rep, Sq), device=dev)
    acc = torch.zeros((B, Hkv, rep, Sq, Dv), device=dev)
    for c0 in range(0, Skv, bk):
        kb = k[:, :, c0:c0 + bk].float()
        vb = v[:, :, c0:c0 + bk].float()
        mb = mask[:, c0:c0 + bk]
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, kb) * scale
        s = torch.where(mb, s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        dead = m_new <= NEG_INF / 2
        p = torch.where(mb, torch.exp(
            s - torch.where(dead, zero, m_new)[..., None]), zero)
        alpha = torch.exp(torch.where(dead, zero, m - m_new))
        l = alpha * l + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bgkd->bgrqd", p,
                                                    vb)
        m = m_new
    out = acc / torch.where(l == 0, torch.ones((), device=dev), l)[..., None]
    return out.to(q.dtype).reshape(B, Hq, Sq, Dv)
