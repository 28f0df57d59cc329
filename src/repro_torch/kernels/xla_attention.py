"""Memory-efficient (chunked online-softmax) attention in plain PyTorch.

The port of ``repro/kernels/xla_attention.py:chunked_attention``, kept
under the reference's name so a reader finds it: not a kernel, a torch
composition.  The flash algorithm is a loop over KV chunks of ``bk``
keys, so peak memory is O(Sq * bk) instead of O(Sq * Skv).  The emitter
selects it where the reference does (``attn_impl="chunked"``, or
``"auto"`` with Sq > 1 and Skv > 2048 a multiple of the chunk).

Semantics of ``attention_ref``: GQA without repeating heads, causal,
sliding window, a decode ``q_offset`` (read on the device), Dv != Dk;
f32 scores, max, sum and p.V; a row that sees no key gives 0.  With
``kernels`` (the emitter's ``use_pallas``) on CUDA tensors its two
products run on the fixed-order batched kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import batched_matmul as _bmm
from .ref import NEG_INF, attention_mask


class ChunkError(ValueError):
    """A chunk size that the KV length does not divide: these options
    refuse these shapes (the autotuner skips such a candidate)."""


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None, q_offset=None,
                      bk: int = 1024, kernels: bool = False) -> torch.Tensor:
    """With ``kernels`` on CUDA tensors both products of every chunk run
    on the fixed-order batched kernel (:mod:`.batched_matmul`)."""
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
    def product(x, y, scores: bool):
        # x (B, Hkv, rep, Sq, c) against y (B, Hkv, keys, d): q.k^T
        # contracts c with y's d (``scores``), p.V c with its keys
        if not (kernels and q.is_cuda):
            spec = "bgrqd,bgkd->bgrqk" if scores else "bgrqk,bgkd->bgrqd"
            return torch.einsum(spec, x, y)
        G = B * Hkv
        y3 = y.reshape(G, y.shape[2], y.shape[3])
        return _bmm.batched_matmul(
            x.reshape(G, rep * Sq, x.shape[-1]),
            y3.transpose(1, 2) if scores else y3,
            torch.float32).reshape(B, Hkv, rep, Sq, -1)

    for c0 in range(0, Skv, bk):
        kb = k[:, :, c0:c0 + bk].float()
        vb = v[:, :, c0:c0 + bk].float()
        mb = mask[:, c0:c0 + bk]
        s = product(qg, kb, True) * scale
        s = torch.where(mb, s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        dead = m_new <= NEG_INF / 2
        p = torch.where(mb, torch.exp(
            s - torch.where(dead, zero, m_new)[..., None]), zero)
        alpha = torch.exp(torch.where(dead, zero, m - m_new))
        l = alpha * l + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + product(p, vb, False)
        m = m_new
    out = acc / torch.where(l == 0, torch.ones((), device=dev), l)[..., None]
    return out.to(q.dtype).reshape(B, Hq, Sq, Dv)
