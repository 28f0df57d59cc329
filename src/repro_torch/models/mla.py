"""Multi-head Latent Attention (DeepSeek-V3) in IR.

Train/prefill expand the low-rank projections to full per-head k/v and
use the Attention compound op (Dk = d_nope + d_rope, Dv = d_v).  Decode
runs *absorbed* attention over the compressed cache: the per-head
up-projections W_uk / W_uv are folded into the query / output, so the
cache holds only (c_kv: kv_lora) + (k_rope: d_rope) per token and the
score computation is MQA-shaped (Hkv = 1) in latent space — the MLA
memory win, expressed with the same Attention op.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from ..core import ops
from ..core.node import Value
from .builder import ModelBuilder, fanin_init, normal_init, ones_init
from .components import Specs, apply_rope, constrain, merge_heads, rope_tables


def mla_specs(d_model: int, n_heads: int, q_lora: int, kv_lora: int,
              d_nope: int, d_rope: int, d_v: int) -> Specs:
    H = n_heads
    return {
        "wq_a": ((d_model, q_lora), ("embed", None)),
        "q_norm_g": ((q_lora,), (None,)),
        "wq_b": ((q_lora, H * (d_nope + d_rope)), (None, "heads")),
        "wkv_a": ((d_model, kv_lora + d_rope), ("embed", None)),
        "kv_norm_g": ((kv_lora,), (None,)),
        "wk_b": ((kv_lora, H * d_nope), (None, "heads")),
        "wv_b": ((kv_lora, H * d_v), (None, "heads")),
        "wo": ((H * d_v, d_model), ("heads", "embed")),
    }


def mla_inits(prefix: str):
    out = {f"{prefix}{k}": fanin_init()
           for k in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo")}
    out[f"{prefix}q_norm_g"] = ones_init()
    out[f"{prefix}kv_norm_g"] = ones_init()
    return out


def apply_mla(
    b: ModelBuilder,
    x: Value,  # (B, S, D) compute dtype, pre-normed
    w: Dict[str, Value],
    *,
    prefix: str,
    n_heads: int,
    q_lora: int,
    kv_lora: int,
    d_nope: int,
    d_rope: int,
    d_v: int,
    rope: Tuple[Value, Value],       # tables sized for this S (offset applied)
    cache_ckv: Optional[Value] = None,  # (B, Skv, kv_lora)
    cache_kr: Optional[Value] = None,   # (B, Skv, d_rope)
    pos: Optional[Value] = None,
) -> Tuple[Value, Tuple[Value, ...]]:
    B, S, D = x.shape
    H = n_heads
    dq = d_nope + d_rope
    scale = 1.0 / math.sqrt(dq)

    # -- queries ----------------------------------------------------------
    cq = ops.rms_norm(ops.matmul(x, b.cast(w[f"{prefix}wq_a"])),
                      w[f"{prefix}q_norm_g"])
    q = ops.matmul(cq, b.cast(w[f"{prefix}wq_b"]))           # (B,S,H*dq)
    q = ops.transpose(ops.reshape(q, (B, S, H, dq)), (0, 2, 1, 3))
    q_nope = ops.slice_(q, [0, 0, 0, 0], [B, H, S, d_nope])
    q_rope = apply_rope(ops.slice_(q, [0, 0, 0, d_nope], [B, H, S, dq]), *rope)

    # -- compressed kv -----------------------------------------------------
    kv_a = ops.matmul(x, b.cast(w[f"{prefix}wkv_a"]))        # (B,S,l+dr)
    ckv = ops.rms_norm(ops.slice_(kv_a, [0, 0, 0], [B, S, kv_lora]),
                       w[f"{prefix}kv_norm_g"])              # (B,S,l)
    kr = ops.slice_(kv_a, [0, 0, kv_lora], [B, S, kv_lora + d_rope])
    kr = apply_rope(ops.reshape(kr, (B, 1, S, d_rope)), *rope)  # (B,1,S,dr)

    if cache_ckv is None:
        # -- expanded attention (train / prefill) --------------------------
        k_nope = ops.matmul(ckv, b.cast(w[f"{prefix}wk_b"]))  # (B,S,H*dn)
        k_nope = ops.transpose(ops.reshape(k_nope, (B, S, H, d_nope)),
                               (0, 2, 1, 3))
        v = ops.matmul(ckv, b.cast(w[f"{prefix}wv_b"]))       # (B,S,H*dv)
        v = ops.transpose(ops.reshape(v, (B, S, H, d_v)), (0, 2, 1, 3))
        k = ops.concat([k_nope,
                        ops.broadcast_to(kr, (B, H, S, d_rope))], axis=-1)
        q_cat = ops.concat([q_nope, q_rope], axis=-1)
        att = ops.attention(q_cat, k, v, causal=True, scale=scale)
        out = ops.matmul(merge_heads(att), b.cast(w[f"{prefix}wo"]))
        # prefill caches: the *latent* tensors (this is MLA's point)
        extras = (ckv, ops.reshape(kr, (B, S, d_rope)))
        return constrain(out, ("batch", None, None)), extras

    # -- absorbed decode over the latent cache -----------------------------
    Skv = cache_ckv.shape[1]
    zero = ops.constant(0, dtype="i32")
    cache_ckv = ops.dynamic_update_slice(
        cache_ckv, ops.convert(ckv, cache_ckv.dtype), [zero, pos, zero])
    cache_kr = ops.dynamic_update_slice(
        cache_kr, ops.convert(ops.reshape(kr, (B, S, d_rope)), cache_kr.dtype),
        [zero, pos, zero])
    # fold W_uk into q:  q_abs[l] = sum_d q_nope[d] * W_uk[l, h, d]
    wk3 = ops.reshape(b.cast(w[f"{prefix}wk_b"]), (kv_lora, H, d_nope))
    q_abs = ops.einsum("bhsd,lhd->bhsl", q_nope, wk3)        # (B,H,1,l)
    q_full = ops.concat([q_abs, q_rope], axis=-1)            # (B,H,1,l+dr)
    k_full = ops.concat([b.cast(cache_ckv), b.cast(cache_kr)], axis=-1)
    k_full = ops.reshape(k_full, (B, 1, Skv, kv_lora + d_rope))
    v_lat = ops.reshape(b.cast(cache_ckv), (B, 1, Skv, kv_lora))
    att = ops.attention(q_full, k_full, v_lat, causal=True, scale=scale,
                        q_offset=pos)                        # (B,H,1,l)
    # fold W_uv into the output
    wv3 = ops.reshape(b.cast(w[f"{prefix}wv_b"]), (kv_lora, H, d_v))
    o = ops.einsum("bhsl,lhv->bhsv", att, wv3)               # (B,H,1,dv)
    out = ops.matmul(merge_heads(o), b.cast(w[f"{prefix}wo"]))
    return constrain(out, ("batch", None, None)), (cache_ckv, cache_kr)
