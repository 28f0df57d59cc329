"""Reusable IR-building blocks: norms, rotary embeddings, attention,
MLPs, KV caches.  Every function builds nGraph IR (no jax imports).

Conventions:
  * activations flow in the builder's compute dtype (bf16 by default);
  * norm math is f32 inside the compound ops;
  * attention tensors use BHSD layout with logical sharding constraints
    ("batch", "heads") the transformer maps onto mesh axes;
  * ``weights`` dicts come from ``ModelBuilder.scan_blocks`` (storage
    dtype — cast where compute dtype is wanted).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core import ops
from ..core.node import Value
from .builder import ModelBuilder, ones_init, zeros_init, fanin_init

Specs = Dict[str, Tuple[Tuple[int, ...], Tuple[Optional[str], ...]]]

BATCH_SPEC = ("batch", None, None)          # (B, S, D)
BHSD_SPEC = ("batch", "heads", None, None)  # (B, H, S, D)


def constrain(x: Value, spec) -> Value:
    return ops.sharding_constraint(x, spec)


# -- norms ---------------------------------------------------------------------
def norm_specs(d: int, kind: str = "rms") -> Specs:
    if kind == "rms":
        return {"g": ((d,), (None,))}
    return {"g": ((d,), (None,)), "b": ((d,), (None,))}


def apply_norm(x: Value, w: Dict[str, Value], prefix: str, kind: str = "rms",
               eps: float = 1e-6) -> Value:
    if kind == "rms":
        return ops.rms_norm(x, w[f"{prefix}g"], eps=eps)
    return ops.layer_norm(x, w[f"{prefix}g"], w[f"{prefix}b"], eps=eps)


def norm_inits(prefix: str, kind: str = "rms"):
    out = {f"{prefix}g": ones_init()}
    if kind == "layernorm":
        out[f"{prefix}b"] = zeros_init()
    return out


# -- rotary ---------------------------------------------------------------------
def _rope_freq(d_head: int, base: float) -> np.ndarray:
    return (base ** (-np.arange(d_head // 2, dtype=np.float64) * 2.0
                     / d_head)).astype(np.float32)


def _rope_host_tables(seq: int, d_head: int,
                      base: float) -> Tuple[np.ndarray, np.ndarray]:
    """Host-evaluated (seq, d_head//2) f32 cos/sin tables.

    Static-position tables are computed with numpy rather than left for
    XLA to constant-fold: the folder and the runtime ``cos`` kernel round
    differently (1 ulp in f32), so two compiled programs that must agree
    bitwise on the same positions — the dense prefill graph and the
    chunked paged-prefill graph — would otherwise write K rows that
    disagree in the last bf16 bit and eventually flip a greedy argmax."""
    ang = (np.arange(seq, dtype=np.float32)[:, None]
           * _rope_freq(d_head, base)[None, :])
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rope_tables(b: ModelBuilder, seq: int, d_head: int, base: float = 10000.0,
                offset: Optional[Value] = None) -> Tuple[Value, Value]:
    """cos/sin tables (seq, d_head//2) in f32.  ``offset`` (scalar i32)
    shifts positions for decode.  Static tables (no offset) are baked as
    host-computed literals (see :func:`_rope_host_tables`)."""
    half = d_head // 2
    if offset is None:
        cos, sin = _rope_host_tables(seq, d_head, base)
        return ops.constant(cos), ops.constant(sin)
    freq = ops.constant(_rope_freq(d_head, base))  # (half,)
    pos = ops.iota((seq,), 0, "i32") + ops.broadcast_to(offset, (seq,))
    posf = ops.convert(pos, "f32")
    ang = ops.reshape(posf, (seq, 1)) * ops.reshape(freq, (1, half))
    return ops.cos(ang), ops.sin(ang)


def rope_tables_sliced(b: ModelBuilder, max_len: int, d_head: int, chunk: int,
                       base: float, offset: Value) -> Tuple[Value, Value]:
    """``chunk`` rows of the full host-computed table starting at the
    traced row ``offset`` — bitwise identical to the corresponding rows
    of a static :func:`rope_tables` by construction, which is what makes
    chunked paged prefill token-exact against dense prefill."""
    half = d_head // 2
    cos, sin = _rope_host_tables(max_len, d_head, base)
    zero = ops.constant(np.int32(0))
    return (ops.dynamic_slice(ops.constant(cos), [offset, zero],
                              [chunk, half]),
            ops.dynamic_slice(ops.constant(sin), [offset, zero],
                              [chunk, half]))


def rope_tables_rows(b: ModelBuilder, pos: Value, d_head: int,
                     base: float = 10000.0) -> Tuple[Value, Value]:
    """Per-row cos/sin tables from a *vector* of absolute positions:
    ``pos`` (B,) i32 -> (B, d_head//2) f32 tables.  The continuous-batching
    serve graph uses this so each batch row can sit at its own position."""
    half = d_head // 2
    B = pos.shape[0]
    freq = ops.constant(
        (base ** (-np.arange(half, dtype=np.float64) * 2.0 / d_head))
        .astype(np.float32))  # (half,)
    posf = ops.convert(pos, "f32")
    ang = ops.reshape(posf, (B, 1)) * ops.reshape(freq, (1, half))
    return ops.cos(ang), ops.sin(ang)


def apply_rope_rows(x: Value, cos: Value, sin: Value) -> Value:
    """x: (B, H, 1, D); cos/sin: (B, D//2) per-row tables (see
    :func:`rope_tables_rows`).  Same rotate-half math as apply_rope."""
    B, H, S, D = x.shape
    half = D // 2
    x1 = ops.slice_(x, [0, 0, 0, 0], [B, H, S, half])
    x2 = ops.slice_(x, [0, 0, 0, half], [B, H, S, D])
    c = ops.reshape(cos, (B, 1, 1, half))
    s = ops.reshape(sin, (B, 1, 1, half))
    c = ops.convert(ops.broadcast_to(c, (B, H, S, half)), x.dtype)
    s = ops.convert(ops.broadcast_to(s, (B, H, S, half)), x.dtype)
    return ops.concat([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)


def apply_rope(x: Value, cos: Value, sin: Value) -> Value:
    """x: (B, H, S, D); cos/sin: (S, D//2).  Rotate-half convention."""
    B, H, S, D = x.shape
    half = D // 2
    x1 = ops.slice_(x, [0, 0, 0, 0], [B, H, S, half])
    x2 = ops.slice_(x, [0, 0, 0, half], [B, H, S, D])
    c = ops.reshape(cos, (1, 1, S, half))
    s = ops.reshape(sin, (1, 1, S, half))
    c = ops.convert(ops.broadcast_to(c, (B, H, S, half)), x.dtype)
    s = ops.convert(ops.broadcast_to(s, (B, H, S, half)), x.dtype)
    return ops.concat([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)


def split_heads(x: Value, n_heads: int) -> Value:
    """(B, S, H*D) -> (B, H, S, D)."""
    B, S, HD = x.shape
    d = HD // n_heads
    return ops.transpose(ops.reshape(x, (B, S, n_heads, d)), (0, 2, 1, 3))


def merge_heads(x: Value) -> Value:
    """(B, H, S, D) -> (B, S, H*D)."""
    B, H, S, D = x.shape
    return ops.reshape(ops.transpose(x, (0, 2, 1, 3)), (B, S, H * D))


# -- attention --------------------------------------------------------------------
def attn_specs(d_model: int, n_heads: int, n_kv: int, d_head: int,
               qkv_bias: bool = False, kv_src_dim: Optional[int] = None) -> Specs:
    src = kv_src_dim if kv_src_dim is not None else d_model
    specs: Specs = {
        "wq": ((d_model, n_heads * d_head), ("embed", "heads")),
        "wk": ((src, n_kv * d_head), ("embed", "kv_heads")),
        "wv": ((src, n_kv * d_head), ("embed", "kv_heads")),
        "wo": ((n_heads * d_head, d_model), ("heads", "embed")),
    }
    if qkv_bias:
        specs.update({
            "bq": ((n_heads * d_head,), ("heads",)),
            "bk": ((n_kv * d_head,), ("kv_heads",)),
            "bv": ((n_kv * d_head,), ("kv_heads",)),
        })
    return specs


def attn_inits(prefix: str, qkv_bias: bool = False):
    out = {f"{prefix}{k}": fanin_init() for k in ("wq", "wk", "wv", "wo")}
    if qkv_bias:
        out.update({f"{prefix}b{k}": zeros_init() for k in ("q", "k", "v")})
    return out


def project_qkv(b: ModelBuilder, x: Value, w: Dict[str, Value], prefix: str,
                n_heads: int, n_kv: int, qkv_bias: bool = False,
                kv_x: Optional[Value] = None):
    """Returns (q, k, v) in BHSD layout.  ``kv_x`` for cross attention."""
    kvx = kv_x if kv_x is not None else x
    q = ops.matmul(x, b.cast(w[f"{prefix}wq"]))
    k = ops.matmul(kvx, b.cast(w[f"{prefix}wk"]))
    v = ops.matmul(kvx, b.cast(w[f"{prefix}wv"]))
    if qkv_bias:
        q = q + b.cast(w[f"{prefix}bq"])
        k = k + b.cast(w[f"{prefix}bk"])
        v = v + b.cast(w[f"{prefix}bv"])
    q = constrain(split_heads(q, n_heads), BHSD_SPEC)
    k = constrain(split_heads(k, n_kv), BHSD_SPEC)
    v = constrain(split_heads(v, n_kv), BHSD_SPEC)
    return q, k, v


def self_attention(
    b: ModelBuilder,
    x: Value,
    w: Dict[str, Value],
    *,
    prefix: str = "attn_",
    n_heads: int,
    n_kv: int,
    d_head: int,
    rope: Optional[Tuple[Value, Value]] = None,
    causal: bool = True,
    window: Optional[int] = None,
    qkv_bias: bool = False,
    # decode-with-cache:
    cache_k: Optional[Value] = None,   # (B, Hkv, Skv, D)
    cache_v: Optional[Value] = None,
    pos: Optional[Value] = None,       # i32 absolute position: scalar, or a
                                       # (B,) vector for per-row positions
                                       # (continuous-batching serve graphs)
    ring: bool = False,                # ring (rolling) cache for SWA decode
    return_kv: bool = False,           # prefill: emit (k, v) for the cache
) -> Tuple[Value, Tuple[Value, ...]]:
    """Returns (out (B,S,Dm), extra) where extra = (new_k, new_v) when a
    cache was threaded through (or when ``return_kv``)."""
    pos_rows = pos is not None and pos.rank == 1
    q, k, v = project_qkv(b, x, w, prefix, n_heads, n_kv, qkv_bias)
    if rope is not None:
        if pos_rows:  # rope contains per-row (B, D//2) tables
            q = apply_rope_rows(q, *rope)
            k = apply_rope_rows(k, *rope)
        else:
            q = apply_rope(q, *rope)
            k = apply_rope(k, *rope)
    extras: Tuple[Value, ...] = (k, v) if return_kv else ()
    if pos_rows:
        if cache_k is None or ring:
            raise ValueError("vector pos requires a (non-ring) KV cache")
        cache_k, cache_v, att = _rowpos_cached_attention(
            b, q, k, v, cache_k, cache_v, pos, n_heads=n_heads, n_kv=n_kv,
            d_head=d_head, window=window)
        extras = (cache_k, cache_v)
    elif cache_k is not None:
        Skv = cache_k.shape[2]
        zero = ops.constant(0, dtype="i32")
        if ring:
            win = ops.constant(Skv, dtype="i32")
            slot = pos - (pos / win) * win  # pos % Skv (int divide == floor)
        else:
            slot = pos
        cache_k = ops.dynamic_update_slice(cache_k, ops.convert(k, cache_k.dtype),
                                           [zero, zero, slot, zero])
        cache_v = ops.dynamic_update_slice(cache_v, ops.convert(v, cache_v.dtype),
                                           [zero, zero, slot, zero])
        extras = (cache_k, cache_v)
        if ring:
            # steady-state ring: every slot is within the window; RoPE was
            # applied at write time so scores depend only on relative
            # positions -> plain (non-causal) attention over the ring.
            att = ops.attention(q, b.cast(cache_k), b.cast(cache_v),
                                causal=False, scale=1.0 / math.sqrt(d_head))
        else:
            att = ops.attention(q, b.cast(cache_k), b.cast(cache_v),
                                causal=causal, window=window,
                                scale=1.0 / math.sqrt(d_head), q_offset=pos)
    else:
        att = ops.attention(q, k, v, causal=causal, window=window,
                            scale=1.0 / math.sqrt(d_head))
    out = ops.matmul(merge_heads(att), b.cast(w[f"{prefix}wo"]))
    return constrain(out, BATCH_SPEC), extras


def _rowpos_attend(q: Value, cache_k: Value, cache_v: Value, kpos: Value,
                   posb: Value, *, n_heads: int, n_kv: int, d_head: int,
                   window: Optional[int] = None) -> Value:
    """Masked single-token attention over a (B, Hkv, Skv, D) key/value
    view with per-row positions: attends keys with ``kpos <= pos[b]``.
    Numerics mirror ``decompose_attention``: f32 scores, -1e30 mask fill,
    f32 softmax.  Shared by the row-position (continuous) and paged cache
    paths — both must emit bit-identical math for token parity."""
    B, Hkv, Skv, D = cache_k.shape
    Dv = cache_v.shape[-1]
    rep = n_heads // n_kv
    q5 = ops.reshape(ops.convert(q, "f32"), (B, n_kv, rep, 1, D))
    kf = ops.convert(cache_k, "f32")
    vf = ops.convert(cache_v, "f32")
    scores = ops.multiply(
        ops.einsum("bhrqd,bhkd->bhrqk", q5, kf),
        ops.broadcast_to(ops.constant(1.0 / math.sqrt(d_head), dtype="f32"),
                         (B, n_kv, rep, 1, Skv)))
    mask = ops.less_equal(kpos, posb)
    if window is not None:
        w = ops.constant(window, dtype="i32")
        mask = ops.logical_and(
            mask, ops.greater(kpos, posb - ops.broadcast_to(w, (B, Skv))))
    maskb = ops.broadcast_to(ops.reshape(mask, (B, 1, 1, 1, Skv)),
                             scores.shape)
    neg = ops.broadcast_to(ops.constant(-1e30, dtype="f32"), scores.shape)
    p = ops.softmax(ops.select(maskb, scores, neg), axis=-1)
    att = ops.einsum("bhrqk,bhkd->bhrqd", p, vf)
    return ops.convert(ops.reshape(att, (B, n_heads, 1, Dv)), q.dtype)


def _rowpos_cached_attention(
    b: ModelBuilder, q: Value, k: Value, v: Value,
    cache_k: Value, cache_v: Value, pos: Value, *,
    n_heads: int, n_kv: int, d_head: int, window: Optional[int] = None,
) -> Tuple[Value, Value, Value]:
    """Single-token cached attention with a per-row position vector.

    q/k/v: (B, H, 1, D); cache_k/v: (B, Hkv, Skv, D); pos: (B,) i32.
    Each row writes its k/v at slot ``pos[b]`` (a one-hot blend —
    DynamicUpdateSlice only takes scalar starts) and attends keys with
    ``kpos <= pos[b]``, so rows at different decode depths share one
    batched step.  Returns (new_k, new_v, att (B,H,1,Dv)).
    """
    B, Hkv, Skv, D = cache_k.shape
    kpos = ops.iota((B, Skv), 1, "i32")
    posb = ops.broadcast_to(ops.reshape(pos, (B, 1)), (B, Skv))
    write = ops.reshape(ops.equal(kpos, posb), (B, 1, Skv, 1))

    def blend(cache, new):
        return ops.select(ops.broadcast_to(write, cache.shape),
                          ops.broadcast_to(ops.convert(new, cache.dtype),
                                           cache.shape),
                          cache)

    cache_k = blend(cache_k, k)
    cache_v = blend(cache_v, v)
    att = _rowpos_attend(q, cache_k, cache_v, kpos, posb, n_heads=n_heads,
                         n_kv=n_kv, d_head=d_head, window=window)
    return cache_k, cache_v, att


# -- paged KV cache (serve_paged) ----------------------------------------------
def paged_gather(pool: Value, page_tbl: Value) -> Value:
    """Gather a slot-major KV view out of a page pool.

    pool: (P, Hkv, ps, D) physical pages; page_tbl: (B, MP) i32 physical
    page id per (row, logical page).  Returns (B, Hkv, MP*ps, D) where
    index ``j`` along the seq axis is logical token position ``j`` — the
    take-along-page-axis + reshape that makes paged attention identical
    to attending a dense per-row cache (garbage beyond ``pos`` is masked
    by the caller exactly like the dense path's unwritten rows).
    """
    P, Hkv, ps, D = pool.shape
    B, MP = page_tbl.shape
    g = ops.gather(pool, page_tbl, axis=0)           # (B, MP, Hkv, ps, D)
    g = ops.transpose(g, (0, 2, 1, 3, 4))            # (B, Hkv, MP, ps, D)
    return ops.reshape(g, (B, Hkv, MP * ps, D))


def paged_write(pool: Value, new: Value, page_tbl: Value, pos: Value,
                page_size: int) -> Value:
    """Blend each row's new (B, Hkv, 1, D) k/v into its page slot.

    Row ``b`` writes at physical page ``page_tbl[b, pos[b]//ps]``, offset
    ``pos[b] % ps`` (a one-hot blend over the pool — pages are exclusive
    to one row, so concurrent rows never collide; rows whose logical page
    index overruns the table are clamped onto their last page-table entry,
    which the engine points at the shared trash page for retired rows).
    The written value is ``convert(new, pool.dtype)`` exactly — the same
    value the dense one-hot blend writes, which is what keeps paged and
    continuous decoding token-for-token identical.
    """
    P, Hkv, ps, D = pool.shape
    B, MP = page_tbl.shape
    psc = ops.constant(page_size, dtype="i32")
    lp = pos / psc                       # logical page (int divide = floor)
    off = pos - lp * psc                 # offset within the page
    lp = ops.minimum(lp, ops.constant(MP - 1, dtype="i32"))
    pid = ops.reshape(ops.take_along_last(page_tbl, ops.reshape(lp, (B, 1))),
                      (B,))
    page_oh = ops.one_hot(pid, P, dtype=pool.dtype)      # (B, P)
    off_oh = ops.one_hot(off, ps, dtype=pool.dtype)      # (B, ps)
    wmask = ops.einsum("bp,bs->bps", page_oh, off_oh)    # (B, P, ps)
    newr = ops.reshape(ops.convert(new, pool.dtype), (B, Hkv, D))
    upd = ops.einsum("bps,bhd->phsd", wmask, newr)       # (P, Hkv, ps, D)
    hit = ops.reshape(ops.reduce_sum(wmask, axes=[0]), (P, 1, ps, 1))
    cond = ops.greater(ops.broadcast_to(hit, pool.shape),
                       ops.constant(0.0, dtype=pool.dtype))
    return ops.select(cond, upd, pool)


def paged_self_attention(
    b: ModelBuilder, x: Value, w: Dict[str, Value], *,
    prefix: str, n_heads: int, n_kv: int, d_head: int,
    rope: Tuple[Value, Value], pool_k: Value, pool_v: Value,
    page_tbl: Value, pos: Value, page_size: int,
    window: Optional[int] = None, qkv_bias: bool = False,
) -> Tuple[Value, Tuple[Value, Value]]:
    """Single-token self attention through a paged KV pool.

    pool_k/pool_v: (P, Hkv, ps, D) page pools; page_tbl: (B, MP) i32;
    pos: (B,) i32 per-row positions (``rope`` must be the per-row tables
    from :func:`rope_tables_rows`).  Writes each row's k/v into its page,
    gathers the slot-major view back, and attends with the same masked
    per-row math as the dense continuous path (token parity by
    construction).  Returns (out (B,1,Dm), (new_pool_k, new_pool_v)).
    """
    q, k, v = project_qkv(b, x, w, prefix, n_heads, n_kv, qkv_bias)
    q = apply_rope_rows(q, *rope)
    k = apply_rope_rows(k, *rope)
    pool_k = paged_write(pool_k, k, page_tbl, pos, page_size)
    pool_v = paged_write(pool_v, v, page_tbl, pos, page_size)
    gk = paged_gather(pool_k, page_tbl)
    gv = paged_gather(pool_v, page_tbl)
    B, Skv = pos.shape[0], gk.shape[2]
    kpos = ops.iota((B, Skv), 1, "i32")
    posb = ops.broadcast_to(ops.reshape(pos, (B, 1)), (B, Skv))
    att = _rowpos_attend(q, gk, gv, kpos, posb, n_heads=n_heads, n_kv=n_kv,
                         d_head=d_head, window=window)
    out = ops.matmul(merge_heads(att), b.cast(w[f"{prefix}wo"]))
    return constrain(out, BATCH_SPEC), (pool_k, pool_v)


def _chunkpos_attend(q: Value, cache_k: Value, cache_v: Value, kpos: Value,
                     qpos: Value, *, n_heads: int, n_kv: int, d_head: int,
                     window: Optional[int] = None) -> Value:
    """Masked multi-token attention over a (B, Hkv, Skv, D) key/value
    view: query ``c`` (at absolute position ``qpos[c]``) attends keys
    with ``kpos <= qpos[c]`` — the chunked-prefill generalization of
    :func:`_rowpos_attend` from one query per row to ``C`` queries of one
    row.  Numerics mirror the backend's ``reference_attention`` (what the
    dense prefill graph's fused ``ops.attention`` runs): f32 scores,
    -1e30 mask fill, f32 softmax, and — crucially — the probabilities
    cast back to the cache dtype before the p·V contraction.  Masked
    entries contribute an exact 0 to every reduction, so the padded pool
    axis is a no-op and chunked prefill stays bitwise identical to the
    dense prefill path (the parity the serving gates assert)."""
    B, Hkv, Skv, D = cache_k.shape
    Cq = q.shape[2]
    Dv = cache_v.shape[-1]
    rep = n_heads // n_kv
    q5 = ops.reshape(ops.convert(q, "f32"), (B, n_kv, rep, Cq, D))
    kf = ops.convert(cache_k, "f32")
    scores = ops.multiply(
        ops.einsum("bhrqd,bhkd->bhrqk", q5, kf),
        ops.broadcast_to(ops.constant(1.0 / math.sqrt(d_head), dtype="f32"),
                         (B, n_kv, rep, Cq, Skv)))
    kpos3 = ops.broadcast_to(ops.reshape(kpos, (B, 1, Skv)), (B, Cq, Skv))
    qpos3 = ops.broadcast_to(ops.reshape(qpos, (1, Cq, 1)), (B, Cq, Skv))
    mask = ops.less_equal(kpos3, qpos3)
    if window is not None:
        w = ops.constant(window, dtype="i32")
        mask = ops.logical_and(
            mask, ops.greater(kpos3,
                              qpos3 - ops.broadcast_to(w, (B, Cq, Skv))))
    maskb = ops.broadcast_to(ops.reshape(mask, (B, 1, 1, Cq, Skv)),
                             scores.shape)
    neg = ops.broadcast_to(ops.constant(-1e30, dtype="f32"), scores.shape)
    p = ops.softmax(ops.select(maskb, scores, neg), axis=-1)
    att = ops.einsum("bhrqk,bhkd->bhrqd", ops.convert(p, cache_v.dtype),
                     cache_v)
    return ops.convert(ops.reshape(att, (B, n_heads, Cq, Dv)), q.dtype)


def paged_prefill_attention(
    b: ModelBuilder, x: Value, w: Dict[str, Value], *,
    prefix: str, n_heads: int, n_kv: int, d_head: int,
    rope: Tuple[Value, Value], pool_k: Value, pool_v: Value,
    page_tbl: Value, pos0: Value, page_size: int,
    window: Optional[int] = None, qkv_bias: bool = False,
) -> Tuple[Value, Tuple[Value, Value]]:
    """Chunked-prefill self attention through a paged KV pool.

    x: (1, C, Dm) — one request's prompt chunk at absolute positions
    ``pos0 .. pos0+C-1``; rope: the (C, half) tables built at offset
    ``pos0``; pool_k/pool_v: (P, Hkv, ps, D) page pools; page_tbl: the
    row's (1, MP) table.  All C rotated k/v rows are written straight
    into the row's pages (the :func:`paged_write` one-hot blend, with
    the chunk axis standing in for the batch axis — positions within a
    chunk are distinct, so rows never collide), then the slot-major view
    is gathered back and attended causally at absolute positions with
    the same masked f32 math as the decode paths.  Earlier chunks' rows
    (and COW-shared prefix pages) are already in the pool, so a long
    prompt prefills chunk by chunk without a dense (1, P) cache.
    Returns (out (1, C, Dm), (new_pool_k, new_pool_v)).
    """
    q, k, v = project_qkv(b, x, w, prefix, n_heads, n_kv, qkv_bias)
    q = apply_rope(q, *rope)
    k = apply_rope(k, *rope)
    Cq = x.shape[1]
    MP = page_tbl.shape[1]
    positions = ops.broadcast_to(pos0, (Cq,)) + ops.iota((Cq,), 0, "i32")
    ptbl_c = ops.broadcast_to(page_tbl, (Cq, MP))
    k_rows = ops.transpose(k, (2, 1, 0, 3))      # (C, Hkv, 1, D)
    v_rows = ops.transpose(v, (2, 1, 0, 3))
    pool_k = paged_write(pool_k, k_rows, ptbl_c, positions, page_size)
    pool_v = paged_write(pool_v, v_rows, ptbl_c, positions, page_size)
    gk = paged_gather(pool_k, page_tbl)
    gv = paged_gather(pool_v, page_tbl)
    Skv = gk.shape[2]
    kpos = ops.iota((1, Skv), 1, "i32")
    att = _chunkpos_attend(q, gk, gv, kpos, positions, n_heads=n_heads,
                           n_kv=n_kv, d_head=d_head, window=window)
    out = ops.matmul(merge_heads(att), b.cast(w[f"{prefix}wo"]))
    return constrain(out, BATCH_SPEC), (pool_k, pool_v)


# -- in-graph stochastic sampling ----------------------------------------------
def prng_uniform_rows(key: Value, pos: Value) -> Value:
    """Per-row uniform in (0, 1) from (key, pos) — a tiny counter-based
    in-graph hash (the classic frac-sin construction), so the stochastic
    sampler is a pure function of its graph inputs: same key + position
    always draws the same uniform, rows never share a stream, and the
    chunked decode scan gets a fresh draw every step because ``pos``
    advances.  key/pos: (B,) i32 -> (B,) f32.  (Not crypto-grade — a
    serving-reproducibility PRNG, mirrored bit-for-bit by the engine's
    host-side prefill sampler.  Keys hash through f32, which is exact
    only up to 2^24 — the engine rejects larger keys at submit so two
    keys can never silently share a stream.)"""
    x = ops.convert(key, "f32") * ops.constant(12.9898, dtype="f32") \
        + ops.convert(pos, "f32") * ops.constant(78.233, dtype="f32") \
        + ops.constant(0.5, dtype="f32")
    s = ops.sin(x) * ops.constant(43758.5453, dtype="f32")
    u = s - ops.floor(s)
    return ops.minimum(ops.maximum(u, ops.constant(1e-7, dtype="f32")),
                       ops.constant(1.0 - 1e-7, dtype="f32"))


def sample_tokens(logits: Value, temperature: Value, top_k: Value,
                  key: Value, pos: Value) -> Value:
    """In-graph token sampling: temperature / top-k / PRNG key are graph
    *inputs*, so one compiled executable serves greedy and stochastic
    requests side by side (per row).

    logits (B, 1, V); temperature (B,) f32 (``0`` = greedy argmax — the
    parity baseline); top_k (B,) i32 (``0`` = full vocabulary); key/pos
    (B,) i32.  Returns (B, 1) i32 sampled token ids.

    Stochastic rows sample by inverse CDF: softmax of the top-k-masked,
    temperature-scaled logits, then the first index whose cumulative
    probability crosses the row's uniform draw (``min(#cdf<u, V-1)`` —
    robust to the cumulative sum topping out just below 1).  The dynamic
    top-k threshold is the row's k-th largest logit via a full descending
    sort (O(V log V) — fine at serving vocab sizes; values tied with the
    threshold are kept, the standard top-k convention).
    """
    B, V = logits.shape[0], logits.shape[-1]
    lg = ops.reshape(ops.convert(logits, "f32"), (B, V))
    greedy = ops.argmax(lg, -1)                              # (B,) i32
    svals, _ = ops.top_k(lg, V)                              # descending sort
    full = ops.broadcast_to(ops.constant(V, dtype="i32"), (B,))
    keff = ops.select(ops.greater(top_k, ops.constant(0, dtype="i32")),
                      ops.minimum(top_k, full), full)
    kth = ops.take_along_last(svals, ops.reshape(
        keff - ops.constant(1, dtype="i32"), (B, 1)))        # (B, 1)
    masked = ops.select(ops.greater_equal(lg, ops.broadcast_to(kth, (B, V))),
                        lg, ops.constant(-1e30, dtype="f32"))
    temp = ops.maximum(temperature, ops.constant(1e-6, dtype="f32"))
    p = ops.softmax(masked / ops.reshape(temp, (B, 1)), axis=-1)
    u = prng_uniform_rows(key, pos)
    below = ops.convert(ops.less(ops.cumsum(p, -1),
                                 ops.reshape(u, (B, 1))), "i32")
    pick = ops.minimum(ops.reduce_sum(below, axes=[1]),
                       ops.constant(V - 1, dtype="i32"))
    tok = ops.select(ops.greater(temperature,
                                 ops.constant(0.0, dtype="f32")),
                     pick, greedy)
    return ops.reshape(tok, (B, 1))


def cross_attention(
    b: ModelBuilder, x: Value, kv_src: Value, w: Dict[str, Value], *,
    prefix: str, n_heads: int, n_kv: int, d_head: int,
) -> Value:
    q, k, v = project_qkv(b, x, w, prefix, n_heads, n_kv, kv_x=kv_src)
    att = ops.attention(q, k, v, causal=False, scale=1.0 / math.sqrt(d_head))
    out = ops.matmul(merge_heads(att), b.cast(w[f"{prefix}wo"]))
    return constrain(out, BATCH_SPEC)


# -- MLP -----------------------------------------------------------------------
def mlp_specs(d_model: int, d_ff: int, kind: str = "swiglu") -> Specs:
    if kind == "swiglu":
        return {
            "w_gate": ((d_model, d_ff), ("embed", "ffn")),
            "w_up": ((d_model, d_ff), ("embed", "ffn")),
            "w_down": ((d_ff, d_model), ("ffn", "embed")),
        }
    return {  # gelu
        "w_in": ((d_model, d_ff), ("embed", "ffn")),
        "b_in": ((d_ff,), ("ffn",)),
        "w_out": ((d_ff, d_model), ("ffn", "embed")),
        "b_out": ((d_model,), (None,)),
    }


def mlp_inits(prefix: str, kind: str = "swiglu"):
    if kind == "swiglu":
        return {f"{prefix}{k}": fanin_init()
                for k in ("w_gate", "w_up", "w_down")}
    return {f"{prefix}w_in": fanin_init(), f"{prefix}b_in": zeros_init(),
            f"{prefix}w_out": fanin_init(), f"{prefix}b_out": zeros_init()}


def apply_mlp(b: ModelBuilder, x: Value, w: Dict[str, Value],
              prefix: str = "mlp_", kind: str = "swiglu") -> Value:
    if kind == "swiglu":
        g = ops.silu(ops.matmul(x, b.cast(w[f"{prefix}w_gate"])))
        u = ops.matmul(x, b.cast(w[f"{prefix}w_up"]))
        h = constrain(g * u, ("batch", None, "ffn"))
        return constrain(ops.matmul(h, b.cast(w[f"{prefix}w_down"])), BATCH_SPEC)
    h = ops.gelu(ops.matmul(x, b.cast(w[f"{prefix}w_in"])) + b.cast(w[f"{prefix}b_in"]))
    h = constrain(h, ("batch", None, "ffn"))
    return constrain(ops.matmul(h, b.cast(w[f"{prefix}w_out"]))
                     + b.cast(w[f"{prefix}b_out"]), BATCH_SPEC)


# -- embedding / unembedding / loss ------------------------------------------------
def embed_tokens(b: ModelBuilder, tokens: Value, vocab: int, d_model: int,
                 name: str = "embed/table") -> Value:
    table = b.raw_param(name, (vocab, d_model), ("vocab", "embed"))
    h = ops.gather(b.cast(table), tokens, axis=0)
    return constrain(h, BATCH_SPEC)


def unembed(b: ModelBuilder, h: Value, vocab: int, d_model: int,
            name: str = "unembed/w", tied_table: Optional[str] = None) -> Value:
    if tied_table is not None:
        w = ops.transpose(b.cast(b.params[tied_table].node.out()), (1, 0))
    else:
        w = b.cast(b.raw_param(name, (d_model, vocab), ("embed", "vocab")))
    logits = ops.matmul(h, w)
    return constrain(logits, ("batch", None, "vocab"))


def lm_loss(logits: Value, labels: Value) -> Value:
    """Mean next-token cross entropy; logits (B,S,V) labels (B,S)."""
    per_tok = ops.softmax_cross_entropy(ops.convert(logits, "f32"), labels)
    return ops.reduce_mean(per_tok)


def prefix_weights(specs: Specs, prefix: str) -> Specs:
    return {f"{prefix}{k}": v for k, v in specs.items()}
