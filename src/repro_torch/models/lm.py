"""Architecture assembly: every assigned arch as train / prefill / decode
IR graphs.

All ten architectures are *frontend programs* over the same IR (nGraph's
O(frameworks + platforms) claim): each family function assembles blocks
from ``components`` / ``moe`` / ``mla`` / ``recurrent`` / ``xlstm`` into a
``Function`` via ``ModelBuilder.scan_blocks`` (stacked layer weights +
the Scan op keep 80-layer graphs compact).  A copy of the reference's
``models/lm.py``.

Graph kinds:
  * train   — (tokens, labels, *W) -> scalar loss (optimizer wrapped on
              top by ``train_graph.make_train_step``)
  * prefill — (tokens[, frames/images], *W) -> (last-token logits,
              stacked KV/latent caches)
  * decode  — (token, pos, *caches, *W) -> (logits, *updated caches);
              sub-quadratic archs use ring buffers / recurrent state,
              which is what makes the 500k cell O(1) per step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from ..core import ops
from ..core.function import Function
from ..core.node import Value
from .builder import ModelBuilder, ones_init
from . import components as C
from . import mla as MLA
from . import moe as MOE
from . import recurrent as RG
from . import xlstm as XL

CACHE_SPEC = (None, "batch", "kv_heads", "kv_seq", None)  # (L,B,H,S,D)
# paged pools have no batch axis: (L, pages, H, page_size, D)
PAGED_CACHE_SPEC = (None, None, "kv_heads", None, None)


@dataclasses.dataclass
class ModelGraphs:
    cfg: ModelConfig
    kind: str
    fn: Function
    builder: ModelBuilder
    aux: Dict[str, object]


# =============================================================================
# shared pieces
# =============================================================================
def _embed(b: ModelBuilder, cfg: ModelConfig, tokens: Value) -> Value:
    return C.embed_tokens(b, tokens, cfg.vocab, cfg.d_model)


def _final_logits(b: ModelBuilder, cfg: ModelConfig, h: Value,
                  last_only: bool = False) -> Value:
    B, S, D = h.shape
    g = b.raw_param("final_norm/g", (D,), (None,), ones_init())
    if cfg.norm == "layernorm":
        from .builder import zeros_init
        bb = b.raw_param("final_norm/b", (D,), (None,), zeros_init())
        h = ops.layer_norm(h, g, bb, eps=cfg.norm_eps)
    else:
        h = ops.rms_norm(h, g, eps=cfg.norm_eps)
    if last_only:
        h = ops.slice_(h, [0, S - 1, 0], [B, S, D])
    tied = "embed/table" if cfg.tie_embeddings else None
    return C.unembed(b, h, cfg.vocab, cfg.d_model, tied_table=tied)


def _loss_result(b: ModelBuilder, cfg: ModelConfig, h: Value, labels: Value,
                 aux: Optional[Value] = None) -> Value:
    logits = _final_logits(b, cfg, h)
    loss = C.lm_loss(logits, labels)
    if aux is not None:
        loss = loss + ops.convert(aux, "f32")
    return loss


def _block_norm_specs(cfg: ModelConfig, prefix: str) -> C.Specs:
    return C.prefix_weights(C.norm_specs(cfg.d_model, cfg.norm), prefix)


def _cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Decode cache length: ring/window for sub-quadratic archs on the
    long shape, full otherwise."""
    if shape.kind == "long_decode":
        if cfg.window is not None:
            return cfg.window
        if cfg.family == "rg_hybrid":
            return cfg.local_window
    return shape.seq_len


# =============================================================================
# dense family (qwen / granite / deepseek-7b / minicpm)
# =============================================================================
def _dense_layer_specs(cfg: ModelConfig) -> Tuple[C.Specs, Dict]:
    dh = cfg.head_dim
    specs: C.Specs = {}
    specs.update(_block_norm_specs(cfg, "ln1_"))
    specs.update(C.prefix_weights(
        C.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, dh,
                     cfg.qkv_bias), "attn_"))
    specs.update(_block_norm_specs(cfg, "ln2_"))
    specs.update(C.prefix_weights(C.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp),
                                  "mlp_"))
    inits = {}
    inits.update(C.norm_inits("ln1_", cfg.norm))
    inits.update(C.attn_inits("attn_", cfg.qkv_bias))
    inits.update(C.norm_inits("ln2_", cfg.norm))
    inits.update(C.mlp_inits("mlp_", cfg.mlp))
    return specs, inits


def _dense_block(b, cfg, h, w, rope, *, window=None, cache=None, pos=None,
                 ring=False, return_kv=False, paged=None, chunk=False):
    dh = cfg.head_dim
    xn = C.apply_norm(h, w, "ln1_", cfg.norm, cfg.norm_eps)
    if paged is not None and chunk:
        # chunked prefill: a (1, C) prompt slice written straight into the
        # page pool; pos is the scalar base position of the chunk
        page_tbl, page_size = paged
        att, extras = C.paged_prefill_attention(
            b, xn, w, prefix="attn_", n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=dh, rope=rope, pool_k=cache[0],
            pool_v=cache[1], page_tbl=page_tbl, pos0=pos,
            page_size=page_size, window=window, qkv_bias=cfg.qkv_bias)
    elif paged is not None:
        # paged: cache is (pool_k, pool_v) page pools, paged is the
        # (page_tbl, page_size) routing pair
        page_tbl, page_size = paged
        att, extras = C.paged_self_attention(
            b, xn, w, prefix="attn_", n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=dh, rope=rope, pool_k=cache[0],
            pool_v=cache[1], page_tbl=page_tbl, pos=pos,
            page_size=page_size, window=window, qkv_bias=cfg.qkv_bias)
    else:
        att, extras = C.self_attention(
            b, xn, w, prefix="attn_", n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=dh, rope=rope, causal=True,
            window=window, qkv_bias=cfg.qkv_bias,
            cache_k=cache[0] if cache else None,
            cache_v=cache[1] if cache else None,
            pos=pos, ring=ring, return_kv=return_kv)
    h = h + att
    xn2 = C.apply_norm(h, w, "ln2_", cfg.norm, cfg.norm_eps)
    h = h + C.apply_mlp(b, xn2, w, "mlp_", cfg.mlp)
    return h, extras


def build_dense(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> ModelGraphs:
    b = ModelBuilder(cfg.param_dtype, cfg.compute_dtype)
    kind = shape.kind
    dh = cfg.head_dim
    specs, inits = _dense_layer_specs(cfg)

    if kind in ("train", "prefill"):
        S = shape.seq_len
        tokens = b.input("tokens", (batch, S))
        labels = b.input("labels", (batch, S)) if kind == "train" else None
        h = _embed(b, cfg, tokens)
        cos, sin = C.rope_tables(b, S, dh, cfg.rope_base)
        want_kv = kind == "prefill"

        def body(carries, w, consts):
            hh, ex = _dense_block(b, cfg, carries[0], w,
                                  (consts[0], consts[1]), window=cfg.window,
                                  return_kv=want_kv)
            return [hh], list(ex)

        (h,), ys = b.scan_blocks(
            "layers", cfg.n_layers, specs, body, [h], consts=[cos, sin],
            n_ys=2 if want_kv else 0, weight_inits=inits)
        if kind == "train":
            return ModelGraphs(cfg, kind, b.finish(
                [_loss_result(b, cfg, h, labels)], f"{cfg.name}_train"), b, {})
        logits = _final_logits(b, cfg, h, last_only=True)
        return ModelGraphs(cfg, kind, b.finish(
            [logits, ys[0], ys[1]], f"{cfg.name}_prefill"), b,
            {"cache_shapes": [y.shape for y in ys],
             "cache_names": ["cache_k", "cache_v"]})

    # serve: continuous-batching decode step — per-row position vector and
    # in-graph greedy sampling, so only token ids cross the host boundary
    if kind == "serve":
        Skv = shape.seq_len
        token = b.input("token", (batch, 1))
        pos = b.input("pos", (batch,), spec=("batch",))
        ck = b.input("cache_k", (cfg.n_layers, batch, cfg.n_kv_heads, Skv, dh),
                     dtype=cfg.compute_dtype, spec=CACHE_SPEC)
        cv = b.input("cache_v", (cfg.n_layers, batch, cfg.n_kv_heads, Skv, dh),
                     dtype=cfg.compute_dtype, spec=CACHE_SPEC)
        h = _embed(b, cfg, token)
        cosr, sinr = C.rope_tables_rows(b, pos, dh, cfg.rope_base)

        def body(carries, w, consts):
            hh, ex = _dense_block(
                b, cfg, carries[0], w, (consts[0], consts[1]),
                window=cfg.window, cache=(w["cache_k"], w["cache_v"]),
                pos=consts[2])
            return [hh], list(ex)

        (h,), ys = b.scan_blocks(
            "layers", cfg.n_layers, specs, body, [h],
            consts=[cosr, sinr, pos], xs_extra={"cache_k": ck, "cache_v": cv},
            n_ys=2, weight_inits=inits)
        logits = _final_logits(b, cfg, h, last_only=True)
        sample = ops.reshape(ops.argmax(logits, -1), (batch, 1))
        return ModelGraphs(cfg, kind, b.finish(
            [sample, ys[0], ys[1]], f"{cfg.name}_serve"), b,
            {"cache_names": ["cache_k", "cache_v"],
             "state_out_names": ["cache_k", "cache_v"],
             "sample_output": 0})

    # serve_paged: like serve, but KV lives in a shared page pool routed
    # through a per-row page table, and sampling (temperature / top-k /
    # PRNG key) is in-graph with greedy (temperature 0) as the default —
    # token-for-token identical to `serve` under greedy
    if kind == "serve_paged":
        if shape.page_size is None:
            raise ValueError("serve_paged needs ShapeConfig.page_size")
        ps = int(shape.page_size)
        mp = -(-shape.seq_len // ps)      # logical pages per slot
        n_pages = 1 + batch * mp          # + physical page 0 = trash page
        token = b.input("token", (batch, 1))
        pos = b.input("pos", (batch,), spec=("batch",))
        ptbl = b.input("page_tbl", (batch, mp), spec=("batch", None))
        temp = b.input("temperature", (batch,), dtype="f32", spec=("batch",))
        tk = b.input("top_k", (batch,), spec=("batch",))
        key = b.input("key", (batch,), spec=("batch",))
        ck = b.input("cache_k", (cfg.n_layers, n_pages, cfg.n_kv_heads, ps, dh),
                     dtype=cfg.compute_dtype, spec=PAGED_CACHE_SPEC)
        cv = b.input("cache_v", (cfg.n_layers, n_pages, cfg.n_kv_heads, ps, dh),
                     dtype=cfg.compute_dtype, spec=PAGED_CACHE_SPEC)
        h = _embed(b, cfg, token)
        cosr, sinr = C.rope_tables_rows(b, pos, dh, cfg.rope_base)

        def body(carries, w, consts):
            hh, ex = _dense_block(
                b, cfg, carries[0], w, (consts[0], consts[1]),
                window=cfg.window, cache=(w["cache_k"], w["cache_v"]),
                pos=consts[2], paged=(consts[3], ps))
            return [hh], list(ex)

        (h,), ys = b.scan_blocks(
            "layers", cfg.n_layers, specs, body, [h],
            consts=[cosr, sinr, pos, ptbl],
            xs_extra={"cache_k": ck, "cache_v": cv},
            n_ys=2, weight_inits=inits)
        logits = _final_logits(b, cfg, h, last_only=True)
        sample = C.sample_tokens(logits, temp, tk, key, pos)
        return ModelGraphs(cfg, kind, b.finish(
            [sample, ys[0], ys[1]], f"{cfg.name}_serve_paged"), b,
            {"cache_names": ["cache_k", "cache_v"],
             "state_out_names": ["cache_k", "cache_v"],
             "sample_output": 0, "page_size": ps, "max_pages": mp,
             "n_pages": n_pages})

    # decode
    Skv = _cache_len(cfg, shape)
    ring = shape.kind == "long_decode" and cfg.window is not None
    token = b.input("token", (batch, 1))
    pos = b.input("pos", (), spec=())
    ck = b.input("cache_k", (cfg.n_layers, batch, cfg.n_kv_heads, Skv, dh),
                 dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    cv = b.input("cache_v", (cfg.n_layers, batch, cfg.n_kv_heads, Skv, dh),
                 dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    h = _embed(b, cfg, token)
    cos, sin = C.rope_tables(b, 1, dh, cfg.rope_base, offset=pos)

    def body(carries, w, consts):
        hh, ex = _dense_block(
            b, cfg, carries[0], w, (consts[0], consts[1]),
            window=cfg.window, cache=(w["cache_k"], w["cache_v"]),
            pos=consts[2], ring=ring)
        return [hh], list(ex)

    (h,), ys = b.scan_blocks(
        "layers", cfg.n_layers, specs, body, [h], consts=[cos, sin, pos],
        xs_extra={"cache_k": ck, "cache_v": cv}, n_ys=2, weight_inits=inits)
    logits = _final_logits(b, cfg, h, last_only=True)
    return ModelGraphs(cfg, kind, b.finish(
        [logits, ys[0], ys[1]], f"{cfg.name}_decode"), b,
        {"cache_names": ["cache_k", "cache_v"]})


def _dense_flat_params(b: ModelBuilder, cfg: ModelConfig, specs: C.Specs,
                       inits: Dict):
    """Declare the dense family's parameters flat (no scan_blocks), in
    the decode/serve builders' declaration order — embed, stacked layer
    weights, final norm, unembed — so ``init_params(seed)`` yields
    weights identical to those builders'.  Stacked float weights are
    pre-cast to the compute dtype (the chunk builders thread them into
    the layer scan as xs).  Returns (table, stacked, gf, bf, wu)."""
    from ..core.types import is_float

    table = b.raw_param("embed/table", (cfg.vocab, cfg.d_model),
                        ("vocab", "embed"))
    stacked = []
    for wname in list(specs):
        shape_, logical = specs[wname]
        v = b.raw_param(f"layers/{wname}", (cfg.n_layers,) + tuple(shape_),
                        ("layers",) + tuple(logical), inits.get(wname))
        if is_float(v.dtype):
            v = ops.convert(v, b.compute_dtype)
        stacked.append(v)
    gf = b.raw_param("final_norm/g", (cfg.d_model,), (None,), ones_init())
    bf = None
    if cfg.norm == "layernorm":
        from .builder import zeros_init
        bf = b.raw_param("final_norm/b", (cfg.d_model,), (None,), zeros_init())
    wu = None
    if not cfg.tie_embeddings:
        wu = b.raw_param("unembed/w", (cfg.d_model, cfg.vocab),
                         ("embed", "vocab"))
    return table, stacked, gf, bf, wu


def _build_paged_chunk(cfg: ModelConfig, max_len: int, batch: int,
                       steps: int, page_size: int,
                       n_pages: Optional[int]) -> ModelGraphs:
    """The paged + sampling chunk graph behind ``build_dense_chunk``
    (``page_size`` set): ``steps`` serve_paged steps fused into one outer
    Scan, with the sampled token fed back into the embedding and the
    per-row position vector advancing in-graph.  See
    :func:`build_dense_chunk` for the contract."""
    b = ModelBuilder(cfg.param_dtype, cfg.compute_dtype)
    L, dh = cfg.n_layers, cfg.head_dim
    specs, inits = _dense_layer_specs(cfg)
    ps = int(page_size)
    mp = -(-max_len // ps)                 # logical pages per row
    P = int(n_pages) if n_pages is not None else 1 + batch * mp
    token = b.input("token", (batch, 1))
    pos = b.input("pos", (batch,), spec=("batch",))
    ptbl = b.input("page_tbl", (batch, mp), spec=("batch", None))
    temp = b.input("temperature", (batch,), dtype="f32", spec=("batch",))
    tk = b.input("top_k", (batch,), spec=("batch",))
    key = b.input("key", (batch,), spec=("batch",))
    ck = b.input("cache_k", (L, P, cfg.n_kv_heads, ps, dh),
                 dtype=cfg.compute_dtype, spec=PAGED_CACHE_SPEC)
    cv = b.input("cache_v", (L, P, cfg.n_kv_heads, ps, dh),
                 dtype=cfg.compute_dtype, spec=PAGED_CACHE_SPEC)
    table, stacked, gf, bf, wu = _dense_flat_params(b, cfg, specs, inits)
    wnames = list(specs)

    # outer-scan body: one serve_paged step on body-local parameters
    cp_tok = ops.parameter((batch, 1), "i32", "tok")
    cp_pos = ops.parameter((batch,), "i32", "pos")
    cp_ck = ops.parameter(ck.shape, ck.dtype, "ck")
    cp_cv = ops.parameter(cv.shape, cv.dtype, "cv")
    const_vals = [ptbl, temp, tk, key, table] + stacked + [gf] \
        + ([bf] if bf is not None else []) + ([wu] if wu is not None else [])
    const_params = [ops.parameter(v.shape, v.dtype, f"w{i}")
                    for i, v in enumerate(const_vals)]
    cw = [p.out() for p in const_params]
    c_ptbl, c_temp, c_tk, c_key = cw[:4]
    c_table, c_stacked = cw[4], cw[5:5 + len(stacked)]
    c_gf = cw[5 + len(stacked)]
    nxt = 6 + len(stacked)
    c_bf = cw[nxt] if bf is not None else None
    c_wu = cw[-1] if wu is not None else None

    h = C.constrain(ops.gather(ops.convert(c_table, b.compute_dtype),
                               cp_tok.out(), axis=0), C.BATCH_SPEC)
    cosr, sinr = C.rope_tables_rows(b, cp_pos.out(), dh, cfg.rope_base)

    def body(carries, w, consts):
        hh, ex = _dense_block(
            b, cfg, carries[0], w, (consts[0], consts[1]),
            window=cfg.window, cache=(w["cache_k"], w["cache_v"]),
            pos=consts[2], paged=(consts[3], ps))
        return [hh], list(ex)

    xs_extra = dict(zip(wnames, c_stacked))
    xs_extra["cache_k"] = cp_ck.out()
    xs_extra["cache_v"] = cp_cv.out()
    (h,), ys = b.scan_blocks(
        "chunk_layers", L, {}, body, [h],
        consts=[cosr, sinr, cp_pos.out(), c_ptbl], xs_extra=xs_extra, n_ys=2)
    if cfg.norm == "layernorm":
        h = ops.layer_norm(h, c_gf, c_bf, eps=cfg.norm_eps)
    else:
        h = ops.rms_norm(h, c_gf, eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        wun = ops.transpose(ops.convert(c_table, b.compute_dtype), (1, 0))
    else:
        wun = ops.convert(c_wu, b.compute_dtype)
    logits = C.constrain(ops.matmul(h, wun), ("batch", None, "vocab"))
    sample = C.sample_tokens(logits, c_temp, c_tk, c_key, cp_pos.out())
    new_pos = cp_pos.out() + ops.constant(1, dtype="i32")
    body_fn = Function([cp_tok, cp_pos, cp_ck, cp_cv] + const_params,
                       [sample, new_pos, ys[0], ys[1], sample],
                       name=f"{cfg.name}_paged_chunk_body")

    outs = ops.scan(body_fn, [token, pos, ck, cv], xs=[],
                    consts=const_vals, length=steps)
    toks = outs[4]  # stacked ys: (steps, B, 1)
    fn = b.finish([toks, outs[2], outs[3]], f"{cfg.name}_paged_chunk{steps}")
    return ModelGraphs(cfg, "serve_paged_chunk", fn, b,
                       {"cache_names": ["cache_k", "cache_v"],
                        "state_out_names": ["cache_k", "cache_v"],
                        "steps": steps, "page_size": ps, "max_pages": mp,
                        "n_pages": P})


def build_dense_chunk(cfg: ModelConfig, max_len: int, batch: int,
                      steps: int, *, page_size: Optional[int] = None,
                      n_pages: Optional[int] = None) -> ModelGraphs:
    """``steps`` fused decode steps in one executable.

    The decode hot loop — layer scan, cache update, sampling, and the
    token feedback into the embedding — runs inside an outer Scan, so a
    single dispatch generates ``steps`` tokens per row and the per-step
    host/dispatch overhead is amortized away (nGraph sec. 4: the
    execution loop belongs inside the backend executable).

    Default (dense-cache, greedy) form:

    (token (B,1), pos (), cache_k, cache_v, *W) ->
        (tokens (steps,B,1), cache_k', cache_v')

    Token-for-token identical to stepping the ``decode`` graph: the body
    is the same block stack, and greedy argmax breaks ties toward the
    lower index exactly like ``np.argmax`` on the returned logits.
    Parameters are declared in the same order as the decode/serve
    builders, so ``init_params(seed)`` yields identical weights.

    With ``page_size`` set, this is the *paged chunked serving* form the
    ``paged`` engine mode dispatches: per-row position vector, KV in a
    shared page pool of ``n_pages`` pages (default: one trash page plus
    ``batch * ceil(max_len/page_size)``) routed via a per-row page table,
    and in-graph stochastic sampling (temperature / top-k / PRNG key as
    inputs, temperature 0 = greedy):

    (token (B,1), pos (B,), page_tbl (B,MP), temperature (B,),
     top_k (B,), key (B,), cache_k (L,P,Hkv,ps,Dh), cache_v, *W) ->
        (tokens (steps,B,1), cache_k', cache_v')

    The page table, sampling knobs, and weights are loop constants: rows
    admit/retire only at chunk boundaries (the engine re-dispatches with
    a refreshed page table), which is what keeps the hot loop at one
    dispatch per ``steps`` tokens per row.
    """
    if page_size is not None:
        return _build_paged_chunk(cfg, max_len, batch, steps,
                                  int(page_size), n_pages)
    b = ModelBuilder(cfg.param_dtype, cfg.compute_dtype)
    L, dh = cfg.n_layers, cfg.head_dim
    specs, inits = _dense_layer_specs(cfg)
    token = b.input("token", (batch, 1))
    pos = b.input("pos", (), spec=())
    ck = b.input("cache_k", (L, batch, cfg.n_kv_heads, max_len, dh),
                 dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    cv = b.input("cache_v", (L, batch, cfg.n_kv_heads, max_len, dh),
                 dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    table, stacked, gf, bf, wu = _dense_flat_params(b, cfg, specs, inits)
    wnames = list(specs)

    # outer-scan body: one full decode step on body-local parameters
    cp_tok = ops.parameter((batch, 1), "i32", "tok")
    cp_pos = ops.parameter((), "i32", "pos")
    cp_ck = ops.parameter(ck.shape, ck.dtype, "ck")
    cp_cv = ops.parameter(cv.shape, cv.dtype, "cv")
    const_vals = [table] + stacked + [gf] + ([bf] if bf is not None else []) \
        + ([wu] if wu is not None else [])
    const_params = [ops.parameter(v.shape, v.dtype, f"w{i}")
                    for i, v in enumerate(const_vals)]
    cw = [p.out() for p in const_params]
    c_table, c_stacked = cw[0], cw[1:1 + len(stacked)]
    c_gf = cw[1 + len(stacked)]
    nxt = 2 + len(stacked)
    c_bf = cw[nxt] if bf is not None else None
    c_wu = cw[-1] if wu is not None else None

    h = C.constrain(ops.gather(ops.convert(c_table, b.compute_dtype),
                               cp_tok.out(), axis=0), C.BATCH_SPEC)
    cos, sin = C.rope_tables(b, 1, dh, cfg.rope_base, offset=cp_pos.out())

    def body(carries, w, consts):
        hh, ex = _dense_block(
            b, cfg, carries[0], w, (consts[0], consts[1]),
            window=cfg.window, cache=(w["cache_k"], w["cache_v"]),
            pos=consts[2])
        return [hh], list(ex)

    xs_extra = dict(zip(wnames, c_stacked))
    xs_extra["cache_k"] = cp_ck.out()
    xs_extra["cache_v"] = cp_cv.out()
    (h,), ys = b.scan_blocks(
        "chunk_layers", L, {}, body, [h],
        consts=[cos, sin, cp_pos.out()], xs_extra=xs_extra, n_ys=2)
    if cfg.norm == "layernorm":
        h = ops.layer_norm(h, c_gf, c_bf, eps=cfg.norm_eps)
    else:
        h = ops.rms_norm(h, c_gf, eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        wun = ops.transpose(ops.convert(c_table, b.compute_dtype), (1, 0))
    else:
        wun = ops.convert(c_wu, b.compute_dtype)
    logits = C.constrain(ops.matmul(h, wun), ("batch", None, "vocab"))
    sample = ops.argmax(logits, -1)  # (B, 1) i32
    new_pos = cp_pos.out() + ops.constant(1, dtype="i32")
    body_fn = Function([cp_tok, cp_pos, cp_ck, cp_cv] + const_params,
                       [sample, new_pos, ys[0], ys[1], sample],
                       name=f"{cfg.name}_chunk_body")

    outs = ops.scan(body_fn, [token, pos, ck, cv], xs=[],
                    consts=const_vals, length=steps)
    toks = outs[4]  # stacked ys: (steps, B, 1)
    fn = b.finish([toks, outs[2], outs[3]], f"{cfg.name}_chunk{steps}")
    return ModelGraphs(cfg, "decode_chunk", fn, b,
                       {"cache_names": ["cache_k", "cache_v"],
                        "steps": steps})


def build_dense_paged_prefill(cfg: ModelConfig, max_len: int, chunk: int, *,
                              page_size: int,
                              n_pages: Optional[int] = None) -> ModelGraphs:
    """One in-graph chunked-prefill dispatch for the paged engine.

    A (1, C) slice of a single request's prompt at base position ``pos``
    writes its K/V rows straight into the shared page pool (the
    :func:`~.components.paged_write` blend over the chunk — no dense
    (1, P) cache, no host-side scatter) and returns the last row's
    logits, so the final chunk of a prompt yields the request's first
    token.  The engine admits these chunks through the same scheduler
    step as decode rows: a long prompt no longer stalls in-flight
    decodes for a whole dense prefill.

    (token (1,C), pos (), page_tbl (1,MP),
     cache_k (L,P,Hkv,ps,Dh), cache_v, *W) ->
        (logits (1,1,V), cache_k', cache_v')

    Rope tables are built at offset ``pos`` and attention masks on
    absolute positions (``kpos <= pos + c``), so each row computes
    exactly what the dense ``prefill`` graph computes for it — chunked
    prefill is token-identical to dense prefill at every chunk size.
    Parameters are declared in the same order and under the same names
    as the serve/chunk builders, so the engine's existing weights bind
    by name.
    """
    b = ModelBuilder(cfg.param_dtype, cfg.compute_dtype)
    L, dh = cfg.n_layers, cfg.head_dim
    specs, inits = _dense_layer_specs(cfg)
    ps = int(page_size)
    mp = -(-max_len // ps)
    P = int(n_pages) if n_pages is not None else 1 + mp
    Cn = int(chunk)
    token = b.input("token", (1, Cn))
    pos = b.input("pos", (), spec=())
    ptbl = b.input("page_tbl", (1, mp), spec=("batch", None))
    ck = b.input("cache_k", (L, P, cfg.n_kv_heads, ps, dh),
                 dtype=cfg.compute_dtype, spec=PAGED_CACHE_SPEC)
    cv = b.input("cache_v", (L, P, cfg.n_kv_heads, ps, dh),
                 dtype=cfg.compute_dtype, spec=PAGED_CACHE_SPEC)
    h = _embed(b, cfg, token)
    # slice the chunk's rows out of the same host-computed table the
    # dense prefill graph bakes in — bitwise-equal rope is what keeps
    # chunked prefill token-identical to dense prefill
    cos, sin = C.rope_tables_sliced(b, max_len, dh, Cn, cfg.rope_base, pos)

    def body(carries, w, consts):
        hh, ex = _dense_block(
            b, cfg, carries[0], w, (consts[0], consts[1]),
            window=cfg.window, cache=(w["cache_k"], w["cache_v"]),
            pos=consts[2], paged=(consts[3], ps), chunk=True)
        return [hh], list(ex)

    (h,), ys = b.scan_blocks(
        "layers", cfg.n_layers, specs, body, [h],
        consts=[cos, sin, pos, ptbl],
        xs_extra={"cache_k": ck, "cache_v": cv},
        n_ys=2, weight_inits=inits)
    logits = _final_logits(b, cfg, h, last_only=True)
    fn = b.finish([logits, ys[0], ys[1]], f"{cfg.name}_paged_prefill{Cn}")
    return ModelGraphs(cfg, "prefill_paged", fn, b,
                       {"cache_names": ["cache_k", "cache_v"],
                        "state_out_names": ["cache_k", "cache_v"],
                        "page_size": ps, "max_pages": mp, "n_pages": P,
                        "chunk": Cn})


# =============================================================================
# MoE family (mixtral)
# =============================================================================
def _moe_layer_specs(cfg: ModelConfig) -> Tuple[C.Specs, Dict]:
    dh = cfg.head_dim
    specs: C.Specs = {}
    specs.update(_block_norm_specs(cfg, "ln1_"))
    specs.update(C.prefix_weights(
        C.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, dh), "attn_"))
    specs.update(_block_norm_specs(cfg, "ln2_"))
    specs.update(C.prefix_weights(
        MOE.moe_specs(cfg.d_model, cfg.n_experts, cfg.expert_d_ff,
                      cfg.n_shared_experts), "moe_"))
    inits = {}
    inits.update(C.norm_inits("ln1_", cfg.norm))
    inits.update(C.attn_inits("attn_"))
    inits.update(C.norm_inits("ln2_", cfg.norm))
    inits.update(MOE.moe_inits("moe_", cfg.n_shared_experts))
    return specs, inits


def _moe_block(b, cfg, h, aux, w, rope, *, cache=None, pos=None, ring=False,
               return_kv=False):
    dh = cfg.head_dim
    xn = C.apply_norm(h, w, "ln1_", cfg.norm, cfg.norm_eps)
    att, extras = C.self_attention(
        b, xn, w, prefix="attn_", n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        d_head=dh, rope=rope, causal=True, window=cfg.window,
        cache_k=cache[0] if cache else None,
        cache_v=cache[1] if cache else None, pos=pos, ring=ring,
        return_kv=return_kv)
    h = h + att
    xn2 = C.apply_norm(h, w, "ln2_", cfg.norm, cfg.norm_eps)
    mo, a = MOE.apply_moe(b, xn2, w, prefix="moe_", n_experts=cfg.n_experts,
                          top_k=cfg.top_k,
                          capacity_factor=cfg.capacity_factor)
    if cfg.n_shared_experts:
        mo = mo + MOE.apply_shared_expert(b, xn2, w, "moe_")
    h = h + mo
    aux = aux + a
    return h, aux, extras


def build_moe(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> ModelGraphs:
    b = ModelBuilder(cfg.param_dtype, cfg.compute_dtype)
    kind = shape.kind
    dh = cfg.head_dim
    specs, inits = _moe_layer_specs(cfg)

    if kind in ("train", "prefill"):
        S = shape.seq_len
        tokens = b.input("tokens", (batch, S))
        labels = b.input("labels", (batch, S)) if kind == "train" else None
        h = _embed(b, cfg, tokens)
        aux0 = ops.constant(0.0, dtype="f32")
        cos, sin = C.rope_tables(b, S, dh, cfg.rope_base)
        want_kv = kind == "prefill"

        def body(carries, w, consts):
            hh, aux, ex = _moe_block(b, cfg, carries[0], carries[1], w,
                                     (consts[0], consts[1]),
                                     return_kv=want_kv)
            return [hh, aux], list(ex)

        (h, aux), ys = b.scan_blocks(
            "layers", cfg.n_layers, specs, body, [h, aux0],
            consts=[cos, sin], n_ys=2 if want_kv else 0, weight_inits=inits)
        if kind == "train":
            aux = aux * ops.constant(cfg.router_aux_weight / cfg.n_layers,
                                     dtype="f32")
            return ModelGraphs(cfg, kind, b.finish(
                [_loss_result(b, cfg, h, labels, aux)],
                f"{cfg.name}_train"), b, {})
        logits = _final_logits(b, cfg, h, last_only=True)
        return ModelGraphs(cfg, kind, b.finish(
            [logits, ys[0], ys[1]], f"{cfg.name}_prefill"), b,
            {"cache_names": ["cache_k", "cache_v"]})

    Skv = _cache_len(cfg, shape)
    ring = shape.kind == "long_decode" and cfg.window is not None
    token = b.input("token", (batch, 1))
    pos = b.input("pos", (), spec=())
    ck = b.input("cache_k", (cfg.n_layers, batch, cfg.n_kv_heads, Skv, dh),
                 dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    cv = b.input("cache_v", (cfg.n_layers, batch, cfg.n_kv_heads, Skv, dh),
                 dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    h = _embed(b, cfg, token)
    aux0 = ops.constant(0.0, dtype="f32")
    cos, sin = C.rope_tables(b, 1, dh, cfg.rope_base, offset=pos)

    def body(carries, w, consts):
        hh, aux, ex = _moe_block(b, cfg, carries[0], carries[1], w,
                                 (consts[0], consts[1]),
                                 cache=(w["cache_k"], w["cache_v"]),
                                 pos=consts[2], ring=ring)
        return [hh, aux], list(ex)

    (h, _), ys = b.scan_blocks(
        "layers", cfg.n_layers, specs, body, [h, aux0],
        consts=[cos, sin, pos], xs_extra={"cache_k": ck, "cache_v": cv},
        n_ys=2, weight_inits=inits)
    logits = _final_logits(b, cfg, h, last_only=True)
    return ModelGraphs(cfg, kind, b.finish(
        [logits, ys[0], ys[1]], f"{cfg.name}_decode"), b,
        {"cache_names": ["cache_k", "cache_v"],
         "state_out_names": ["cache_k", "cache_v"]})


# =============================================================================
# MLA + MoE family (deepseek-v3) — dense first_k layers, then MoE; MTP head
# =============================================================================
def _mla_attn_specs(cfg: ModelConfig) -> Tuple[C.Specs, Dict]:
    specs = C.prefix_weights(
        MLA.mla_specs(cfg.d_model, cfg.n_heads, cfg.q_lora, cfg.kv_lora,
                      cfg.d_nope, cfg.d_rope, cfg.d_v), "attn_")
    return specs, MLA.mla_inits("attn_")


def _v3_dense_specs(cfg) -> Tuple[C.Specs, Dict]:
    sa, ia = _mla_attn_specs(cfg)
    specs: C.Specs = {}
    specs.update(_block_norm_specs(cfg, "ln1_"))
    specs.update(sa)
    specs.update(_block_norm_specs(cfg, "ln2_"))
    specs.update(C.prefix_weights(C.mlp_specs(cfg.d_model, cfg.d_ff), "mlp_"))
    inits = {**C.norm_inits("ln1_"), **ia, **C.norm_inits("ln2_"),
             **C.mlp_inits("mlp_")}
    return specs, inits


def _v3_moe_specs(cfg) -> Tuple[C.Specs, Dict]:
    sa, ia = _mla_attn_specs(cfg)
    specs: C.Specs = {}
    specs.update(_block_norm_specs(cfg, "ln1_"))
    specs.update(sa)
    specs.update(_block_norm_specs(cfg, "ln2_"))
    specs.update(C.prefix_weights(
        MOE.moe_specs(cfg.d_model, cfg.n_experts, cfg.expert_d_ff,
                      cfg.n_shared_experts), "moe_"))
    inits = {**C.norm_inits("ln1_"), **ia, **C.norm_inits("ln2_"),
             **MOE.moe_inits("moe_", cfg.n_shared_experts)}
    return specs, inits


def _v3_block(b, cfg, h, aux, w, rope, *, moe: bool, cache=None, pos=None):
    xn = C.apply_norm(h, w, "ln1_", cfg.norm, cfg.norm_eps)
    att, extras = MLA.apply_mla(
        b, xn, w, prefix="attn_", n_heads=cfg.n_heads, q_lora=cfg.q_lora,
        kv_lora=cfg.kv_lora, d_nope=cfg.d_nope, d_rope=cfg.d_rope,
        d_v=cfg.d_v, rope=rope,
        cache_ckv=cache[0] if cache else None,
        cache_kr=cache[1] if cache else None, pos=pos)
    h = h + att
    xn2 = C.apply_norm(h, w, "ln2_", cfg.norm, cfg.norm_eps)
    if moe:
        mo, a = MOE.apply_moe(b, xn2, w, prefix="moe_",
                              n_experts=cfg.n_experts, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor)
        if cfg.n_shared_experts:
            mo = mo + MOE.apply_shared_expert(b, xn2, w, "moe_")
        h = h + mo
        aux = aux + a
    else:
        h = h + C.apply_mlp(b, xn2, w, "mlp_")
    return h, aux, extras


def build_mla_moe(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> ModelGraphs:
    b = ModelBuilder(cfg.param_dtype, cfg.compute_dtype)
    kind = shape.kind
    nd, nm = cfg.first_dense, cfg.n_layers - cfg.first_dense
    sd, idn = _v3_dense_specs(cfg)
    sm, imo = _v3_moe_specs(cfg)

    if kind in ("train", "prefill"):
        S = shape.seq_len
        tokens = b.input("tokens", (batch, S))
        labels = b.input("labels", (batch, S)) if kind == "train" else None
        h = _embed(b, cfg, tokens)
        aux = ops.constant(0.0, dtype="f32")
        cos, sin = C.rope_tables(b, S, cfg.d_rope, cfg.rope_base)
        want_kv = kind == "prefill"

        def dense_body(carries, w, consts):
            hh, a2, ex = _v3_block(b, cfg, carries[0], carries[1], w,
                                   (consts[0], consts[1]), moe=False)
            return [hh, a2], list(ex) if want_kv else []

        def moe_body(carries, w, consts):
            hh, a2, ex = _v3_block(b, cfg, carries[0], carries[1], w,
                                   (consts[0], consts[1]), moe=True)
            return [hh, a2], list(ex) if want_kv else []

        (h, aux), ys_d = b.scan_blocks(
            "dense", nd, sd, dense_body, [h, aux], consts=[cos, sin],
            n_ys=2 if want_kv else 0, weight_inits=idn)
        (h, aux), ys_m = b.scan_blocks(
            "moe", nm, sm, moe_body, [h, aux], consts=[cos, sin],
            n_ys=2 if want_kv else 0, weight_inits=imo)

        if kind == "prefill":
            logits = _final_logits(b, cfg, h, last_only=True)
            return ModelGraphs(cfg, kind, b.finish(
                [logits] + list(ys_d) + list(ys_m),
                f"{cfg.name}_prefill"), b,
                {"cache_names": ["dense_ckv", "dense_kr",
                                 "moe_ckv", "moe_kr"]})

        aux = aux * ops.constant(cfg.router_aux_weight / max(nm, 1), dtype="f32")
        loss = _loss_result(b, cfg, h, labels, aux)
        if cfg.mtp:
            loss = loss + _mtp_loss(b, cfg, h, tokens, labels)
        return ModelGraphs(cfg, kind, b.finish([loss], f"{cfg.name}_train"),
                           b, {})

    # decode: latent caches per layer (split dense/moe stacks)
    Skv = _cache_len(cfg, shape)
    token = b.input("token", (batch, 1))
    pos = b.input("pos", (), spec=())
    cd_kv = b.input("dense_ckv", (nd, batch, Skv, cfg.kv_lora),
                    dtype=cfg.compute_dtype, spec=(None, "batch", "kv_seq", None))
    cd_kr = b.input("dense_kr", (nd, batch, Skv, cfg.d_rope),
                    dtype=cfg.compute_dtype, spec=(None, "batch", "kv_seq", None))
    cm_kv = b.input("moe_ckv", (nm, batch, Skv, cfg.kv_lora),
                    dtype=cfg.compute_dtype, spec=(None, "batch", "kv_seq", None))
    cm_kr = b.input("moe_kr", (nm, batch, Skv, cfg.d_rope),
                    dtype=cfg.compute_dtype, spec=(None, "batch", "kv_seq", None))
    h = _embed(b, cfg, token)
    aux = ops.constant(0.0, dtype="f32")
    cos, sin = C.rope_tables(b, 1, cfg.d_rope, cfg.rope_base, offset=pos)

    def dense_body(carries, w, consts):
        hh, a2, ex = _v3_block(b, cfg, carries[0], carries[1], w,
                               (consts[0], consts[1]), moe=False,
                               cache=(w["ckv"], w["kr"]), pos=consts[2])
        return [hh, a2], list(ex)

    def moe_body(carries, w, consts):
        hh, a2, ex = _v3_block(b, cfg, carries[0], carries[1], w,
                               (consts[0], consts[1]), moe=True,
                               cache=(w["ckv"], w["kr"]), pos=consts[2])
        return [hh, a2], list(ex)

    (h, aux), ys_d = b.scan_blocks(
        "dense", nd, sd, dense_body, [h, aux], consts=[cos, sin, pos],
        xs_extra={"ckv": cd_kv, "kr": cd_kr}, n_ys=2, weight_inits=idn)
    (h, _), ys_m = b.scan_blocks(
        "moe", nm, sm, moe_body, [h, aux], consts=[cos, sin, pos],
        xs_extra={"ckv": cm_kv, "kr": cm_kr}, n_ys=2, weight_inits=imo)
    logits = _final_logits(b, cfg, h, last_only=True)
    return ModelGraphs(cfg, kind, b.finish(
        [logits] + list(ys_d) + list(ys_m), f"{cfg.name}_decode"), b,
        {"cache_names": ["dense_ckv", "dense_kr", "moe_ckv", "moe_kr"],
         "state_out_names": ["dense_ckv", "dense_kr",
                             "moe_ckv", "moe_kr"]})


def _mtp_loss(b: ModelBuilder, cfg: ModelConfig, h: Value, tokens: Value,
              labels: Value) -> Value:
    """One MTP depth: predict token t+2 from h_t and emb(token t+1)."""
    B, S, D = h.shape
    h1 = ops.slice_(h, [0, 0, 0], [B, S - 1, D])
    tok_next = ops.slice_(tokens, [0, 1], [B, S])
    emb = ops.gather(b.cast(b.params["embed/table"].node.out()), tok_next,
                     axis=0)
    g1 = b.raw_param("mtp/norm_h/g", (D,), (None,), ones_init())
    g2 = b.raw_param("mtp/norm_e/g", (D,), (None,), ones_init())
    cat = ops.concat([ops.rms_norm(h1, g1), ops.rms_norm(emb, g2)], axis=-1)
    wp = b.param("mtp/proj", (2 * D, D), ("embed", "embed"))
    hm = ops.matmul(cat, wp)
    # one transformer block on hm
    specs, inits = _v3_dense_specs(cfg)
    cos, sin = C.rope_tables(b, S - 1, cfg.d_rope, cfg.rope_base)

    def body(carries, w, consts):
        hh, _, _ = _v3_block(b, cfg, carries[0],
                             ops.constant(0.0, dtype="f32"), w,
                             (consts[0], consts[1]), moe=False)
        return [hh], []

    (hm,), _ = b.scan_blocks("mtp_block", 1, specs, body, [hm],
                             consts=[cos, sin], weight_inits=inits)
    gf = b.raw_param("mtp/final_norm/g", (D,), (None,), ones_init())
    logits = C.unembed(b, ops.rms_norm(hm, gf), cfg.vocab, cfg.d_model,
                       tied_table="embed/table")
    lbl2 = ops.slice_(labels, [0, 1], [B, S])
    return C.lm_loss(logits, lbl2) * ops.constant(cfg.mtp_weight, dtype="f32")


# =============================================================================
# RecurrentGemma hybrid
# =============================================================================
def _rg_group_specs(cfg: ModelConfig, pattern) -> Tuple[C.Specs, Dict]:
    dh = cfg.head_dim
    specs: C.Specs = {}
    inits: Dict = {}
    for i, kindp in enumerate(pattern):
        p = f"b{i}_"
        specs.update(_block_norm_specs(cfg, f"{p}ln1_"))
        inits.update(C.norm_inits(f"{p}ln1_", cfg.norm))
        if kindp == "rec":
            specs.update(C.prefix_weights(
                RG.rg_specs(cfg.d_model, cfg.lru_width, cfg.conv_width),
                f"{p}rec_"))
            inits.update(RG.rg_inits(f"{p}rec_"))
        else:
            specs.update(C.prefix_weights(
                C.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, dh),
                f"{p}attn_"))
            inits.update(C.attn_inits(f"{p}attn_"))
        specs.update(_block_norm_specs(cfg, f"{p}ln2_"))
        specs.update(C.prefix_weights(C.mlp_specs(cfg.d_model, cfg.d_ff),
                                      f"{p}mlp_"))
        inits.update(C.norm_inits(f"{p}ln2_", cfg.norm))
        inits.update(C.mlp_inits(f"{p}mlp_"))
    return specs, inits


def _rg_group(b, cfg, h, w, pattern, rope, *, decode=False, caches=None,
              pos=None, return_kv=False):
    """caches: dict with per-block entries (decode)."""
    dh = cfg.head_dim
    new_states: List[Value] = []
    kv_out: List[Value] = []
    for i, kindp in enumerate(pattern):
        p = f"b{i}_"
        xn = C.apply_norm(h, w, f"{p}ln1_", cfg.norm, cfg.norm_eps)
        if kindp == "rec":
            out, ex = RG.apply_rg_block(
                b, xn, w, prefix=f"{p}rec_",
                conv_tail=w.get(f"{p}tail") if decode else None,
                h_state=w.get(f"{p}h") if decode else None, decode=decode)
            if decode:
                new_states.extend(ex)
        else:
            out, ex = C.self_attention(
                b, xn, w, prefix=f"{p}attn_", n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, d_head=dh, rope=rope, causal=True,
                window=cfg.local_window,
                cache_k=w.get(f"{p}ck") if decode else None,
                cache_v=w.get(f"{p}cv") if decode else None,
                pos=pos, ring=decode and caches == "ring",
                return_kv=return_kv)
            if decode or return_kv:
                kv_out.extend(ex)
        h = h + out
        xn2 = C.apply_norm(h, w, f"{p}ln2_", cfg.norm, cfg.norm_eps)
        h = h + C.apply_mlp(b, xn2, w, f"{p}mlp_")
    return h, new_states, kv_out


def build_rg(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> ModelGraphs:
    b = ModelBuilder(cfg.param_dtype, cfg.compute_dtype)
    kind = shape.kind
    dh = cfg.head_dim
    pat = cfg.pattern
    n_groups = cfg.n_layers // len(pat)
    rem = cfg.n_layers - n_groups * len(pat)
    tail_pat = tuple(pat[:rem]) if rem else ()
    sg, ig = _rg_group_specs(cfg, pat)
    st, it = _rg_group_specs(cfg, tail_pat) if tail_pat else ({}, {})

    if kind in ("train", "prefill"):
        S = shape.seq_len
        tokens = b.input("tokens", (batch, S))
        labels = b.input("labels", (batch, S)) if kind == "train" else None
        h = _embed(b, cfg, tokens)
        cos, sin = C.rope_tables(b, S, dh, cfg.rope_base)
        want_kv = kind == "prefill"

        def mk_body(pattern):
            def body(carries, w, consts):
                hh, _, kvs = _rg_group(b, cfg, carries[0], w, pattern,
                                       (consts[0], consts[1]),
                                       return_kv=want_kv)
                return [hh], kvs
            return body

        n_attn = sum(1 for k in pat if k == "attn")
        (h,), ys = b.scan_blocks("groups", n_groups, sg, mk_body(pat), [h],
                                 consts=[cos, sin],
                                 n_ys=2 * n_attn if want_kv else 0,
                                 weight_inits=ig)
        if tail_pat:
            nta = sum(1 for k in tail_pat if k == "attn")
            (h,), ys2 = b.scan_blocks("tail", 1, st, mk_body(tail_pat), [h],
                                      consts=[cos, sin],
                                      n_ys=2 * nta if want_kv else 0,
                                      weight_inits=it)
            ys = list(ys) + list(ys2)
        if kind == "train":
            return ModelGraphs(cfg, kind, b.finish(
                [_loss_result(b, cfg, h, labels)], f"{cfg.name}_train"), b, {})
        logits = _final_logits(b, cfg, h, last_only=True)
        names = [f"g_{i}_{t}" for i, k in enumerate(pat) if k == "attn"
                 for t in ("ck", "cv")]
        names += [f"t_{i}_{t}" for i, k in enumerate(tail_pat) if k == "attn"
                  for t in ("ck", "cv")]
        return ModelGraphs(cfg, kind, b.finish([logits] + list(ys),
                                               f"{cfg.name}_prefill"), b,
                           {"cache_names": names})

    # decode: recurrent state + windowed attention cache
    Skv = _cache_len(cfg, shape)
    ring = shape.kind == "long_decode"
    token = b.input("token", (batch, 1))
    pos = b.input("pos", (), spec=())
    cw1 = cfg.conv_width - 1
    lw = cfg.lru_width

    def declare_states(tag, pattern, n):
        xs = {}
        for i, kindp in enumerate(pattern):
            p = f"b{i}_"
            if kindp == "rec":
                xs[f"{p}tail"] = b.input(
                    f"{tag}_{i}_tail", (n, batch, cw1, lw),
                    dtype=cfg.compute_dtype, spec=(None, "batch", None, None))
                xs[f"{p}h"] = b.input(
                    f"{tag}_{i}_h", (n, batch, 1, lw), dtype="f32",
                    spec=(None, "batch", None, None))
            else:
                xs[f"{p}ck"] = b.input(
                    f"{tag}_{i}_ck", (n, batch, cfg.n_kv_heads, Skv, dh),
                    dtype=cfg.compute_dtype, spec=CACHE_SPEC)
                xs[f"{p}cv"] = b.input(
                    f"{tag}_{i}_cv", (n, batch, cfg.n_kv_heads, Skv, dh),
                    dtype=cfg.compute_dtype, spec=CACHE_SPEC)
        return xs

    xs_main = declare_states("g", pat, n_groups)
    xs_tail = declare_states("t", tail_pat, 1) if tail_pat else {}
    h = _embed(b, cfg, token)
    cos, sin = C.rope_tables(b, 1, dh, cfg.rope_base, offset=pos)

    def mk_body(pattern):
        def body(carries, w, consts):
            hh, states, kvs = _rg_group(
                b, cfg, carries[0], w, pattern, (consts[0], consts[1]),
                decode=True, caches="ring" if ring else None, pos=consts[2])
            return [hh], states + kvs
        return body

    def n_states(pattern):
        return sum(2 for k in pattern)  # rec: (tail,h); attn: (ck,cv)

    (h,), ys1 = b.scan_blocks("groups", n_groups, sg, mk_body(pat), [h],
                              consts=[cos, sin, pos], xs_extra=xs_main,
                              n_ys=n_states(pat), weight_inits=ig)
    ys = list(ys1)
    if tail_pat:
        (h,), ys2 = b.scan_blocks("tail", 1, st, mk_body(tail_pat), [h],
                                  consts=[cos, sin, pos], xs_extra=xs_tail,
                                  n_ys=n_states(tail_pat), weight_inits=it)
        ys += list(ys2)
    logits = _final_logits(b, cfg, h, last_only=True)
    names = [f"g_{i}_{t}" for i, k in enumerate(pat) if k == "attn"
             for t in ("ck", "cv")]
    names += [f"t_{i}_{t}" for i, k in enumerate(tail_pat) if k == "attn"
              for t in ("ck", "cv")]

    def out_order(tag, pattern):
        rec = [f"{tag}_{i}_{t}" for i, k in enumerate(pattern) if k == "rec"
               for t in ("tail", "h")]
        att = [f"{tag}_{i}_{t}" for i, k in enumerate(pattern) if k == "attn"
               for t in ("ck", "cv")]
        return rec + att  # _rg_group emits states first, then kvs

    return ModelGraphs(cfg, kind, b.finish([logits] + ys,
                                           f"{cfg.name}_decode"), b,
                       {"cache_names": names,
                        "state_out_names": out_order("g", pat)
                        + out_order("t", tail_pat)})


# =============================================================================
# xLSTM
# =============================================================================
def build_xlstm(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> ModelGraphs:
    b = ModelBuilder(cfg.param_dtype, cfg.compute_dtype)
    kind = shape.kind
    D = cfg.d_model
    H = cfg.n_heads
    proj = cfg.mlstm_proj
    dp = proj * D
    dm = dp // H  # mLSTM head dim
    ffn = max(128, int(D * 4 / 3) // 128 * 128)
    n_groups = cfg.n_layers // 2  # alternating (mLSTM, sLSTM) pairs

    specs: C.Specs = {}
    inits: Dict = {}
    specs.update(_block_norm_specs(cfg, "m_ln_"))
    inits.update(C.norm_inits("m_ln_", cfg.norm))
    specs.update(C.prefix_weights(XL.mlstm_specs(D, H, proj), "m_"))
    inits.update(XL.mlstm_inits("m_"))
    specs.update(_block_norm_specs(cfg, "s_ln_"))
    inits.update(C.norm_inits("s_ln_", cfg.norm))
    specs.update(C.prefix_weights(XL.slstm_specs(D, H, ffn), "s_"))
    inits.update(XL.slstm_inits("s_"))

    def body_train(carries, w, consts):
        h = carries[0]
        xn = C.apply_norm(h, w, "m_ln_", cfg.norm, cfg.norm_eps)
        out, _ = XL.apply_mlstm_block(b, xn, w, prefix="m_", n_heads=H,
                                      proj=proj)
        h = h + out
        xn = C.apply_norm(h, w, "s_ln_", cfg.norm, cfg.norm_eps)
        out, _ = XL.apply_slstm_block(b, xn, w, prefix="s_", n_heads=H,
                                      d_ff=ffn)
        h = h + out
        return [h], []

    if kind in ("train", "prefill"):
        S = shape.seq_len
        tokens = b.input("tokens", (batch, S))
        labels = b.input("labels", (batch, S)) if kind == "train" else None
        h = _embed(b, cfg, tokens)
        (h,), _ = b.scan_blocks("groups", n_groups, specs, body_train, [h],
                                weight_inits=inits)
        if kind == "train":
            return ModelGraphs(cfg, kind, b.finish(
                [_loss_result(b, cfg, h, labels)], f"{cfg.name}_train"), b, {})
        # prefill: recompute-from-scratch caches are the recurrent states;
        # emitting them requires the decode-form recurrence — for the
        # prefill cell we report last-token logits only (states are cheap
        # to rebuild chunkwise; see DESIGN.md).
        logits = _final_logits(b, cfg, h, last_only=True)
        return ModelGraphs(cfg, kind, b.finish([logits],
                                               f"{cfg.name}_prefill"), b,
                           {"cache_names": []})

    # decode: pure recurrent state, no KV cache at any context length
    token = b.input("token", (batch, 1))
    pos = b.input("pos", (), spec=())
    xs_extra = {
        "mC": b.input("m_C", (n_groups, batch, H, dm, dm), dtype="f32",
                      spec=(None, "batch", "heads", None, None)),
        "mn": b.input("m_n", (n_groups, batch, H, dm), dtype="f32",
                      spec=(None, "batch", "heads", None)),
        "mm": b.input("m_m", (n_groups, batch, H), dtype="f32",
                      spec=(None, "batch", None)),
        "sh": b.input("s_h", (n_groups, batch, D), dtype="f32",
                      spec=(None, "batch", None)),
        "sc": b.input("s_c", (n_groups, batch, D), dtype="f32",
                      spec=(None, "batch", None)),
        "sn": b.input("s_n", (n_groups, batch, D), dtype="f32",
                      spec=(None, "batch", None)),
        "sm": b.input("s_m", (n_groups, batch, D), dtype="f32",
                      spec=(None, "batch", None)),
    }
    h = _embed(b, cfg, token)

    def body(carries, w, consts):
        hh = carries[0]
        xn = C.apply_norm(hh, w, "m_ln_", cfg.norm, cfg.norm_eps)
        out, mst = XL.apply_mlstm_block(b, xn, w, prefix="m_", n_heads=H,
                                        proj=proj,
                                        state=(w["mC"], w["mn"], w["mm"]))
        hh = hh + out
        xn = C.apply_norm(hh, w, "s_ln_", cfg.norm, cfg.norm_eps)
        out, sst = XL.apply_slstm_block(b, xn, w, prefix="s_", n_heads=H,
                                        d_ff=ffn,
                                        state=(w["sh"], w["sc"], w["sn"],
                                               w["sm"]))
        hh = hh + out
        return [hh], list(mst) + list(sst)

    (h,), ys = b.scan_blocks("groups", n_groups, specs, body, [h],
                             xs_extra=xs_extra, n_ys=7, weight_inits=inits)
    logits = _final_logits(b, cfg, h, last_only=True)
    return ModelGraphs(cfg, kind, b.finish([logits] + list(ys),
                                           f"{cfg.name}_decode"), b,
                       {"cache_names": [],
                        "state_out_names": ["m_C", "m_n", "m_m", "s_h",
                                            "s_c", "s_n", "s_m"]})


# =============================================================================
# encoder-decoder (whisper) — conv frontend stubbed as frame embeddings
# =============================================================================
def _sinusoid(b: ModelBuilder, S: int, D: int,
              offset: Optional[Value] = None) -> Value:
    import numpy as np
    half = D // 2
    freq = ops.constant(
        np.exp(-np.arange(half, dtype=np.float64) * (math.log(10000.0) / max(half - 1, 1)))
        .astype(np.float32))
    pos = ops.iota((S,), 0, "i32")
    if offset is not None:
        pos = pos + ops.broadcast_to(offset, (S,))
    ang = ops.reshape(ops.convert(pos, "f32"), (S, 1)) * ops.reshape(freq, (1, half))
    return ops.concat([ops.sin(ang), ops.cos(ang)], axis=-1)  # (S, D)


def _whisper_dec_specs(cfg) -> Tuple[C.Specs, Dict]:
    dh = cfg.head_dim
    specs: C.Specs = {}
    specs.update(_block_norm_specs(cfg, "ln1_"))
    specs.update(C.prefix_weights(
        C.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, dh), "self_"))
    specs.update(_block_norm_specs(cfg, "lnx_"))
    specs.update(C.prefix_weights(
        C.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, dh), "cross_"))
    specs.update(_block_norm_specs(cfg, "ln2_"))
    specs.update(C.prefix_weights(C.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp),
                                  "mlp_"))
    inits = {**C.norm_inits("ln1_", cfg.norm), **C.attn_inits("self_"),
             **C.norm_inits("lnx_", cfg.norm), **C.attn_inits("cross_"),
             **C.norm_inits("ln2_", cfg.norm), **C.mlp_inits("mlp_", cfg.mlp)}
    return specs, inits


def build_encdec(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> ModelGraphs:
    b = ModelBuilder(cfg.param_dtype, cfg.compute_dtype)
    kind = shape.kind
    dh = cfg.head_dim
    D = cfg.d_model

    def encoder(frames: Value) -> Value:
        B, Se, _ = frames.shape
        pe = ops.convert(_sinusoid(b, Se, D), cfg.compute_dtype)
        h = frames + ops.broadcast_to(ops.reshape(pe, (1, Se, D)), frames.shape)
        specs: C.Specs = {}
        specs.update(_block_norm_specs(cfg, "ln1_"))
        specs.update(C.prefix_weights(
            C.attn_specs(D, cfg.n_heads, cfg.n_kv_heads, dh), "attn_"))
        specs.update(_block_norm_specs(cfg, "ln2_"))
        specs.update(C.prefix_weights(C.mlp_specs(D, cfg.d_ff, cfg.mlp),
                                      "mlp_"))
        inits = {**C.norm_inits("ln1_", cfg.norm), **C.attn_inits("attn_"),
                 **C.norm_inits("ln2_", cfg.norm),
                 **C.mlp_inits("mlp_", cfg.mlp)}

        def body(carries, w, consts):
            hh = carries[0]
            xn = C.apply_norm(hh, w, "ln1_", cfg.norm, cfg.norm_eps)
            att, _ = C.self_attention(b, xn, w, prefix="attn_",
                                      n_heads=cfg.n_heads,
                                      n_kv=cfg.n_kv_heads, d_head=dh,
                                      causal=False)
            hh = hh + att
            xn2 = C.apply_norm(hh, w, "ln2_", cfg.norm, cfg.norm_eps)
            hh = hh + C.apply_mlp(b, xn2, w, "mlp_", cfg.mlp)
            return [hh], []

        (h,), _ = b.scan_blocks("enc", cfg.n_enc_layers, specs, body, [h],
                                weight_inits=inits)
        ge = b.raw_param("enc_norm/g", (D,), (None,), ones_init())
        be = b.raw_param("enc_norm/b", (D,), (None,))
        return ops.layer_norm(h, ge, be, eps=cfg.norm_eps)

    sd, idd = _whisper_dec_specs(cfg)

    if kind in ("train", "prefill"):
        S = shape.seq_len
        frames = b.input("frames", (batch, cfg.enc_seq, D),
                         dtype=cfg.compute_dtype, spec=("batch", None, None))
        tokens = b.input("tokens", (batch, S))
        labels = b.input("labels", (batch, S)) if kind == "train" else None
        enc = encoder(frames)
        pe = ops.convert(_sinusoid(b, S, D), cfg.compute_dtype)
        h = _embed(b, cfg, tokens) + ops.broadcast_to(
            ops.reshape(pe, (1, S, D)), (batch, S, D))
        want_kv = kind == "prefill"

        def body(carries, w, consts):
            hh = carries[0]
            encv = consts[0]
            xn = C.apply_norm(hh, w, "ln1_", cfg.norm, cfg.norm_eps)
            att, ex = C.self_attention(b, xn, w, prefix="self_",
                                       n_heads=cfg.n_heads,
                                       n_kv=cfg.n_kv_heads, d_head=dh,
                                       causal=True, return_kv=want_kv)
            hh = hh + att
            xn = C.apply_norm(hh, w, "lnx_", cfg.norm, cfg.norm_eps)
            hh = hh + C.cross_attention(b, xn, encv, w, prefix="cross_",
                                        n_heads=cfg.n_heads,
                                        n_kv=cfg.n_kv_heads, d_head=dh)
            xn = C.apply_norm(hh, w, "ln2_", cfg.norm, cfg.norm_eps)
            hh = hh + C.apply_mlp(b, xn, w, "mlp_", cfg.mlp)
            return [hh], list(ex)

        (h,), ys = b.scan_blocks("dec", cfg.n_layers, sd, body, [h],
                                 consts=[enc], n_ys=2 if want_kv else 0,
                                 weight_inits=idd)
        if kind == "train":
            return ModelGraphs(cfg, kind, b.finish(
                [_loss_result(b, cfg, h, labels)], f"{cfg.name}_train"), b, {})
        logits = _final_logits(b, cfg, h, last_only=True)
        return ModelGraphs(cfg, kind, b.finish([logits] + list(ys),
                                               f"{cfg.name}_prefill"), b,
                           {"cache_names": ["cache_k", "cache_v"]})

    # decode: self cache + precomputed per-layer cross k/v caches
    Skv = _cache_len(cfg, shape)
    L = cfg.n_layers
    token = b.input("token", (batch, 1))
    pos = b.input("pos", (), spec=())
    ck = b.input("cache_k", (L, batch, cfg.n_kv_heads, Skv, dh),
                 dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    cv = b.input("cache_v", (L, batch, cfg.n_kv_heads, Skv, dh),
                 dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    xk = b.input("cross_k", (L, batch, cfg.n_kv_heads, cfg.enc_seq, dh),
                 dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    xv = b.input("cross_v", (L, batch, cfg.n_kv_heads, cfg.enc_seq, dh),
                 dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    pe = ops.convert(_sinusoid(b, 1, D, offset=pos), cfg.compute_dtype)
    h = _embed(b, cfg, token) + ops.broadcast_to(
        ops.reshape(pe, (1, 1, D)), (batch, 1, D))

    def body(carries, w, consts):
        hh = carries[0]
        xn = C.apply_norm(hh, w, "ln1_", cfg.norm, cfg.norm_eps)
        att, ex = C.self_attention(
            b, xn, w, prefix="self_", n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=dh, causal=True,
            cache_k=w["sck"], cache_v=w["scv"], pos=consts[0])
        hh = hh + att
        xn = C.apply_norm(hh, w, "lnx_", cfg.norm, cfg.norm_eps)
        # cross attention against the cached encoder projections
        q = ops.matmul(xn, b.cast(w["cross_wq"]))
        q = C.split_heads(q, cfg.n_heads)
        catt = ops.attention(q, b.cast(w["xck"]), b.cast(w["xcv"]),
                             causal=False, scale=1.0 / math.sqrt(dh))
        hh = hh + ops.matmul(C.merge_heads(catt), b.cast(w["cross_wo"]))
        xn = C.apply_norm(hh, w, "ln2_", cfg.norm, cfg.norm_eps)
        hh = hh + C.apply_mlp(b, xn, w, "mlp_", cfg.mlp)
        return [hh], list(ex)

    (h,), ys = b.scan_blocks(
        "dec", L, sd, body, [h], consts=[pos],
        xs_extra={"sck": ck, "scv": cv, "xck": xk, "xcv": xv}, n_ys=2,
        weight_inits=idd)
    logits = _final_logits(b, cfg, h, last_only=True)
    return ModelGraphs(cfg, kind, b.finish([logits] + list(ys),
                                           f"{cfg.name}_decode"), b,
                       {"cache_names": ["cache_k", "cache_v"],
                        "state_out_names": ["cache_k", "cache_v"]})


# =============================================================================
# VLM (llama-3.2-vision): self-attn stack + gated cross-attn every Nth
# =============================================================================
def _vlm_group_specs(cfg) -> Tuple[C.Specs, Dict]:
    dh = cfg.head_dim
    specs: C.Specs = {}
    inits: Dict = {}
    # gated cross block at group start
    specs.update(_block_norm_specs(cfg, "xln_"))
    specs.update(C.prefix_weights(
        C.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, dh), "x_"))
    specs["x_gate_attn"] = ((), ())
    specs["x_gate_ffn"] = ((), ())
    specs.update(_block_norm_specs(cfg, "xln2_"))
    specs.update(C.prefix_weights(C.mlp_specs(cfg.d_model, cfg.d_ff), "xmlp_"))
    inits.update(C.norm_inits("xln_"))
    inits.update(C.attn_inits("x_"))
    inits.update(C.norm_inits("xln2_"))
    inits.update(C.mlp_inits("xmlp_"))
    from .builder import zeros_init
    inits["x_gate_attn"] = zeros_init()
    inits["x_gate_ffn"] = zeros_init()
    for i in range(cfg.cross_every):
        p = f"s{i}_"
        specs.update(_block_norm_specs(cfg, f"{p}ln1_"))
        specs.update(C.prefix_weights(
            C.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, dh),
            f"{p}attn_"))
        specs.update(_block_norm_specs(cfg, f"{p}ln2_"))
        specs.update(C.prefix_weights(C.mlp_specs(cfg.d_model, cfg.d_ff),
                                      f"{p}mlp_"))
        inits.update(C.norm_inits(f"{p}ln1_"))
        inits.update(C.attn_inits(f"{p}attn_"))
        inits.update(C.norm_inits(f"{p}ln2_"))
        inits.update(C.mlp_inits(f"{p}mlp_"))
    return specs, inits


def _vlm_group(b, cfg, h, w, rope, vis, *, decode=False, pos=None,
               return_kv=False):
    dh = cfg.head_dim
    # gated cross-attention (vis: (B, T_v, D) projected vision tokens,
    # or cached (xk, xv) in decode)
    xn = C.apply_norm(h, w, "xln_", cfg.norm, cfg.norm_eps)
    if decode:
        q = C.split_heads(ops.matmul(xn, b.cast(w["x_wq"])), cfg.n_heads)
        catt = ops.attention(q, b.cast(w["vxk"]), b.cast(w["vxv"]),
                             causal=False, scale=1.0 / math.sqrt(dh))
        cat_o = ops.matmul(C.merge_heads(catt), b.cast(w["x_wo"]))
    else:
        cat_o = C.cross_attention(b, xn, vis, w, prefix="x_",
                                  n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                                  d_head=dh)
    h = h + ops.tanh(ops.convert(w["x_gate_attn"], h.dtype)) * cat_o
    xn = C.apply_norm(h, w, "xln2_", cfg.norm, cfg.norm_eps)
    h = h + ops.tanh(ops.convert(w["x_gate_ffn"], h.dtype)) * \
        C.apply_mlp(b, xn, w, "xmlp_")
    kvs: List[Value] = []
    for i in range(cfg.cross_every):
        p = f"s{i}_"
        xn = C.apply_norm(h, w, f"{p}ln1_", cfg.norm, cfg.norm_eps)
        att, ex = C.self_attention(
            b, xn, w, prefix=f"{p}attn_", n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=dh, rope=rope, causal=True,
            cache_k=w.get(f"{p}ck") if decode else None,
            cache_v=w.get(f"{p}cv") if decode else None,
            pos=pos, return_kv=return_kv)
        kvs.extend(ex)
        h = h + att
        xn = C.apply_norm(h, w, f"{p}ln2_", cfg.norm, cfg.norm_eps)
        h = h + C.apply_mlp(b, xn, w, f"{p}mlp_")
    return h, kvs


def build_vlm(cfg: ModelConfig, shape: ShapeConfig, batch: int) -> ModelGraphs:
    b = ModelBuilder(cfg.param_dtype, cfg.compute_dtype)
    kind = shape.kind
    dh = cfg.head_dim
    D = cfg.d_model
    n_groups = cfg.n_layers // cfg.cross_every
    specs, inits = _vlm_group_specs(cfg)

    def project_vision(images: Value) -> Value:
        wv = b.param("vision_proj/w", (cfg.vision_dim, D), ("embed", "embed"))
        return C.constrain(ops.matmul(images, wv), ("batch", None, None))

    if kind in ("train", "prefill"):
        S = shape.seq_len
        tokens = b.input("tokens", (batch, S))
        labels = b.input("labels", (batch, S)) if kind == "train" else None
        images = b.input("images", (batch, cfg.vision_tokens, cfg.vision_dim),
                         dtype=cfg.compute_dtype, spec=("batch", None, None))
        vis = project_vision(images)
        h = _embed(b, cfg, tokens)
        cos, sin = C.rope_tables(b, S, dh, cfg.rope_base)
        want_kv = kind == "prefill"

        def body(carries, w, consts):
            hh, kvs = _vlm_group(b, cfg, carries[0], w,
                                 (consts[0], consts[1]), consts[2],
                                 return_kv=want_kv)
            return [hh], kvs

        (h,), ys = b.scan_blocks(
            "groups", n_groups, specs, body, [h], consts=[cos, sin, vis],
            n_ys=2 * cfg.cross_every if want_kv else 0, weight_inits=inits)
        if kind == "train":
            return ModelGraphs(cfg, kind, b.finish(
                [_loss_result(b, cfg, h, labels)], f"{cfg.name}_train"), b, {})
        logits = _final_logits(b, cfg, h, last_only=True)
        names = [f"g_{i}_{t}" for i in range(cfg.cross_every)
                 for t in ("ck", "cv")]
        return ModelGraphs(cfg, kind, b.finish([logits] + list(ys),
                                               f"{cfg.name}_prefill"), b,
                           {"cache_names": names})

    # decode
    Skv = _cache_len(cfg, shape)
    token = b.input("token", (batch, 1))
    pos = b.input("pos", (), spec=())
    xs_extra: Dict[str, Value] = {}
    for i in range(cfg.cross_every):
        xs_extra[f"s{i}_ck"] = b.input(
            f"g_{i}_ck", (n_groups, batch, cfg.n_kv_heads, Skv, dh),
            dtype=cfg.compute_dtype, spec=CACHE_SPEC)
        xs_extra[f"s{i}_cv"] = b.input(
            f"g_{i}_cv", (n_groups, batch, cfg.n_kv_heads, Skv, dh),
            dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    xs_extra["vxk"] = b.input(
        "vis_k", (n_groups, batch, cfg.n_kv_heads, cfg.vision_tokens, dh),
        dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    xs_extra["vxv"] = b.input(
        "vis_v", (n_groups, batch, cfg.n_kv_heads, cfg.vision_tokens, dh),
        dtype=cfg.compute_dtype, spec=CACHE_SPEC)
    h = _embed(b, cfg, token)
    cos, sin = C.rope_tables(b, 1, dh, cfg.rope_base, offset=pos)

    def body(carries, w, consts):
        hh, kvs = _vlm_group(b, cfg, carries[0], w, (consts[0], consts[1]),
                             None, decode=True, pos=consts[2])
        return [hh], kvs

    (h,), ys = b.scan_blocks("groups", n_groups, specs, body, [h],
                             consts=[cos, sin, pos], xs_extra=xs_extra,
                             n_ys=2 * cfg.cross_every, weight_inits=inits)
    logits = _final_logits(b, cfg, h, last_only=True)
    names = [f"g_{i}_{t}" for i in range(cfg.cross_every)
             for t in ("ck", "cv")]
    return ModelGraphs(cfg, kind, b.finish([logits] + list(ys),
                                           f"{cfg.name}_decode"), b,
                       {"cache_names": names, "state_out_names": names})


# =============================================================================
# dispatch
# =============================================================================
_FAMILIES = {
    "dense": build_dense,
    "moe": build_moe,
    "mla_moe": build_mla_moe,
    "rg_hybrid": build_rg,
    "xlstm": build_xlstm,
    "encdec": build_encdec,
    "vlm": build_vlm,
}


def build_graphs(cfg: ModelConfig, shape: ShapeConfig,
                 batch: Optional[int] = None) -> ModelGraphs:
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family}")
    if shape.kind in ("serve", "serve_paged") and cfg.family != "dense":
        raise NotImplementedError(
            f"{shape.kind} (continuous-batching) graphs are only built for "
            f"the dense family so far, not {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg, shape, batch or shape.global_batch)
