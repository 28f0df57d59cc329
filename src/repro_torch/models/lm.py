"""Architecture assembly: every assigned arch as train / prefill / decode
IR graphs.

Every architecture is a *frontend program* over the same IR (nGraph's
O(frameworks + platforms) claim): a family function assembles blocks
from ``components`` into a ``Function`` via ``ModelBuilder.scan_blocks``
(stacked layer weights + the Scan op keep 80-layer graphs compact).
This copy of the reference's ``models/lm.py`` holds the dense family
only; the moe, mla_moe, rg_hybrid, xlstm, encdec and vlm builders come
with later slices of the torch port.

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
from typing import Dict, Optional, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from ..core import ops
from ..core.function import Function
from ..core.node import Value
from .builder import ModelBuilder, ones_init
from . import components as C

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


# =============================================================================
# dispatch
# =============================================================================
def build_graphs(cfg: ModelConfig, shape: ShapeConfig,
                 batch: Optional[int] = None) -> ModelGraphs:
    """Dense-family graphs only: the moe, mla_moe, rg_hybrid, xlstm,
    encdec and vlm builders are ported in a later slice."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the torch port builds dense-family graphs only so far; "
            f"{cfg.name} is {cfg.family!r} (a later slice ports it)")
    return build_dense(cfg, shape, batch or shape.global_batch)
