"""Mixture-of-Experts layers in IR: GShard-style capacity-based token
dispatch (top-k router -> scatter into per-expert buffers -> batched
expert FFN -> weighted combine), plus the DeepSeek-V3 variant (shared
expert + many small routed experts).

All of it is nGraph IR — TopK / CumSum / ScatterAdd / Gather / DotGeneral
— so the same graph runs on the interpreter and compiles through the JAX
transformer, where the ("experts",) sharding constraints let GSPMD place
expert-parallel all-to-alls.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from ..core import ops
from ..core.node import Value
from .builder import ModelBuilder, fanin_init, normal_init
from .components import Specs, constrain


def moe_specs(d_model: int, n_experts: int, expert_d_ff: int,
              n_shared: int = 0, shared_d_ff: int = 0) -> Specs:
    specs: Specs = {
        "router": ((d_model, n_experts), ("embed", None)),
        "we_gate": ((n_experts, d_model, expert_d_ff),
                    ("experts", "embed", "expert_ffn")),
        "we_up": ((n_experts, d_model, expert_d_ff),
                  ("experts", "embed", "expert_ffn")),
        "we_down": ((n_experts, expert_d_ff, d_model),
                    ("experts", "expert_ffn", "embed")),
    }
    if n_shared:
        sd = shared_d_ff or expert_d_ff
        specs.update({
            "ws_gate": ((d_model, n_shared * sd), ("embed", "ffn")),
            "ws_up": ((d_model, n_shared * sd), ("embed", "ffn")),
            "ws_down": ((n_shared * sd, d_model), ("ffn", "embed")),
        })
    return specs


def moe_inits(prefix: str, n_shared: int = 0):
    out = {f"{prefix}router": normal_init(0.02)}
    for k in ("we_gate", "we_up", "we_down"):
        out[f"{prefix}{k}"] = fanin_init()
    if n_shared:
        for k in ("ws_gate", "ws_up", "ws_down"):
            out[f"{prefix}{k}"] = fanin_init()
    return out


def capacity_for(n_tokens: int, top_k: int, n_experts: int,
                 factor: float) -> int:
    c = math.ceil(n_tokens * top_k / n_experts * factor)
    return max(8, (c + 7) // 8 * 8)


def apply_moe(
    b: ModelBuilder,
    x: Value,  # (B, S, D) compute dtype
    w: Dict[str, Value],
    *,
    prefix: str = "moe_",
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
) -> Tuple[Value, Value]:
    """Returns (out (B,S,D), aux_loss scalar f32)."""
    B, S, D = x.shape
    T = B * S
    E, K = n_experts, top_k
    C = capacity_for(T, K, E, capacity_factor)

    xt = ops.reshape(x, (T, D))
    xt = constrain(xt, ("batch", None))

    # -- router (f32 math) -----------------------------------------------
    logits = ops.matmul(ops.convert(xt, "f32"), ops.convert(w[f"{prefix}router"], "f32"))
    probs = ops.softmax(logits, axis=-1)                       # (T, E)
    pk, idx = ops.top_k(probs, K)                               # (T, K)
    denom = ops.reduce_sum(pk, [-1], keepdims=True)
    pk = pk / ops.broadcast_to(denom + ops.constant(1e-9, dtype="f32"), pk.shape)

    # -- load-balancing aux loss (Switch/GShard form) -----------------------
    # fraction of tokens whose top-1 is e  *  mean router prob of e
    top1 = ops.slice_(idx, [0, 0], [T, 1])                      # (T, 1)
    top1_oh = ops.one_hot(ops.reshape(top1, (T,)), E, dtype="f32")  # (T, E)
    frac = ops.reduce_mean(top1_oh, [0])                        # (E,)
    mean_p = ops.reduce_mean(probs, [0])                        # (E,)
    aux = ops.reduce_sum(frac * mean_p) * ops.constant(float(E), dtype="f32")

    # -- dispatch positions: running count per expert in assignment order --
    idx_f = ops.reshape(idx, (T * K,))                          # (TK,)
    a_oh = constrain(ops.one_hot(idx_f, E, dtype="f32"), ("batch", None))
    pos_in_e = ops.cumsum(a_oh, axis=0, exclusive=True)         # (TK, E)
    pos_a = ops.reduce_sum(pos_in_e * a_oh, [-1])               # (TK,)
    pos_a = ops.convert(pos_a, "i32")
    keep = ops.less(pos_a, ops.broadcast_to(ops.constant(C, dtype="i32"),
                                            pos_a.shape))       # (TK,) bool
    pos_c = ops.minimum(pos_a, ops.constant(C - 1, dtype="i32"))
    slot = idx_f * ops.broadcast_to(ops.constant(C, dtype="i32"), idx_f.shape) + pos_c

    # -- scatter tokens into (E*C, D) expert buffers -------------------------
    # assignment a = (token t, choice k) reads token t: that is a
    # broadcast over K, not a gather (a gather by iota defeats GSPMD's
    # sharding propagation and replicates the (TK, D) tensor).
    # NOTE (EXPERIMENTS.md sec. Perf iter 6, refuted): splitting this
    # into K chained (T, D) scatters made peak memory WORSE — each
    # chained scatter's VJP materializes its own (E*C, D) zero buffer.
    gathered = ops.reshape(
        ops.broadcast_to(ops.reshape(xt, (T, 1, D)), (T, K, D)), (T * K, D))
    gathered = constrain(gathered, ("batch", None))
    keep_f = ops.convert(keep, x.dtype)
    upd = gathered * ops.broadcast_to(ops.reshape(keep_f, (T * K, 1)),
                                      gathered.shape)
    upd = constrain(upd, ("batch", None))
    buf = ops.scatter_add(
        ops.broadcast_to(ops.constant(0.0, dtype=x.dtype), (E * C, D)),
        slot, upd)
    buf = constrain(ops.reshape(buf, (E, C, D)), ("experts", None, None))

    # -- expert FFN (batched over E) ---------------------------------------
    g = ops.silu(ops.einsum("ecd,edf->ecf", buf, b.cast(w[f"{prefix}we_gate"])))
    u = ops.einsum("ecd,edf->ecf", buf, b.cast(w[f"{prefix}we_up"]))
    h = constrain(g * u, ("experts", None, "expert_ffn"))
    eout = ops.einsum("ecf,efd->ecd", h, b.cast(w[f"{prefix}we_down"]))
    eout = constrain(eout, ("experts", None, None))

    # -- combine -----------------------------------------------------------------
    back = ops.gather(ops.reshape(eout, (E * C, D)), slot, axis=0)  # (TK, D)
    back = constrain(back, ("batch", None))
    wgt = ops.convert(ops.reshape(pk, (T * K,)), x.dtype) * keep_f   # (TK,)
    back = back * ops.broadcast_to(ops.reshape(wgt, (T * K, 1)), back.shape)
    comb = ops.reduce_sum(ops.reshape(back, (T, K, D)), [1])         # (T, D)
    out = constrain(ops.reshape(comb, (B, S, D)), ("batch", None, None))
    return out, aux


def apply_shared_expert(b: ModelBuilder, x: Value, w: Dict[str, Value],
                        prefix: str = "moe_") -> Value:
    g = ops.silu(ops.matmul(x, b.cast(w[f"{prefix}ws_gate"])))
    u = ops.matmul(x, b.cast(w[f"{prefix}ws_up"]))
    return ops.matmul(g * u, b.cast(w[f"{prefix}ws_down"]))
