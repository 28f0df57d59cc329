"""RecurrentGemma / Griffin-style recurrent blocks in IR.

The RG-LRU is a gated *linear* recurrence — it lowers through the IR
``LinearRecurrence`` op, which the torch emitter realizes as a log-depth
doubling scan (the reference's JAX transformer as
``lax.associative_scan``) and the interpreter as a sequential loop.  The short depthwise conv is expressed as shifted
slices (width is 4).  Decode threads (h, conv-tail) state instead of a
KV cache — this is what makes the 500k-token cell O(1) per step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from ..core import ops
from ..core.node import Value
from .builder import ModelBuilder, fanin_init, normal_init, zeros_init
from .components import Specs, constrain

RG_C = 8.0  # the fixed `c` exponent scale from the Griffin paper


def softplus(x: Value) -> Value:
    return ops.log1p(ops.exp(x))


RG_BLOCKS = 16  # block-diagonal gate heads (Griffin: block_width = lru/heads)


def rg_specs(d_model: int, lru_width: int, conv_width: int) -> Specs:
    lw = lru_width
    bw = lw // RG_BLOCKS if lw % RG_BLOCKS == 0 else lw
    nb = lw // bw
    return {
        "w_gate": ((d_model, lw), ("embed", "ffn")),
        "w_x": ((d_model, lw), ("embed", "ffn")),
        "conv_w": ((conv_width, lw), (None, "ffn")),
        "conv_b": ((lw,), ("ffn",)),
        # block-diagonal recurrence gates (paper-faithful): blocks shard
        # on the model axis, so the r/i gate matmuls are TP-local — no
        # per-layer all-reduce of the (B,S,lru) activations
        "w_a": ((nb, bw, bw), ("heads", None, None)),
        "w_i": ((nb, bw, bw), ("heads", None, None)),
        "lam": ((lw,), ("ffn",)),
        "w_out": ((lw, d_model), ("ffn", "embed")),
    }


def rg_inits(prefix: str):
    return {
        f"{prefix}w_gate": fanin_init(), f"{prefix}w_x": fanin_init(),
        f"{prefix}conv_w": normal_init(0.1), f"{prefix}conv_b": zeros_init(),
        f"{prefix}w_a": normal_init(0.02), f"{prefix}w_i": normal_init(0.02),
        f"{prefix}lam": normal_init(0.5), f"{prefix}w_out": fanin_init(),
    }


def _conv1d(u: Value, w_conv: Value, b_conv: Value,
            tail: Optional[Value] = None) -> Tuple[Value, Value]:
    """Depthwise causal conv along S.  u: (B, S, C); w: (cw, C).
    ``tail``: (B, cw-1, C) decode state (the previous cw-1 inputs).
    Returns (out (B,S,C), new_tail)."""
    B, S, C = u.shape
    cw = w_conv.shape[0]
    if tail is None:
        full = ops.pad(u, [0, cw - 1, 0], [0, 0, 0])  # left-pad time
    else:
        full = ops.concat([ops.convert(tail, u.dtype), u], axis=1)
    parts = []
    for i in range(cw):
        sl = ops.slice_(full, [0, i, 0], [B, i + S, C])
        wi = ops.reshape(ops.slice_(w_conv, [i, 0], [i + 1, C]), (1, 1, C))
        parts.append(sl * ops.convert(ops.broadcast_to(wi, sl.shape), sl.dtype))
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    out = out + ops.convert(ops.broadcast_to(
        ops.reshape(b_conv, (1, 1, C)), out.shape), out.dtype)
    new_tail = ops.slice_(full, [0, S, 0], [B, S + cw - 1, C])
    return out, new_tail


def rg_lru(u: Value, w: Dict[str, Value], prefix: str, b: ModelBuilder,
           h_state: Optional[Value] = None) -> Tuple[Value, Optional[Value]]:
    """The RG-LRU over u (B, S, C) in f32:
        r = sigmoid(u @ W_a); i = sigmoid(u @ W_i)
        log_a = -c * softplus(Lambda) * r;  a = exp(log_a)
        h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)
    ``h_state``: (B, 1, C) decode carry (returns the new one)."""
    uf = ops.convert(u, "f32")
    Bc, Sc, Cw = uf.shape
    nb, bw = w[f"{prefix}w_a"].shape[0], w[f"{prefix}w_a"].shape[1]
    ub = ops.reshape(uf, (Bc, Sc, nb, bw))

    def gate(wname):
        wb = ops.convert(w[f"{prefix}{wname}"], "f32")  # (nb, bw, bw)
        return ops.sigmoid(ops.reshape(
            ops.einsum("bshd,hde->bshe", ub, wb), (Bc, Sc, Cw)))

    r = gate("w_a")
    i = gate("w_i")
    lam = softplus(ops.convert(w[f"{prefix}lam"], "f32"))
    lam = ops.broadcast_to(ops.reshape(lam, (1, 1, u.shape[-1])), uf.shape)
    log_a = ops.constant(-RG_C, dtype="f32") * lam * r
    a = ops.exp(log_a)
    one = ops.constant(1.0, dtype="f32")
    gate_in = ops.sqrt(ops.maximum(one - a * a, ops.constant(1e-9, dtype="f32"))) \
        * (i * uf)
    if h_state is None:
        h = ops.linear_recurrence(a, gate_in, axis=-2)
        return ops.convert(h, u.dtype), None
    h = a * ops.convert(h_state, "f32") + gate_in  # single decode step
    return ops.convert(h, u.dtype), h


def apply_rg_block(
    b: ModelBuilder, x: Value, w: Dict[str, Value], *, prefix: str,
    conv_tail: Optional[Value] = None, h_state: Optional[Value] = None,
    decode: bool = False,
) -> Tuple[Value, Tuple[Value, ...]]:
    """The Griffin recurrent temporal-mixing block (post-norm input x).
    Returns (out (B,S,D), extra-state tuple in decode)."""
    gate = ops.gelu(ops.matmul(x, b.cast(w[f"{prefix}w_gate"])))
    u = ops.matmul(x, b.cast(w[f"{prefix}w_x"]))
    u, new_tail = _conv1d(u, w[f"{prefix}conv_w"], w[f"{prefix}conv_b"],
                          tail=conv_tail if decode else None)
    h, new_h = rg_lru(u, w, prefix, b, h_state=h_state if decode else None)
    out = ops.matmul(gate * h, b.cast(w[f"{prefix}w_out"]))
    out = constrain(out, ("batch", None, None))
    if decode:
        return out, (new_tail, new_h)  # new_h stays f32 (recurrent state)
    return out, ()
