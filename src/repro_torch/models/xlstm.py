"""xLSTM blocks in IR: mLSTM (matrix-memory, trained in the stabilized
parallel/quadratic form, decoded recurrently) and sLSTM (true sequential
recurrence with exponential gating, via the IR Scan op).

mLSTM parallel form (per head, stabilized as in the paper appendix):
    log_f~ = logsigmoid(f_raw);  F_i = cumsum(log_f~)
    logD_ij = F_i - F_j + i_raw_j         (j <= i, else -inf)
    m_i = max_j logD_ij
    S_ij = (q_i . k_j / sqrt(d)) * exp(logD_ij - m_i)
    h_i  = sum_j S_ij v_j / max(|sum_j S_ij|, exp(-m_i))

Decode form (O(1) state): C (dk x dv), n (dk), m scalar per head:
    m' = max(log_f~ + m, i_raw)
    C' = exp(log_f~ + m - m') C + exp(i_raw - m') k v^T
    n' = exp(log_f~ + m - m') n + exp(i_raw - m') k
    h  = (q . C') / max(|q . n'|, 1)
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from ..core import ops
from ..core.function import Function
from ..core.node import Value
from .builder import ModelBuilder, fanin_init, normal_init, zeros_init
from .components import Specs, constrain

NEG = -1e30


def logsigmoid(x: Value) -> Value:
    # -softplus(-x)
    return ops.negative(ops.log1p(ops.exp(ops.negative(x))))


# =============================================================================
# mLSTM
# =============================================================================
def mlstm_specs(d_model: int, n_heads: int, proj: int = 2) -> Specs:
    dp = proj * d_model
    return {
        "w_up": ((d_model, 2 * dp), ("embed", "ffn")),
        "wq": ((dp, dp), ("ffn", "heads")),
        "wk": ((dp, dp), ("ffn", "heads")),
        "wv": ((dp, dp), ("ffn", "heads")),
        "w_if": ((dp, 2 * n_heads), ("ffn", None)),
        "b_if": ((2 * n_heads,), (None,)),
        "w_down": ((dp, d_model), ("ffn", "embed")),
    }


def mlstm_inits(prefix: str):
    out = {f"{prefix}{k}": fanin_init()
           for k in ("w_up", "wq", "wk", "wv", "w_down")}
    out[f"{prefix}w_if"] = normal_init(0.02)
    out[f"{prefix}b_if"] = zeros_init()
    return out


def _mlstm_parallel(q: Value, k: Value, v: Value, i_raw: Value,
                    f_raw: Value) -> Value:
    """q,k,v: (B,H,S,d); i_raw,f_raw: (B,H,S) f32.  Returns (B,H,S,d)."""
    B, H, S, d = q.shape
    lf = logsigmoid(f_raw)                       # (B,H,S)
    F = ops.cumsum(lf, axis=-1)                  # inclusive cumsum
    Fi = ops.reshape(F, (B, H, S, 1))
    Fj = ops.reshape(F, (B, H, 1, S))
    ij = ops.reshape(i_raw, (B, H, 1, S))
    # logD_ij = sum_{t=j+1..i} log_f~_t + i_j = F_i - F_j + i_j
    logD = ops.broadcast_to(Fi, (B, H, S, S)) \
        - ops.broadcast_to(Fj, (B, H, S, S)) \
        + ops.broadcast_to(ij, (B, H, S, S))
    qpos = ops.iota((S, S), 0, "i32")
    kpos = ops.iota((S, S), 1, "i32")
    causal = ops.broadcast_to(ops.reshape(ops.less_equal(kpos, qpos),
                                          (1, 1, S, S)), (B, H, S, S))
    logD = ops.select(causal, logD, ops.broadcast_to(
        ops.constant(NEG, dtype="f32"), (B, H, S, S)))
    m = ops.reduce_max(logD, [-1], keepdims=True)          # (B,H,S,1)
    m = ops.maximum(m, ops.constant(0.0, dtype="f32"))     # paper: max(., 0)
    D = ops.exp(logD - ops.broadcast_to(m, logD.shape))
    D = ops.select(causal, D, ops.broadcast_to(
        ops.constant(0.0, dtype="f32"), D.shape))
    scores = ops.einsum("bhqd,bhkd->bhqk", ops.convert(q, "f32"),
                        ops.convert(k, "f32")) \
        * ops.broadcast_to(ops.constant(1.0 / math.sqrt(d), dtype="f32"),
                           (B, H, S, S))
    Smat = scores * D
    norm = ops.reduce_sum(Smat, [-1], keepdims=True)       # (B,H,S,1)
    norm = ops.maximum(ops.abs_(norm), ops.exp(ops.negative(m)))
    h = ops.einsum("bhqk,bhkd->bhqd", Smat, ops.convert(v, "f32"))
    return h / ops.broadcast_to(norm, h.shape)


def apply_mlstm_block(
    b: ModelBuilder, x: Value, w: Dict[str, Value], *, prefix: str,
    n_heads: int, proj: int = 2,
    state: Optional[Tuple[Value, Value, Value]] = None,  # (C, n, m) decode
) -> Tuple[Value, Tuple[Value, ...]]:
    """Pre-normed x (B,S,D) -> (out, new-state).  Parallel form when
    state is None, recurrent single-step otherwise."""
    B, S, D = x.shape
    dp = proj * D
    H = n_heads
    d = dp // H
    u = ops.matmul(x, b.cast(w[f"{prefix}w_up"]))      # (B,S,2dp)
    u1 = ops.slice_(u, [0, 0, 0], [B, S, dp])
    u2 = ops.slice_(u, [0, 0, dp], [B, S, 2 * dp])
    q = ops.matmul(u1, b.cast(w[f"{prefix}wq"]))
    k = ops.matmul(u1, b.cast(w[f"{prefix}wk"]))
    v = ops.matmul(u1, b.cast(w[f"{prefix}wv"]))
    q = ops.transpose(ops.reshape(q, (B, S, H, d)), (0, 2, 1, 3))
    k = ops.transpose(ops.reshape(k, (B, S, H, d)), (0, 2, 1, 3))
    v = ops.transpose(ops.reshape(v, (B, S, H, d)), (0, 2, 1, 3))
    gates = ops.convert(ops.matmul(u1, b.cast(w[f"{prefix}w_if"])), "f32") \
        + ops.broadcast_to(ops.reshape(ops.convert(w[f"{prefix}b_if"], "f32"),
                                       (1, 1, 2 * H)), (B, S, 2 * H))
    i_raw = ops.transpose(ops.slice_(gates, [0, 0, 0], [B, S, H]), (0, 2, 1))
    f_raw = ops.transpose(ops.slice_(gates, [0, 0, H], [B, S, 2 * H]), (0, 2, 1))

    extras: Tuple[Value, ...] = ()
    if state is None:
        h = _mlstm_parallel(q, k, v, i_raw, f_raw)      # (B,H,S,d) f32
    else:
        C, n, m = state  # (B,H,d,d) f32, (B,H,d) f32, (B,H) f32
        lf = ops.reshape(logsigmoid(f_raw), (B, H))
        ir = ops.reshape(i_raw, (B, H))
        m_new = ops.maximum(lf + m, ir)
        f_s = ops.exp(lf + m - m_new)
        i_s = ops.exp(ir - m_new)
        k1 = ops.convert(ops.reshape(k, (B, H, d)), "f32")
        v1 = ops.convert(ops.reshape(v, (B, H, d)), "f32")
        q1 = ops.convert(ops.reshape(q, (B, H, d)), "f32")
        kv = ops.einsum("bhk,bhv->bhkv", k1, v1)
        C_new = C * ops.broadcast_to(ops.reshape(f_s, (B, H, 1, 1)), C.shape) \
            + kv * ops.broadcast_to(ops.reshape(i_s, (B, H, 1, 1)), kv.shape)
        n_new = n * ops.broadcast_to(ops.reshape(f_s, (B, H, 1)), n.shape) \
            + k1 * ops.broadcast_to(ops.reshape(i_s, (B, H, 1)), k1.shape)
        num = ops.einsum("bhk,bhkv->bhv", q1, C_new)     # (B,H,d)
        den = ops.reduce_sum(q1 * n_new, [-1], keepdims=True)  # (B,H,1)
        den = ops.maximum(ops.abs_(den), ops.constant(1.0, dtype="f32"))
        h = ops.reshape(num / ops.broadcast_to(den, num.shape), (B, H, 1, d))
        extras = (C_new, n_new, m_new)

    hm = ops.reshape(ops.transpose(ops.convert(h, x.dtype), (0, 2, 1, 3)),
                     (B, S, dp))
    out = ops.matmul(hm * ops.silu(u2), b.cast(w[f"{prefix}w_down"]))
    return constrain(out, ("batch", None, None)), extras


# =============================================================================
# sLSTM
# =============================================================================
def slstm_specs(d_model: int, n_heads: int, d_ff: int) -> Specs:
    return {
        "w_gates": ((d_model, 4 * d_model), ("embed", "ffn")),
        "r_gates": ((n_heads, d_model // n_heads, 4 * (d_model // n_heads)),
                    ("heads", None, None)),
        "b_gates": ((4 * d_model,), (None,)),
        "w_o": ((d_model, d_model), ("embed", "embed")),
        "ffn_gate": ((d_model, d_ff), ("embed", "ffn")),
        "ffn_up": ((d_model, d_ff), ("embed", "ffn")),
        "ffn_down": ((d_ff, d_model), ("ffn", "embed")),
        "ffn_norm_g": ((d_model,), (None,)),
    }


def slstm_inits(prefix: str):
    from .builder import ones_init
    out = {f"{prefix}w_gates": normal_init(0.02),
           f"{prefix}r_gates": normal_init(0.02),
           f"{prefix}b_gates": zeros_init(),
           f"{prefix}w_o": fanin_init(),
           f"{prefix}ffn_gate": fanin_init(),
           f"{prefix}ffn_up": fanin_init(),
           f"{prefix}ffn_down": fanin_init(),
           f"{prefix}ffn_norm_g": ones_init()}
    return out


def _slstm_cell(hprev, cprev, nprev, mprev, gx, r_gates, H: int, d: int):
    """One sLSTM step.  hprev..mprev: (B, D) f32 (m: (B, D)); gx: (B, 4D)
    f32 precomputed W x_t + b.  r_gates: (H, d, 4d)."""
    B, D = hprev.shape
    h3 = ops.reshape(hprev, (B, H, d))
    gr = ops.einsum("bhd,hde->bhe", h3, ops.convert(r_gates, "f32"))  # (B,H,4d)
    g = ops.reshape(gx, (B, H, 4 * d)) + gr
    zi = ops.slice_(g, [0, 0, 0], [B, H, d])
    ii = ops.slice_(g, [0, 0, d], [B, H, 2 * d])
    fi = ops.slice_(g, [0, 0, 2 * d], [B, H, 3 * d])
    oi = ops.slice_(g, [0, 0, 3 * d], [B, H, 4 * d])
    z = ops.tanh(zi)
    o = ops.sigmoid(oi)
    m3 = ops.reshape(mprev, (B, H, d))
    logf = logsigmoid(fi)
    m_new = ops.maximum(logf + m3, ii)
    i_s = ops.exp(ii - m_new)
    f_s = ops.exp(logf + m3 - m_new)
    c3 = ops.reshape(cprev, (B, H, d))
    n3 = ops.reshape(nprev, (B, H, d))
    c_new = f_s * c3 + i_s * z
    n_new = f_s * n3 + i_s
    h_new = o * (c_new / ops.maximum(n_new, ops.constant(1e-6, dtype="f32")))
    flat = lambda t: ops.reshape(t, (B, D))
    return flat(h_new), flat(c_new), flat(n_new), flat(m_new)


def apply_slstm_block(
    b: ModelBuilder, x: Value, w: Dict[str, Value], *, prefix: str,
    n_heads: int, d_ff: int,
    state: Optional[Tuple[Value, Value, Value, Value]] = None,
) -> Tuple[Value, Tuple[Value, ...]]:
    """Pre-normed x (B,S,D).  Sequential scan over S (train) or one step
    (decode, with state = (h,c,n,m) each (B,D) f32)."""
    B, S, D = x.shape
    H = n_heads
    d = D // H
    gx_all = ops.convert(ops.matmul(x, b.cast(w[f"{prefix}w_gates"])), "f32") \
        + ops.broadcast_to(ops.reshape(
            ops.convert(w[f"{prefix}b_gates"], "f32"), (1, 1, 4 * D)),
            (B, S, 4 * D))
    r_g = w[f"{prefix}r_gates"]

    if state is not None:
        h0, c0, n0, m0 = state
        gx = ops.reshape(gx_all, (B, 4 * D))
        h, c, n, m = _slstm_cell(h0, c0, n0, m0, gx, r_g, H, d)
        hs = ops.reshape(h, (B, 1, D))
        extras = (h, c, n, m)
    else:
        # IR Scan over time
        zero = ops.broadcast_to(ops.constant(0.0, dtype="f32"), (B, D))
        gx_t = ops.transpose(gx_all, (1, 0, 2))  # (S, B, 4D)
        hp = ops.parameter((B, D), "f32", "h")
        cp = ops.parameter((B, D), "f32", "c")
        np_ = ops.parameter((B, D), "f32", "n")
        mp = ops.parameter((B, D), "f32", "m")
        gxp = ops.parameter((B, 4 * D), "f32", "gx")
        rp = ops.parameter(r_g.shape, r_g.dtype, "r")
        h_, c_, n_, m_ = _slstm_cell(hp.out(), cp.out(), np_.out(), mp.out(),
                                     gxp.out(), rp.out(), H, d)
        body = Function([hp, cp, np_, mp, gxp, rp],
                        [h_, c_, n_, m_, h_], name="slstm_cell")
        outs = ops.scan(body, [zero, zero, zero, zero], xs=[gx_t],
                        consts=[r_g], length=S)
        hs = ops.transpose(outs[4], (1, 0, 2))  # (S,B,D) -> (B,S,D)
        extras = ()

    out = ops.matmul(ops.convert(hs, x.dtype), b.cast(w[f"{prefix}w_o"]))
    out = constrain(out, ("batch", None, None))
    # post-FFN (GeGLU-ish, the paper's post-up-projection block)
    xn = ops.rms_norm(out, w[f"{prefix}ffn_norm_g"])
    g = ops.gelu(ops.matmul(xn, b.cast(w[f"{prefix}ffn_gate"])))
    u = ops.matmul(xn, b.cast(w[f"{prefix}ffn_up"]))
    out = out + ops.matmul(g * u, b.cast(w[f"{prefix}ffn_down"]))
    return constrain(out, ("batch", None, None)), extras
