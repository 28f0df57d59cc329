"""Reverse-mode automatic differentiation on the IR.

Paper sec. 3: the MXNet bridge "uses autodiff on the nGraph IR for the
derivative" — derivatives are computed by constructing a derivative *graph*
from the forward graph, not by taping execution.  This module implements
that: :func:`GradBuilder.backprop` walks a forward graph in reverse
topological order and emits adjoint subgraphs per op.

``Scan`` (the structured-loop extension) differentiates by constructing a
reversed backward scan whose body is the VJP of the forward body; per-step
carry inputs are checkpointed by augmenting the forward scan, and the body
interior is recomputed in the backward sweep (the classic
checkpoint-carries policy).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import ops
from .function import Function, replace_values, topo_sort
from .node import Node, Value
from .types import TensorType, is_float

VJP: Dict[str, Callable] = {}


def _vjp(op: str):
    def deco(f):
        VJP[op] = f
        return f
    return deco


def zeros_of(t: TensorType) -> Value:
    return ops.broadcast_to(ops.constant(0, dtype=t.dtype), t.shape)


def _to_dtype(g: Optional[Value], t: TensorType) -> Optional[Value]:
    if g is None:
        return None
    return ops.convert(g, t.dtype) if g.dtype != t.dtype else g


# =============================================================================
# elementwise
# =============================================================================
@_vjp("Add")
def _(node, g):
    return [g[0], g[0]]


@_vjp("Subtract")
def _(node, g):
    return [g[0], ops.negative(g[0])]


@_vjp("Multiply")
def _(node, g):
    a, b = node.inputs
    return [g[0] * b, g[0] * a]


@_vjp("Divide")
def _(node, g):
    a, b = node.inputs
    return [g[0] / b, ops.negative(g[0] * node.out() / b)]


@_vjp("Power")
def _(node, g):
    a, b = node.inputs
    ga = g[0] * b * ops.power(a, b - ops.constant(1.0, dtype=b.dtype))
    gb = g[0] * node.out() * ops.log(a)
    return [ga, gb]


@_vjp("Maximum")
def _(node, g):
    a, b = node.inputs
    m = ops.convert(ops.greater_equal(a, b), a.dtype)
    return [g[0] * m, g[0] * (ops.constant(1.0, dtype=a.dtype) - m)]


@_vjp("Minimum")
def _(node, g):
    a, b = node.inputs
    m = ops.convert(ops.less_equal(a, b), a.dtype)
    return [g[0] * m, g[0] * (ops.constant(1.0, dtype=a.dtype) - m)]


@_vjp("Negative")
def _(node, g):
    return [ops.negative(g[0])]


@_vjp("Exp")
def _(node, g):
    return [g[0] * node.out()]


@_vjp("Expm1")
def _(node, g):
    return [g[0] * (node.out() + ops.constant(1.0, dtype=node.out().dtype))]


@_vjp("Log")
def _(node, g):
    return [g[0] / node.inputs[0]]


@_vjp("Log1p")
def _(node, g):
    x = node.inputs[0]
    return [g[0] / (x + ops.constant(1.0, dtype=x.dtype))]


@_vjp("Tanh")
def _(node, g):
    y = node.out()
    return [g[0] * (ops.constant(1.0, dtype=y.dtype) - y * y)]


@_vjp("Sigmoid")
def _(node, g):
    y = node.out()
    return [g[0] * y * (ops.constant(1.0, dtype=y.dtype) - y)]


@_vjp("Relu")
def _(node, g):
    x = node.inputs[0]
    return [g[0] * ops.convert(ops.greater(x, ops.constant(0, dtype=x.dtype)), x.dtype)]


@_vjp("Abs")
def _(node, g):
    return [g[0] * ops.sign(node.inputs[0])]


@_vjp("Sign")
def _(node, g):
    return [None]


@_vjp("Floor")
def _(node, g):
    return [None]


@_vjp("Sqrt")
def _(node, g):
    y = node.out()
    return [g[0] * ops.constant(0.5, dtype=y.dtype) / y]


@_vjp("Rsqrt")
def _(node, g):
    y = node.out()
    return [g[0] * ops.constant(-0.5, dtype=y.dtype) * y * y * y]


@_vjp("Erf")
def _(node, g):
    x = node.inputs[0]
    c = ops.constant(2.0 / math.sqrt(math.pi), dtype=x.dtype)
    return [g[0] * c * ops.exp(ops.negative(x * x))]


@_vjp("Sin")
def _(node, g):
    return [g[0] * ops.cos(node.inputs[0])]


@_vjp("Cos")
def _(node, g):
    return [ops.negative(g[0] * ops.sin(node.inputs[0]))]


@_vjp("Gelu")
def _(node, g):
    x = node.inputs[0]
    half = ops.constant(0.5, dtype=x.dtype)
    one = ops.constant(1.0, dtype=x.dtype)
    cdf = half * (one + ops.erf(x * ops.constant(1.0 / math.sqrt(2.0), dtype=x.dtype)))
    pdf = ops.constant(1.0 / math.sqrt(2.0 * math.pi), dtype=x.dtype) * ops.exp(
        ops.constant(-0.5, dtype=x.dtype) * x * x)
    return [g[0] * (cdf + x * pdf)]


@_vjp("Silu")
def _(node, g):
    x = node.inputs[0]
    s = ops.sigmoid(x)
    one = ops.constant(1.0, dtype=x.dtype)
    return [g[0] * s * (one + x * (one - s))]


@_vjp("Select")
def _(node, g):
    c, a, b = node.inputs
    za = zeros_of(a.type)
    return [None, ops.select(c, g[0], za), ops.select(c, za, g[0])]


@_vjp("Convert")
def _(node, g):
    x = node.inputs[0]
    if not is_float(x.dtype):
        return [None]
    return [ops.convert(g[0], x.dtype)]


@_vjp("StopGradient")
def _(node, g):
    return [None]


@_vjp("OptimizationBarrier")
def _(node, g):
    return [g[0]]


# =============================================================================
# shape
# =============================================================================
@_vjp("Reshape")
def _(node, g):
    return [ops.reshape(g[0], node.inputs[0].shape)]


@_vjp("Transpose")
def _(node, g):
    perm = node.attrs["perm"]
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return [ops.transpose(g[0], inv)]


@_vjp("BroadcastInDim")
def _(node, g):
    x = node.inputs[0]
    dims = node.attrs["broadcast_dims"]
    out_rank = len(node.attrs["shape"])
    grad = ops.reduce_sum(g[0], [d for d in range(out_rank) if d not in dims]) \
        if len(dims) < out_rank else g[0]
    # now grad rank == x rank, axes aligned with x axes (dims are increasing)
    shrink = [i for i, s in enumerate(x.shape)
              if s == 1 and node.attrs["shape"][dims[i]] != 1]
    if shrink:
        grad = ops.reduce_sum(grad, shrink, keepdims=True)
    return [grad]


@_vjp("Slice")
def _(node, g):
    x = node.inputs[0]
    at = node.attrs
    if any(s != 1 for s in at["strides"]):
        raise NotImplementedError("VJP of strided Slice")
    low = at["starts"]
    high = [xs - sp for xs, sp in zip(x.shape, at["stops"])]
    return [ops.pad(g[0], low, high)]


@_vjp("Concat")
def _(node, g):
    axis = node.attrs["axis"]
    grads = []
    off = 0
    for v in node.inputs:
        starts = [0] * v.rank
        stops = list(g[0].shape)
        starts[axis] = off
        stops[axis] = off + v.shape[axis]
        grads.append(ops.slice_(g[0], starts, stops))
        off += v.shape[axis]
    return grads


@_vjp("Pad")
def _(node, g):
    x = node.inputs[0]
    low = node.attrs["low"]
    starts = list(low)
    stops = [l + s for l, s in zip(low, x.shape)]
    return [ops.slice_(g[0], starts, stops)]


@_vjp("Reverse")
def _(node, g):
    return [ops.reverse(g[0], node.attrs["axes"])]


# =============================================================================
# reductions
# =============================================================================
def _unreduce(g: Value, x_shape, axes, keepdims) -> Value:
    if not keepdims:
        shape = list(g.shape)
        for a in sorted(axes):
            shape.insert(a, 1)
        g = ops.reshape(g, shape)
    return ops.broadcast_to(g, x_shape)


@_vjp("ReduceSum")
def _(node, g):
    x = node.inputs[0]
    return [_unreduce(g[0], x.shape, node.attrs["axes"], node.attrs["keepdims"])]


def _minmax_vjp(node, g):
    x = node.inputs[0]
    at = node.attrs
    out_b = _unreduce(node.out(), x.shape, at["axes"], at["keepdims"])
    g_b = _unreduce(g[0], x.shape, at["axes"], at["keepdims"])
    mask = ops.convert(ops.equal(x, out_b), x.dtype)
    return [g_b * mask]


VJP["ReduceMax"] = _minmax_vjp
VJP["ReduceMin"] = _minmax_vjp


@_vjp("CumSum")
def _(node, g):
    at = node.attrs
    ax = at["axis"]
    rg = ops.reverse(g[0], [ax])
    acc = ops.cumsum(rg, ax, exclusive=at["exclusive"])
    return [ops.reverse(acc, [ax])]


@_vjp("ArgMax")
def _(node, g):
    return [None]


@_vjp("TopK")
def _(node, g):
    x = node.inputs[0]
    if g[0] is None:
        return [None]
    idx = node.out(1)
    oh = ops.one_hot(idx, x.shape[-1], dtype=x.dtype)  # (..., k, N)
    ba = tuple(range(idx.rank - 1))
    gk = ops.expand_dims(g[0], g[0].rank)  # (..., k, 1)
    return [ops.reduce_sum(oh * ops.broadcast_to(gk, oh.shape), [idx.rank - 1])]


# =============================================================================
# contraction / indexing
# =============================================================================
def _dot_subscripts(node) -> Tuple[str, str, str]:
    a, b = node.inputs
    (lc, rc) = node.attrs["contracting"]
    (lb, rb) = node.attrs["batch"]
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    a_sub = [None] * a.rank
    b_sub = [None] * b.rank
    for dl, dr in zip(lb, rb):
        c = next(letters)
        a_sub[dl] = b_sub[dr] = c
    for dl, dr in zip(lc, rc):
        c = next(letters)
        a_sub[dl] = b_sub[dr] = c
    a_free, b_free = [], []
    for i in range(a.rank):
        if a_sub[i] is None:
            a_sub[i] = next(letters)
            a_free.append(a_sub[i])
    for i in range(b.rank):
        if b_sub[i] is None:
            b_sub[i] = next(letters)
            b_free.append(b_sub[i])
    out_sub = "".join([a_sub[d] for d in lb] + a_free + b_free)
    return "".join(a_sub), "".join(b_sub), out_sub


@_vjp("DotGeneral")
def _(node, g):
    a, b = node.inputs
    a_sub, b_sub, out_sub = _dot_subscripts(node)
    ga = ops.einsum(f"{out_sub},{b_sub}->{a_sub}", g[0], b)
    gb = ops.einsum(f"{out_sub},{a_sub}->{b_sub}", g[0], a)
    return [_to_dtype(ga, a.type), _to_dtype(gb, b.type)]


@_vjp("Gather")
def _(node, g):
    operand, indices = node.inputs
    axis = node.attrs["axis"]
    nidx = indices.rank
    if axis != 0:
        # rotate gathered block to the front
        perm = list(range(axis, axis + nidx)) + \
            [d for d in range(g[0].rank) if not (axis <= d < axis + nidx)]
        gg = ops.transpose(g[0], perm)
        op_perm = [axis] + [d for d in range(operand.rank) if d != axis]
        zero = zeros_of(TensorType([operand.shape[p] for p in op_perm], operand.dtype))
        scat = ops.scatter_add(zero, indices, gg)
        inv = [0] * operand.rank
        for i, p in enumerate(op_perm):
            inv[p] = i
        return [ops.transpose(scat, inv), None]
    zero = zeros_of(operand.type)
    return [ops.scatter_add(zero, indices, g[0]), None]


@_vjp("ScatterAdd")
def _(node, g):
    operand, indices, updates = node.inputs
    gu = ops.gather(g[0], indices, axis=0)
    return [g[0], None, _to_dtype(gu, updates.type)]


@_vjp("DynamicSlice")
def _(node, g):
    x = node.inputs[0]
    starts = list(node.inputs[1:])
    return [ops.dynamic_update_slice(zeros_of(x.type), g[0], starts)] + \
        [None] * len(starts)


@_vjp("DynamicUpdateSlice")
def _(node, g):
    x, upd = node.inputs[0], node.inputs[1]
    starts = list(node.inputs[2:])
    gx = ops.dynamic_update_slice(g[0], zeros_of(upd.type), starts)
    gu = ops.dynamic_slice(g[0], starts, upd.shape)
    return [gx, gu] + [None] * len(starts)


# =============================================================================
# compounds
# =============================================================================
@_vjp("Softmax")
def _(node, g):
    y = node.out()
    ax = node.attrs["axis"]
    dot = ops.reduce_sum(g[0] * y, [ax], keepdims=True)
    return [y * (g[0] - ops.broadcast_to(dot, y.shape))]


@_vjp("LogSoftmax")
def _(node, g):
    y = node.out()
    ax = node.attrs["axis"]
    s = ops.reduce_sum(g[0], [ax], keepdims=True)
    return [g[0] - ops.exp(y) * ops.broadcast_to(s, y.shape)]


@_vjp("RMSNorm")
def _(node, g):
    x, w = node.inputs
    eps = node.attrs["eps"]
    xf = ops.convert(x, "f32")
    gf = ops.convert(g[0], "f32")
    wf = ops.convert(w, "f32")
    var = ops.reduce_mean(xf * xf, [-1], keepdims=True)
    r = ops.rsqrt(var + ops.constant(eps, dtype="f32"))
    rb = ops.broadcast_to(r, xf.shape)
    u = gf * ops.broadcast_to(ops.reshape(wf, (1,) * (x.rank - 1) + (x.shape[-1],)),
                              xf.shape)
    mean_ux = ops.reduce_mean(u * xf, [-1], keepdims=True)
    gx = rb * (u - xf * ops.broadcast_to(r * r * mean_ux, xf.shape))
    gw = ops.reduce_sum(gf * xf * rb, list(range(x.rank - 1)))
    return [_to_dtype(gx, x.type), _to_dtype(gw, w.type)]


@_vjp("LayerNorm")
def _(node, g):
    x, w, b = node.inputs
    eps = node.attrs["eps"]
    xf = ops.convert(x, "f32")
    gf = ops.convert(g[0], "f32")
    wf = ops.convert(w, "f32")
    mu = ops.reduce_mean(xf, [-1], keepdims=True)
    xc = xf - ops.broadcast_to(mu, xf.shape)
    var = ops.reduce_mean(xc * xc, [-1], keepdims=True)
    r = ops.rsqrt(var + ops.constant(eps, dtype="f32"))
    rb = ops.broadcast_to(r, xf.shape)
    xhat = xc * rb
    u = gf * ops.broadcast_to(ops.reshape(wf, (1,) * (x.rank - 1) + (x.shape[-1],)),
                              xf.shape)
    mean_u = ops.reduce_mean(u, [-1], keepdims=True)
    mean_uxh = ops.reduce_mean(u * xhat, [-1], keepdims=True)
    gx = rb * (u - ops.broadcast_to(mean_u, xf.shape)
               - xhat * ops.broadcast_to(mean_uxh, xf.shape))
    lead = list(range(x.rank - 1))
    return [_to_dtype(gx, x.type),
            _to_dtype(ops.reduce_sum(gf * xhat, lead), w.type),
            _to_dtype(ops.reduce_sum(gf, lead), b.type)]


@_vjp("SoftmaxCrossEntropy")
def _(node, g):
    logits, labels = node.inputs
    vocab_spec = ("batch",) + (None,) * (logits.rank - 2) + ("vocab",)
    p = ops.sharding_constraint(
        ops.softmax(ops.convert(logits, "f32"), axis=-1), vocab_spec)
    oh = ops.sharding_constraint(
        ops.one_hot(labels, logits.shape[-1], dtype="f32"), vocab_spec)
    gl = (p - oh) * ops.broadcast_to(ops.expand_dims(g[0], g[0].rank), p.shape)
    return [_to_dtype(gl, logits.type), None]


# Attention VJP selection: "full" materializes the (Sq x Skv) score
# tensors (paper-faithful baseline); "chunked" is the flash-style
# backward — two KV-chunk sweeps (stats, then grads) that keep peak
# activation memory at O(Sq x chunk).  "auto" picks chunked when the
# score tensor is big.  This is a *transformer-level* optimization knob
# (EXPERIMENTS.md sec. Perf iterates it).
# threshold 8192: at S=4k the full VJP wins (chunked recompute traffic
# exceeds the saving — EXPERIMENTS.md Perf iter 2/4); at 8k+ chunked wins
ATTENTION_VJP = {"mode": "auto", "chunk": 1024, "threshold": 8192}


def set_attention_vjp(mode: str = "auto", chunk: int = 1024,
                      threshold: int = 8192) -> None:
    ATTENTION_VJP.update(mode=mode, chunk=chunk, threshold=threshold)


def _mask_for(Sq: int, bk: int, k0, q_offset, causal: bool, window):
    """(Sq, bk) validity mask; k0 = first key position (scalar i32)."""
    qpos = ops.iota((Sq, bk), 0, "i32")
    if q_offset is not None:
        qpos = qpos + ops.broadcast_to(ops.reshape(q_offset, (1, 1)), (Sq, bk))
    kpos = ops.iota((Sq, bk), 1, "i32") + ops.broadcast_to(
        ops.reshape(k0, (1, 1)), (Sq, bk))
    mask = ops.broadcast_to(ops.constant(True), (Sq, bk))
    if causal:
        mask = ops.logical_and(mask, ops.less_equal(kpos, qpos))
    if window is not None:
        mask = ops.logical_and(
            mask, ops.greater(kpos, qpos - ops.constant(int(window), dtype="i32")))
    return mask


def _attention_vjp_chunked(node, g):
    """Flash-style backward: never materializes (Sq x Skv)."""
    at = node.attrs
    q, k, v = node.inputs[:3]
    q_offset = node.inputs[3] if at["has_offset"] else None
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = Hq // Hkv
    bk = min(ATTENTION_VJP["chunk"], Skv)
    while Skv % bk:
        bk //= 2
    n = Skv // bk
    H = Hq
    scale_f = at["scale"]
    causal, window = at["causal"], at["window"]
    NEG = -1e30

    qf = ops.convert(q, "f32")
    gf = ops.convert(g[0], "f32")
    of = ops.convert(node.out(), "f32")
    kf = ops.convert(k, "f32")
    vf = ops.convert(v, "f32")
    if rep > 1:
        kf = ops.reshape(ops.broadcast_to(
            ops.reshape(kf, (B, Hkv, 1, Skv, D)), (B, Hkv, rep, Skv, D)),
            (B, H, Skv, D))
        vf = ops.reshape(ops.broadcast_to(
            ops.reshape(vf, (B, Hkv, 1, Skv, Dv)), (B, Hkv, rep, Skv, Dv)),
            (B, H, Skv, Dv))
    # chunked layouts: (n, B, H, bk, D)
    kc = ops.transpose(ops.reshape(kf, (B, H, n, bk, D)), (2, 0, 1, 3, 4))
    vc = ops.transpose(ops.reshape(vf, (B, H, n, bk, Dv)), (2, 0, 1, 3, 4))
    ids = ops.iota((n,), 0, "i32")
    D_i = ops.reduce_sum(gf * of, [-1])  # (B,H,Sq) rowsum(dO . O)

    def bhq(x):
        return ops.sharding_constraint(x, ("batch", "heads", None))

    def chunk_scores(q_p, k_p, cid_p):
        s = ops.einsum("bhqd,bhkd->bhqk", q_p, k_p) \
            * ops.broadcast_to(ops.constant(scale_f, dtype="f32"),
                               (B, H, Sq, bk))
        mask = _mask_for(Sq, bk, cid_p * ops.constant(bk, dtype="i32"),
                         q_offset_p if q_offset is not None else None,
                         causal, window)
        maskb = ops.broadcast_to(ops.reshape(mask, (1, 1, Sq, bk)), s.shape)
        return ops.select(maskb, s, ops.broadcast_to(
            ops.constant(NEG, dtype="f32"), s.shape)), maskb

    # ---- sweep 1: softmax stats (m, l) ---------------------------------
    m_p = ops.parameter((B, H, Sq), "f32", "m")
    l_p = ops.parameter((B, H, Sq), "f32", "l")
    cid_p0 = ops.parameter((), "i32", "cid")
    k_p0 = ops.parameter((B, H, bk, D), "f32", "kc")
    q_p0 = ops.parameter((B, H, Sq, D), "f32", "q")
    body1_params = [m_p, l_p, cid_p0, k_p0, q_p0]
    if q_offset is not None:
        off_p0 = ops.parameter((), "i32", "off")
        body1_params.append(off_p0)
        q_offset_p = off_p0.out()
    else:
        q_offset_p = None
    cid_p, k_pv, q_pv = cid_p0.out(), k_p0.out(), q_p0.out()
    s1, _ = chunk_scores(q_pv, k_pv, cid_p)
    m_cur = ops.reduce_max(s1, [-1])
    m_new = ops.maximum(m_p.out(), m_cur)
    m_safe = ops.select(ops.less_equal(m_new, ops.broadcast_to(
        ops.constant(NEG / 2, dtype="f32"), m_new.shape)),
        ops.broadcast_to(ops.constant(0.0, dtype="f32"), m_new.shape), m_new)
    p1 = ops.exp(s1 - ops.broadcast_to(
        ops.reshape(m_safe, (B, H, Sq, 1)), s1.shape))
    alpha = ops.exp(ops.minimum(
        m_p.out() - m_safe, ops.broadcast_to(
            ops.constant(0.0, dtype="f32"), m_new.shape)))
    l_new = alpha * l_p.out() + ops.reduce_sum(p1, [-1])
    body1 = Function(body1_params, [bhq(m_new), bhq(l_new)], name="attn_stats")

    m0 = ops.broadcast_to(ops.constant(NEG, dtype="f32"), (B, H, Sq))
    l0 = ops.broadcast_to(ops.constant(0.0, dtype="f32"), (B, H, Sq))
    consts1 = [qf] + ([q_offset] if q_offset is not None else [])
    m_fin, l_fin = ops.scan(body1, [m0, l0], xs=[ids, kc], consts=consts1,
                            length=n)
    m_fin = ops.select(ops.less_equal(m_fin, ops.broadcast_to(
        ops.constant(NEG / 2, dtype="f32"), m_fin.shape)),
        ops.broadcast_to(ops.constant(0.0, dtype="f32"), m_fin.shape), m_fin)
    l_fin = ops.maximum(l_fin, ops.broadcast_to(
        ops.constant(1e-30, dtype="f32"), l_fin.shape))

    # ---- sweep 2: dq accumulation + per-chunk dk/dv ----------------------
    dq_p = ops.parameter((B, H, Sq, D), "f32", "dq")
    cid_p0 = ops.parameter((), "i32", "cid")
    k_p0 = ops.parameter((B, H, bk, D), "f32", "kc")
    v_p0 = ops.parameter((B, H, bk, Dv), "f32", "vc")
    q_p0 = ops.parameter((B, H, Sq, D), "f32", "q")
    g_p0 = ops.parameter((B, H, Sq, Dv), "f32", "g")
    m_p0 = ops.parameter((B, H, Sq), "f32", "m")
    l_p0 = ops.parameter((B, H, Sq), "f32", "l")
    d_p0 = ops.parameter((B, H, Sq), "f32", "D")
    body2_params = [dq_p, cid_p0, k_p0, v_p0, q_p0, g_p0, m_p0, l_p0, d_p0]
    if q_offset is not None:
        off_p0 = ops.parameter((), "i32", "off")
        body2_params.append(off_p0)
        q_offset_p = off_p0.out()
    else:
        q_offset_p = None
    cid_p, k_pv, v_pv = cid_p0.out(), k_p0.out(), v_p0.out()
    s2, maskb2 = chunk_scores(q_p0.out(), k_pv, cid_p)
    p2 = ops.exp(s2 - ops.broadcast_to(ops.reshape(m_p0.out(), (B, H, Sq, 1)),
                                       s2.shape))
    p2 = p2 / ops.broadcast_to(ops.reshape(l_p0.out(), (B, H, Sq, 1)), p2.shape)
    p2 = ops.select(maskb2, p2, ops.broadcast_to(
        ops.constant(0.0, dtype="f32"), p2.shape))
    dv_j = ops.einsum("bhqk,bhqd->bhkd", p2, g_p0.out())        # (B,H,bk,Dv)
    dp = ops.einsum("bhqd,bhkd->bhqk", g_p0.out(), v_pv)
    ds = p2 * (dp - ops.broadcast_to(ops.reshape(d_p0.out(), (B, H, Sq, 1)),
                                     dp.shape)) \
        * ops.broadcast_to(ops.constant(scale_f, dtype="f32"), dp.shape)
    dq_new = dq_p.out() + ops.einsum("bhqk,bhkd->bhqd", ds, k_pv)
    dk_j = ops.einsum("bhqk,bhqd->bhkd", ds, q_p0.out())        # (B,H,bk,D)
    body2 = Function(body2_params, [dq_new, dk_j, dv_j], name="attn_bwd")

    dq0 = ops.broadcast_to(ops.constant(0.0, dtype="f32"), (B, H, Sq, D))
    consts2 = [qf, gf, m_fin, l_fin, D_i] + \
        ([q_offset] if q_offset is not None else [])
    outs = ops.scan(body2, [dq0], xs=[ids, kc, vc], consts=consts2, length=n)
    dq = outs[0]
    dk_full = ops.reshape(ops.transpose(outs[1], (1, 2, 0, 3, 4)),
                          (B, H, Skv, D))
    dv_full = ops.reshape(ops.transpose(outs[2], (1, 2, 0, 3, 4)),
                          (B, H, Skv, Dv))
    if rep > 1:
        dk = ops.reduce_sum(ops.reshape(dk_full, (B, Hkv, rep, Skv, D)), [2])
        dv = ops.reduce_sum(ops.reshape(dv_full, (B, Hkv, rep, Skv, Dv)), [2])
    else:
        dk, dv = dk_full, dv_full
    grads = [_to_dtype(dq, q.type), _to_dtype(dk, k.type),
             _to_dtype(dv, v.type)]
    if q_offset is not None:
        grads.append(None)
    return grads


@_vjp("Attention")
def _(node, g):
    at = node.attrs
    q, k, v = node.inputs[:3]
    mode = ATTENTION_VJP["mode"]
    Skv = k.shape[2]
    if mode == "chunked" or (mode == "auto" and q.shape[2] > 1
                             and Skv >= ATTENTION_VJP["threshold"]
                             and Skv % 2 == 0):
        return _attention_vjp_chunked(node, g)
    q_offset = node.inputs[3] if at["has_offset"] else None
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = Hq // Hkv

    def bhsk(x):
        """Constrain the big (B,H,Sq,Skv) intermediates so GSPMD shards
        them on batch+heads (full-head layout shards where the grouped
        (Hkv, rep) split could not)."""
        return ops.sharding_constraint(x, ("batch", "heads", None, None))

    qf = ops.convert(q, "f32")
    gf = ops.convert(g[0], "f32")
    # full-head layout: repeat k/v to Hq heads (cheap next to the S^2
    # tensors; lets the heads axis shard by TP)
    kf = ops.convert(k, "f32")
    vf = ops.convert(v, "f32")
    if rep > 1:
        kf = ops.reshape(
            ops.broadcast_to(ops.reshape(kf, (B, Hkv, 1, Skv, D)),
                             (B, Hkv, rep, Skv, D)), (B, Hq, Skv, D))
        vf = ops.reshape(
            ops.broadcast_to(ops.reshape(vf, (B, Hkv, 1, Skv, Dv)),
                             (B, Hkv, rep, Skv, Dv)), (B, Hq, Skv, Dv))
    scale = ops.constant(at["scale"], dtype="f32")
    scores = bhsk(ops.einsum("bhqd,bhkd->bhqk", qf, kf) * scale)
    qpos = ops.iota((Sq, Skv), 0, "i32")
    if q_offset is not None:
        qpos = qpos + ops.broadcast_to(ops.reshape(q_offset, (1, 1)), (Sq, Skv))
    kpos = ops.iota((Sq, Skv), 1, "i32")
    mask = ops.broadcast_to(ops.constant(True), (Sq, Skv))
    if at["causal"]:
        mask = ops.logical_and(mask, ops.less_equal(kpos, qpos))
    if at["window"] is not None:
        mask = ops.logical_and(mask, ops.greater(kpos, qpos - ops.constant(at["window"], dtype="i32")))
    maskb = ops.broadcast_to(ops.reshape(mask, (1, 1, Sq, Skv)),
                             (B, Hq, Sq, Skv))
    neg = ops.constant(-1e30, dtype="f32")
    scores = ops.select(maskb, scores, ops.broadcast_to(neg, maskb.shape))
    p = bhsk(ops.softmax(scores, axis=-1))  # (B,Hq,Sq,Skv)
    dv_full = ops.einsum("bhqk,bhqd->bhkd", p, gf)     # (B,Hq,Skv,Dv)
    dp = bhsk(ops.einsum("bhqd,bhkd->bhqk", gf, vf))
    dsum = ops.reduce_sum(dp * p, [-1], keepdims=True)
    ds = bhsk(p * (dp - ops.broadcast_to(dsum, p.shape)) * scale)
    dq = ops.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk_full = ops.einsum("bhqk,bhqd->bhkd", ds, qf)    # (B,Hq,Skv,D)
    if rep > 1:  # sum grads over the query heads sharing each kv head
        dk = ops.reduce_sum(ops.reshape(dk_full, (B, Hkv, rep, Skv, D)), [2])
        dv = ops.reduce_sum(ops.reshape(dv_full, (B, Hkv, rep, Skv, Dv)), [2])
    else:
        dk, dv = dk_full, dv_full
    grads = [_to_dtype(dq, q.type), _to_dtype(dk, k.type),
             _to_dtype(dv, v.type)]
    if q_offset is not None:
        grads.append(None)
    return grads


@_vjp("LinearRecurrence")
def _(node, g):
    a, b = node.inputs
    axis = node.attrs["axis"]
    rev = node.attrs["reverse"]
    h = node.out()
    n = a.shape[axis]

    def shift(v: Value, direction: int) -> Value:
        """direction=+1: prepend zero (h_{t-1}); -1: append zero (h_{t+1})."""
        low = [0] * v.rank
        high = [0] * v.rank
        starts = [0] * v.rank
        stops = list(v.shape)
        if direction > 0:
            low[axis] = 1
            stops[axis] = n
        else:
            high[axis] = 1
            starts[axis] = 1
            stops[axis] = n + 1
        return ops.slice_(ops.pad(v, low, high), starts, stops)

    a_shift = shift(a, -1 if not rev else +1)  # a_{t+1} (fwd) / a_{t-1} (rev)
    G = ops.linear_recurrence(a_shift, g[0], axis=axis, reverse=not rev)
    h_prev = shift(h, +1 if not rev else -1)   # h_{t-1} (fwd) / h_{t+1} (rev)
    return [G * h_prev, G]


# =============================================================================
# collectives
# =============================================================================
@_vjp("AllReduce")
def _(node, g):
    return [ops.all_reduce(g[0], node.attrs["axis_name"], node.attrs["reduce_op"])]


@_vjp("AllGather")
def _(node, g):
    at = node.attrs
    return [ops.reduce_scatter(g[0], at["axis_name"], at["axis"], at["axis_size"])]


@_vjp("ReduceScatter")
def _(node, g):
    at = node.attrs
    return [ops.all_gather(g[0], at["axis_name"], at["axis"], at["axis_size"])]


@_vjp("AllToAll")
def _(node, g):
    at = node.attrs
    return [ops.all_to_all(g[0], at["axis_name"], at["concat_axis"],
                           at["split_axis"], at["axis_size"])]


@_vjp("CollectivePermute")
def _(node, g):
    inv = [(d, s) for (s, d) in node.attrs["pairs"]]
    return [ops.collective_permute(g[0], node.attrs["axis_name"], inv)]


@_vjp("ShardingConstraint")
def _(node, g):
    return [ops.sharding_constraint(g[0], node.attrs["spec"])]


# =============================================================================
# Scan
# =============================================================================
def build_vjp_function(fn: Function, name: Optional[str] = None) -> Function:
    """VJP of a Function: params = fn params + cotangents of fn results;
    results = grads of every fn param (zeros where undefined)."""
    cot_params = [ops.parameter(t.shape, t.dtype, f"ct_{i}")
                  for i, t in enumerate(fn.out_types)]
    gb = GradBuilder()
    grads = gb.backprop(fn.results, [p.out() for p in cot_params],
                        [p.out() for p in fn.parameters])
    results = [gr if gr is not None else zeros_of(p.out_types[0])
               for gr, p in zip(grads, fn.parameters)]
    out = Function(fn.parameters + cot_params, results,
                   name or f"{fn.name}_vjp")
    return gb.apply_replacements(out)


def _scan_vjp(gb: "GradBuilder", node: Node, out_grads) -> List[Optional[Value]]:
    at = node.attrs
    body: Function = at["body"]
    nc, nx = at["n_carry"], at["n_xs"]
    nw = len(node.inputs) - nc - nx
    n_y = len(node.out_types) - nc
    L = at["length"]

    # 1. augmented forward: also emit per-step carry-ins as ys.  The
    # barrier stops XLA from sinking downstream f32 converts into the ys
    # accumulation (which would store the whole residual stack in f32).
    aug_body = Function(body.parameters,
                        list(body.results)
                        + [ops.optimization_barrier(p.out())
                           for p in body.parameters[:nc]],
                        name=f"{body.name}_aug")
    aug = Node("Scan", node.inputs,
               {**at, "body": aug_body},
               list(node.out_types) + [
                   body.parameters[i].out_types[0].with_shape(
                       (L,) + body.parameters[i].out_types[0].shape)
                   for i in range(nc)],
               name=f"{node.name}_aug")
    for i in range(len(node.out_types)):
        gb.replacements[node.out(i)] = aug.out(i)
    stacked_cins = [aug.out(len(node.out_types) + i) for i in range(nc)]

    # 2. per-step VJP of the body
    body_vjp = build_vjp_function(body)
    # body_vjp params: [c(nc), x(nx), w(nw), dc'(nc), dy(n_y)]
    # body_vjp results: [dc(nc), dx(nx), dw(nw)]

    # 3. backward scan body: carries = (dc, dw_acc); xs = (c_in, x, dy); consts = w
    bp: List[Node] = []
    dc_par = [ops.parameter(t.shape, t.dtype, f"dc{i}")
              for i, t in enumerate(body.out_types[:nc])]
    dw_par = [ops.parameter(node.inputs[nc + nx + i].shape,
                            node.inputs[nc + nx + i].dtype, f"dwacc{i}")
              for i in range(nw)]
    cin_par = [ops.parameter(body.in_types[i].shape, body.in_types[i].dtype, f"cin{i}")
               for i in range(nc)]
    x_par = [ops.parameter(body.in_types[nc + i].shape, body.in_types[nc + i].dtype,
                           f"x{i}") for i in range(nx)]
    dy_par = [ops.parameter(body.out_types[nc + i].shape, body.out_types[nc + i].dtype,
                            f"dy{i}") for i in range(n_y)]
    w_par = [ops.parameter(node.inputs[nc + nx + i].shape,
                           node.inputs[nc + nx + i].dtype, f"w{i}")
             for i in range(nw)]

    # inline body_vjp by rebuilding it on these params.  The residual
    # (carry-in) slices get an optimization barrier: without it XLA
    # hoists the body's f32 converts of the slice out of the loop and
    # materializes an f32 copy of the entire (L, ...) residual stack.
    sub = {}
    vjp_params = body_vjp.parameters
    bind = ([ops.optimization_barrier(p.out()) for p in cin_par]
            + [p.out() for p in x_par]
            + [p.out() for p in w_par] + [p.out() for p in dc_par]
            + [p.out() for p in dy_par])
    for bp_param, v in zip(vjp_params, bind):
        sub[id(bp_param)] = [v]
    env: Dict[int, List[Value]] = dict(sub)
    for n2 in body_vjp.nodes():
        if n2.op == "Parameter":
            continue
        new_inputs = [env[id(v.node)][v.index] if id(v.node) in env else v
                      for v in n2.inputs]
        clone = Node(n2.op, new_inputs, dict(n2.attrs), n2.out_types)
        env[id(n2)] = [clone.out(i) for i in range(clone.n_outputs)]

    def res(v: Value) -> Value:
        return env[id(v.node)][v.index] if id(v.node) in env else v

    vjp_res = [res(r) for r in body_vjp.results]
    dc_new = vjp_res[:nc]
    dx_new = vjp_res[nc:nc + nx]
    dw_new = [dw_par[i].out() + _to_dtype(vjp_res[nc + nx + i], dw_par[i].out_types[0])
              for i in range(nw)]
    bwd_body = Function(dc_par + dw_par + cin_par + x_par + dy_par + w_par,
                        dc_new + dw_new + dx_new, name=f"{body.name}_bwd")

    # 4. backward scan node
    dc_init = [out_grads[i] if out_grads[i] is not None else zeros_of(node.out_types[i])
               for i in range(nc)]
    dw_init = [zeros_of(node.inputs[nc + nx + i].type) for i in range(nw)]
    dy_stk = [out_grads[nc + i] if out_grads[nc + i] is not None
              else zeros_of(node.out_types[nc + i]) for i in range(n_y)]
    xs_orig = [node.inputs[nc + i] for i in range(nx)]
    w_vals = [node.inputs[nc + nx + i] for i in range(nw)]
    bwd_outs = ops.scan(bwd_body, dc_init + dw_init,
                        xs=stacked_cins + xs_orig + dy_stk,
                        consts=w_vals, length=L,
                        reverse=not at["reverse"], unroll=at.get("unroll", 1))
    d_carry_init = bwd_outs[:nc]
    d_w = bwd_outs[nc:nc + nw]
    d_xs = bwd_outs[nc + nw:]
    return list(d_carry_init) + list(d_xs) + list(d_w)


# =============================================================================
# driver
# =============================================================================
class GradBuilder:
    """Reverse-mode sweep over a fixed forward graph.

    ``replacements`` maps forward values that must be swapped in the final
    Function (Scan nodes get residual-augmented clones); apply with
    :meth:`apply_replacements` after assembling the Function.
    """

    def __init__(self):
        self.replacements: Dict[Value, Value] = {}

    def backprop(
        self,
        outputs: Sequence[Value],
        seeds: Sequence[Optional[Value]],
        wrt: Sequence[Value],
    ) -> List[Optional[Value]]:
        adj: Dict[Tuple[int, int], Value] = {}

        def add_adj(v: Value, g: Optional[Value]):
            if g is None:
                return
            g = _to_dtype(g, v.type)
            key = (id(v.node), v.index)
            adj[key] = g if key not in adj else adj[key] + g

        for out, seed in zip(outputs, seeds):
            add_adj(out, seed)

        order = topo_sort(list(outputs))
        wrt_ids = {(id(v.node), v.index) for v in wrt}
        for node in reversed(order):
            gs = [adj.get((id(node), i)) for i in range(node.n_outputs)]
            if all(g is None for g in gs):
                continue
            if node.op in ("Parameter", "Constant", "Iota"):
                continue
            if node.op == "Scan":
                in_grads = _scan_vjp(self, node, gs)
            elif node.op in VJP:
                rule = VJP[node.op]
                # rules take the primary adjoint list
                in_grads = rule(node, gs)
            else:
                raise NotImplementedError(f"no VJP for op {node.op}")
            if len(in_grads) != len(node.inputs):
                raise RuntimeError(
                    f"VJP of {node.op} returned {len(in_grads)} grads for "
                    f"{len(node.inputs)} inputs")
            for v, g in zip(node.inputs, in_grads):
                add_adj(v, g)
        return [adj.get((id(v.node), v.index)) for v in wrt]

    def apply_replacements(self, fn: Function) -> Function:
        if not self.replacements:
            return fn
        return replace_values(fn, self.replacements)


def grad(
    fn: Function,
    loss_index: int = 0,
    wrt: Optional[Sequence[int]] = None,
    keep_outputs: bool = True,
) -> Function:
    """Build a gradient Function: (params) -> (outputs..., grads...).

    ``wrt`` selects parameter indices (default: all).  Grads that are
    identically zero come back as zero constants.
    """
    loss = fn.results[loss_index]
    if loss.shape != ():
        raise ValueError("grad: loss must be a scalar result")
    wrt = list(wrt) if wrt is not None else list(range(len(fn.parameters)))
    wrt_vals = [fn.parameters[i].out() for i in wrt]
    gb = GradBuilder()
    seed = ops.constant(1.0, dtype=loss.dtype)
    grads = gb.backprop([loss], [seed], wrt_vals)
    grads = [g if g is not None else zeros_of(v.type)
             for g, v in zip(grads, wrt_vals)]
    results = (list(fn.results) if keep_outputs else [fn.results[loss_index]]) + grads
    out = Function(fn.parameters, results, name=f"{fn.name}_grad")
    return gb.apply_replacements(out)
