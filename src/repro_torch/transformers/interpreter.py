"""Interpreter transformer: a pure-numpy reference executor for the IR.

This is the second backend (alongside the JAX/XLA transformer), playing the
role the paper's "fall back" interpreter/CPU path plays: every Function can
run here with no JAX at all, which is what makes cross-backend tests
meaningful.  It can also execute inside a planned memory arena to validate
the memory-management pass (see ``passes/memory.py``).

Collectives are interpreted under the "identical shards" convention: the
interpreter models one device of an SPMD group whose peers hold the same
data (sum-AllReduce multiplies by group size, AllGather tiles, ...).  True
multi-device semantics are exercised through the JAX backend under
``shard_map`` in tests.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.function import Function
from ..core.node import Node
from ..core.types import as_dtype, is_float

_erf = np.vectorize(math.erf, otypes=[np.float64])

EVAL: Dict[str, Callable] = {}


def _ev(op: str):
    def deco(f):
        EVAL[op] = f
        return f
    return deco


def _f32(x: np.ndarray) -> np.ndarray:
    """Upcast sub-f32 floats so numpy ufuncs work (bf16 etc.)."""
    if is_float(x.dtype) and x.dtype.itemsize < 4:
        return x.astype(np.float32)
    return x


def _out(node: Node, x, i: int = 0) -> np.ndarray:
    t = node.out_types[i]
    arr = np.asarray(x)
    if arr.dtype != t.dtype:
        arr = arr.astype(t.dtype)
    if arr.shape != t.shape:
        raise RuntimeError(f"{node.op}: produced {arr.shape}, typed {t.shape}")
    return arr


# -- leaf ops ---------------------------------------------------------------
@_ev("Constant")
def _(node, args):
    return [node.attrs["value"]]


@_ev("Iota")
def _(node, args):
    t = node.out_types[0]
    n = t.shape[node.attrs["dim"]]
    arr = np.arange(n, dtype=t.dtype)
    shape = [1] * len(t.shape)
    shape[node.attrs["dim"]] = n
    return [np.broadcast_to(arr.reshape(shape), t.shape)]


# -- elementwise --------------------------------------------------------------
_UNARY_FN = {
    "Negative": lambda x: -x,
    "Exp": np.exp, "Log": np.log, "Log1p": np.log1p, "Expm1": np.expm1,
    "Tanh": np.tanh,
    "Sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "Relu": lambda x: np.maximum(x, 0),
    "Abs": np.abs, "Sign": np.sign,
    "Sqrt": np.sqrt, "Rsqrt": lambda x: 1.0 / np.sqrt(x),
    "Erf": lambda x: _erf(x).astype(np.float32),
    "Sin": np.sin, "Cos": np.cos, "Floor": np.floor,
    "Gelu": lambda x: 0.5 * x * (1.0 + _erf(x / np.sqrt(2.0)).astype(np.float32)),
    "Silu": lambda x: x / (1.0 + np.exp(-x)),
}
for _opname, _fn in _UNARY_FN.items():
    def _mk(fn):
        def run(node, args):
            return [_out(node, fn(_f32(args[0])))]
        return run
    EVAL[_opname] = _mk(_fn)

_BINARY_FN = {
    "Add": np.add, "Subtract": np.subtract, "Multiply": np.multiply,
    "Divide": lambda a, b: np.divide(a, b) if is_float(np.asarray(a).dtype)
    else np.floor_divide(a, b),
    "Power": np.power, "Maximum": np.maximum, "Minimum": np.minimum,
    "Less": np.less, "LessEqual": np.less_equal, "Greater": np.greater,
    "GreaterEqual": np.greater_equal, "Equal": np.equal, "NotEqual": np.not_equal,
    "And": np.logical_and, "Or": np.logical_or,
}
for _opname, _fn in _BINARY_FN.items():
    def _mk2(fn):
        def run(node, args):
            return [_out(node, fn(_f32(args[0]), _f32(args[1])))]
        return run
    EVAL[_opname] = _mk2(_fn)


@_ev("Not")
def _(node, args):
    return [np.logical_not(args[0])]


@_ev("Select")
def _(node, args):
    return [_out(node, np.where(args[0], args[1], args[2]))]


@_ev("Convert")
def _(node, args):
    return [args[0].astype(node.attrs["dtype"])]


@_ev("StopGradient")
def _(node, args):
    return [args[0]]


@_ev("OptimizationBarrier")
def _(node, args):
    return [args[0]]


@_ev("ShardingConstraint")
def _(node, args):
    return [args[0]]


# -- shape ---------------------------------------------------------------
@_ev("Reshape")
def _(node, args):
    return [args[0].reshape(node.attrs["shape"])]


@_ev("Transpose")
def _(node, args):
    return [np.transpose(args[0], node.attrs["perm"])]


@_ev("BroadcastInDim")
def _(node, args):
    shape = node.attrs["shape"]
    dims = node.attrs["broadcast_dims"]
    inter = [1] * len(shape)
    for i, d in enumerate(dims):
        inter[d] = args[0].shape[i]
    return [np.broadcast_to(args[0].reshape(inter), shape)]


@_ev("Slice")
def _(node, args):
    sl = tuple(
        slice(st, sp, sd)
        for st, sp, sd in zip(node.attrs["starts"], node.attrs["stops"],
                              node.attrs["strides"])
    )
    return [args[0][sl]]


@_ev("Concat")
def _(node, args):
    return [np.concatenate(args, axis=node.attrs["axis"])]


@_ev("Pad")
def _(node, args):
    widths = list(zip(node.attrs["low"], node.attrs["high"]))
    return [np.pad(args[0], widths, constant_values=node.attrs["value"])]


@_ev("Reverse")
def _(node, args):
    return [np.flip(args[0], axis=node.attrs["axes"])]


# -- reductions ------------------------------------------------------------
def _reduce_eval(fn):
    def run(node, args):
        x = _f32(args[0])
        out = fn(x, axis=node.attrs["axes"], keepdims=node.attrs["keepdims"])
        return [_out(node, out)]
    return run


EVAL["ReduceSum"] = _reduce_eval(np.sum)
EVAL["ReduceMax"] = _reduce_eval(np.max)
EVAL["ReduceMin"] = _reduce_eval(np.min)


@_ev("CumSum")
def _(node, args):
    x = _f32(args[0])
    axis = node.attrs["axis"]
    out = np.cumsum(x, axis=axis)
    if node.attrs["exclusive"]:
        out = np.roll(out, 1, axis=axis)
        idx = [slice(None)] * out.ndim
        idx[axis] = 0
        out[tuple(idx)] = 0
    return [_out(node, out)]


@_ev("ArgMax")
def _(node, args):
    return [np.argmax(args[0], axis=node.attrs["axis"]).astype(np.int32)]


@_ev("TopK")
def _(node, args):
    x, k = args[0], node.attrs["k"]
    idx = np.argsort(-_f32(x), axis=-1, kind="stable")[..., :k]
    vals = np.take_along_axis(x, idx, axis=-1)
    return [_out(node, vals, 0), idx.astype(np.int32)]


# -- contraction ------------------------------------------------------------
@_ev("DotGeneral")
def _(node, args):
    a, b = _f32(args[0]), _f32(args[1])
    (lc, rc) = node.attrs["contracting"]
    (lb, rb) = node.attrs["batch"]
    letters = "abcdefghijklmnopqrstuvwxyz"
    it = iter(letters)
    a_sub = [None] * a.ndim
    b_sub = [None] * b.ndim
    for dl, dr in zip(lb, rb):
        c = next(it)
        a_sub[dl] = b_sub[dr] = c
    for dl, dr in zip(lc, rc):
        c = next(it)
        a_sub[dl] = b_sub[dr] = c
    a_free, b_free = [], []
    for i in range(a.ndim):
        if a_sub[i] is None:
            a_sub[i] = next(it)
            a_free.append(a_sub[i])
    for i in range(b.ndim):
        if b_sub[i] is None:
            b_sub[i] = next(it)
            b_free.append(b_sub[i])
    out_sub = [a_sub[d] for d in lb] + a_free + b_free
    spec = f"{''.join(a_sub)},{''.join(b_sub)}->{''.join(out_sub)}"
    return [_out(node, np.einsum(spec, a, b))]


# -- indexing ----------------------------------------------------------------
@_ev("Gather")
def _(node, args):
    return [np.take(args[0], args[1], axis=node.attrs["axis"])]


@_ev("ScatterAdd")
def _(node, args):
    out = args[0].copy()
    np.add.at(out, args[1], args[2].astype(out.dtype))
    return [out]


def _clamp_starts(starts, shape, sizes):
    return [
        int(np.clip(int(s), 0, dim - sz))
        for s, dim, sz in zip(starts, shape, sizes)
    ]


@_ev("DynamicSlice")
def _(node, args):
    x = args[0]
    sizes = node.attrs["sizes"]
    starts = _clamp_starts(args[1:], x.shape, sizes)
    sl = tuple(slice(s, s + z) for s, z in zip(starts, sizes))
    return [x[sl]]


@_ev("DynamicUpdateSlice")
def _(node, args):
    x, upd = args[0].copy(), args[1]
    starts = _clamp_starts(args[2:], x.shape, upd.shape)
    sl = tuple(slice(s, s + z) for s, z in zip(starts, upd.shape))
    x[sl] = upd
    return [x]


# -- compounds ---------------------------------------------------------------
def _softmax(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


@_ev("Softmax")
def _(node, args):
    return [_out(node, _softmax(_f32(args[0]), node.attrs["axis"]))]


@_ev("LogSoftmax")
def _(node, args):
    x = _f32(args[0])
    ax = node.attrs["axis"]
    m = np.max(x, axis=ax, keepdims=True)
    s = x - m
    return [_out(node, s - np.log(np.sum(np.exp(s), axis=ax, keepdims=True)))]


@_ev("RMSNorm")
def _(node, args):
    x, w = _f32(args[0]), _f32(args[1])
    var = np.mean(np.square(x), axis=-1, keepdims=True)
    return [_out(node, x / np.sqrt(var + node.attrs["eps"]) * w)]


@_ev("LayerNorm")
def _(node, args):
    x, w, b = _f32(args[0]), _f32(args[1]), _f32(args[2])
    mu = np.mean(x, axis=-1, keepdims=True)
    var = np.mean(np.square(x - mu), axis=-1, keepdims=True)
    return [_out(node, (x - mu) / np.sqrt(var + node.attrs["eps"]) * w + b)]


@_ev("Attention")
def _(node, args):
    q, k, v = (_f32(a) for a in args[:3])
    q_offset = int(args[3]) if node.attrs["has_offset"] else 0
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    rep = Hq // Hkv
    k = np.repeat(k, rep, axis=1)
    v = np.repeat(v, rep, axis=1)
    scores = np.einsum("bhqd,bhkd->bhqk", q, k) * node.attrs["scale"]
    qpos = np.arange(Sq)[:, None] + q_offset
    kpos = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), dtype=bool)
    if node.attrs["causal"]:
        mask &= kpos <= qpos
    if node.attrs["window"] is not None:
        mask &= kpos > qpos - node.attrs["window"]
    scores = np.where(mask, scores, -1e30)
    probs = _softmax(scores, axis=-1)
    out = np.einsum("bhqk,bhkd->bhqd", probs, v)
    return [_out(node, out)]


@_ev("SwiGLU")
def _(node, args):
    x, wg, wu, wd = (_f32(a) for a in args)
    g = x @ wg
    g = g * (1.0 / (1.0 + np.exp(-g)))  # silu
    h = g * (x @ wu)
    return [_out(node, h @ wd)]


@_ev("NormMatmul")
def _(node, args):
    x, w, w2 = (_f32(a) for a in args)
    var = np.mean(np.square(x), axis=-1, keepdims=True)
    return [_out(node, (x / np.sqrt(var + node.attrs["eps"]) * w) @ w2)]


@_ev("RotaryQKV")
def _(node, args):
    x, wq, wk, wv, cos, sin = (_f32(a) for a in args)
    B, S, _D = x.shape
    n_heads, n_kv = node.attrs["n_heads"], node.attrs["n_kv"]

    def split(y, h):
        d = y.shape[-1] // h
        return y.reshape(B, S, h, d).transpose(0, 2, 1, 3)

    def rope(t):
        half = t.shape[-1] // 2
        x1, x2 = t[..., :half], t[..., half:]
        c = cos[None, None, :, :]
        s = sin[None, None, :, :]
        return np.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)

    q = rope(split(x @ wq, n_heads))
    k = rope(split(x @ wk, n_kv))
    v = split(x @ wv, n_kv)
    return [_out(node, q, 0), _out(node, k, 1), _out(node, v, 2)]


@_ev("SoftmaxCrossEntropy")
def _(node, args):
    logits, labels = _f32(args[0]), args[1]
    m = np.max(logits, axis=-1, keepdims=True)
    lse = np.log(np.sum(np.exp(logits - m), axis=-1)) + m[..., 0]
    label_logit = np.take_along_axis(
        logits, labels[..., None].astype(np.int64), axis=-1
    )[..., 0]
    return [_out(node, (lse - label_logit).astype(np.float32))]


@_ev("LinearRecurrence")
def _(node, args):
    a, b = _f32(args[0]), _f32(args[1])
    axis = node.attrs["axis"]
    a = np.moveaxis(a, axis, 0)
    b = np.moveaxis(b, axis, 0)
    out = np.empty_like(b)
    rng = range(b.shape[0] - 1, -1, -1) if node.attrs["reverse"] else range(b.shape[0])
    h = np.zeros_like(b[0])
    for t in rng:
        h = a[t] * h + b[t]
        out[t] = h
    return [_out(node, np.moveaxis(out, 0, axis))]


# -- collectives (identical-shards convention) -------------------------------
@_ev("AllReduce")
def _(node, args):
    return [args[0]]  # group of identical shards: sum/mean both ~= x for size 1


@_ev("AllGather")
def _(node, args):
    n = node.attrs["axis_size"]
    return [np.concatenate([args[0]] * n, axis=node.attrs["axis"])]


@_ev("ReduceScatter")
def _(node, args):
    n = node.attrs["axis_size"]
    ax = node.attrs["axis"]
    piece = np.split(args[0], n, axis=ax)[0]
    return [_out(node, piece * n)]  # sum over n identical shards, scattered


@_ev("AllToAll")
def _(node, args):
    n = node.attrs["axis_size"]
    sp, cc = node.attrs["split_axis"], node.attrs["concat_axis"]
    piece = np.split(args[0], n, axis=sp)[0]
    return [np.concatenate([piece] * n, axis=cc)]


@_ev("CollectivePermute")
def _(node, args):
    return [args[0]]


# -- structured control -------------------------------------------------------
@_ev("Scan")
def _(node, args):
    at = node.attrs
    nc, nx = at["n_carry"], at["n_xs"]
    body: Function = at["body"]
    carries = list(args[:nc])
    xs = args[nc:nc + nx]
    consts = list(args[nc + nx:])
    length = at["length"]
    ys: List[List[np.ndarray]] = []
    order = range(length - 1, -1, -1) if at["reverse"] else range(length)
    for t in order:
        slices = [x[t] for x in xs]
        outs = evaluate(body, carries + slices + consts)
        carries = list(outs[:nc])
        ys.append(outs[nc:])
    if at["reverse"]:
        ys = ys[::-1]
    n_ys = len(node.out_types) - nc
    stacked = [
        np.stack([step[i] for step in ys]) if length > 0
        else np.zeros(node.out_types[nc + i].shape, node.out_types[nc + i].dtype)
        for i in range(n_ys)
    ]
    return carries + stacked


# ---------------------------------------------------------------------------
def evaluate(fn: Function, inputs: List[np.ndarray],
             arena: Optional[Any] = None) -> List[np.ndarray]:
    """Evaluate ``fn`` on numpy inputs.  ``arena`` (a MemoryPlan) makes the
    interpreter allocate results inside planned buffers to validate reuse."""
    if len(inputs) != len(fn.parameters):
        raise TypeError(f"{fn.name}: expected {len(fn.parameters)} inputs")
    env: Dict[int, List[np.ndarray]] = {}
    for p, arr in zip(fn.parameters, inputs):
        arr = np.asarray(arr)
        t = p.out_types[0]
        if arr.dtype != t.dtype:
            arr = arr.astype(t.dtype)
        if tuple(arr.shape) != t.shape:
            raise TypeError(f"{p.name}: got {arr.shape}, expected {t.shape}")
        env[id(p)] = [arr]
    for node in fn.nodes():
        if node.op == "Parameter":
            continue
        if node.op not in EVAL:
            raise NotImplementedError(f"interpreter: no rule for {node.op}")
        args = [env[id(v.node)][v.index] for v in node.inputs]
        outs = EVAL[node.op](node, args)
        if arena is not None:
            outs = [arena.place(node, i, o) for i, o in enumerate(outs)]
        env[id(node)] = [np.asarray(o) for o in outs]
    return [env[id(r.node)][r.index] for r in fn.results]

