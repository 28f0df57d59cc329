"""IR operation constructors with eager shape/type inference.

Mirrors the nGraph op set organization: a fixed-but-extensible set of
stateless ops (paper sec. 1.1: "nGraph, XLA, and LLVM use a fixed, but
extensible, IR operation set").  Collective-communication primitives are
core graph ops (paper sec. 4).

Every constructor validates input types and computes output types at
construction; an ill-typed graph cannot be built.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import node as _node_mod
from .node import Node, Value
from .types import (
    TensorType,
    as_dtype,
    broadcast_shapes,
    is_float,
    is_int,
    promote_dtypes,
)

ValueLike = Union[Value, int, float, bool, np.ndarray]

# Registry of all known ops -> number of outputs ("*" = variable).
OP_SET = {}


def _register(op: str, n_out: Any = 1) -> None:
    OP_SET[op] = n_out


# ---------------------------------------------------------------------------
# graph inputs
# ---------------------------------------------------------------------------
_register("Parameter")


def parameter(shape: Sequence[int], dtype: Any = "f32", name: Optional[str] = None) -> Node:
    t = TensorType(shape, dtype)
    return Node("Parameter", [], {}, [t], name=name)


_register("Constant")


def constant(value: Any, dtype: Any = None, name: Optional[str] = None) -> Value:
    arr = np.asarray(value)
    if dtype is not None:
        arr = arr.astype(as_dtype(dtype))
    elif arr.dtype == np.float64:
        arr = arr.astype(np.float32)  # default float is f32
    elif arr.dtype == np.int64 and not isinstance(value, np.ndarray):
        arr = arr.astype(np.int32)  # default python int is i32
    t = TensorType(arr.shape, arr.dtype)
    return Node("Constant", [], {"value": arr}, [t], name=name).out()


def as_value(x: ValueLike, like: Optional[Value] = None) -> Value:
    """Lift python scalars / numpy arrays to Constants."""
    if isinstance(x, Value):
        return x
    if isinstance(x, Node):
        return x.out()
    dtype = like.dtype if like is not None and not isinstance(x, np.ndarray) else None
    return constant(x, dtype=dtype)


_register("Iota")


def iota(shape: Sequence[int], dim: int, dtype: Any = "i32") -> Value:
    t = TensorType(shape, dtype)
    if not (0 <= dim < max(len(t.shape), 1)):
        raise ValueError(f"iota dim {dim} out of range for {t}")
    return Node("Iota", [], {"dim": int(dim)}, [t]).out()


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------
_UNARY_FLOAT = [
    "Negative", "Exp", "Log", "Tanh", "Sigmoid", "Relu", "Abs", "Sign",
    "Sqrt", "Rsqrt", "Erf", "Sin", "Cos", "Floor", "Gelu", "Silu",
    "Log1p", "Expm1",
]
for _op in _UNARY_FLOAT:
    _register(_op)


def _unary(op: str, x: ValueLike) -> Value:
    x = as_value(x)
    if op not in ("Negative", "Abs", "Sign") and not is_float(x.dtype):
        raise TypeError(f"{op} requires float input, got {x.type}")
    return Node(op, [x], {}, [x.type]).out()


def negative(x): return _unary("Negative", x)
def exp(x): return _unary("Exp", x)
def log(x): return _unary("Log", x)
def log1p(x): return _unary("Log1p", x)
def expm1(x): return _unary("Expm1", x)
def tanh(x): return _unary("Tanh", x)
def sigmoid(x): return _unary("Sigmoid", x)
def relu(x): return _unary("Relu", x)
def abs_(x): return _unary("Abs", x)
def sign(x): return _unary("Sign", x)
def sqrt(x): return _unary("Sqrt", x)
def rsqrt(x): return _unary("Rsqrt", x)
def erf(x): return _unary("Erf", x)
def sin(x): return _unary("Sin", x)
def cos(x): return _unary("Cos", x)
def floor(x): return _unary("Floor", x)
def gelu(x): return _unary("Gelu", x)      # exact (erf) gelu
def silu(x): return _unary("Silu", x)


def square(x: ValueLike) -> Value:
    x = as_value(x)
    return multiply(x, x)


_BINARY = ["Add", "Subtract", "Multiply", "Divide", "Power", "Maximum", "Minimum"]
for _op in _BINARY:
    _register(_op)
_COMPARE = ["Less", "LessEqual", "Greater", "GreaterEqual", "Equal", "NotEqual"]
for _op in _COMPARE:
    _register(_op)
_register("And")
_register("Or")
_register("Not")


def _auto_broadcast(a: Value, b: Value) -> Tuple[Value, Value]:
    """Insert explicit Broadcast nodes for numpy-style implicit broadcasting.

    The IR itself is strict (binary ops require equal shapes, like nGraph);
    frontend sugar inserts the Broadcasts.
    """
    if a.shape == b.shape:
        return a, b
    out_shape = broadcast_shapes(a.shape, b.shape)
    return _broadcast_to(a, out_shape), _broadcast_to(b, out_shape)


def _broadcast_to(x: Value, shape: Tuple[int, ...]) -> Value:
    if x.shape == tuple(shape):
        return x
    # numpy rules: align trailing dims
    offset = len(shape) - x.rank
    dims = []
    for i, s in enumerate(x.shape):
        if s == shape[i + offset]:
            dims.append(i + offset)
        elif s == 1:
            dims.append(i + offset)  # broadcast a size-1 dim in place
        else:
            raise ValueError(f"cannot broadcast {x.shape} to {shape}")
    # squeeze size-1 dims that broadcast, then broadcast_in_dim
    keep = [i for i, s in enumerate(x.shape) if not (s == 1 and shape[dims[i]] != 1)]
    if len(keep) != x.rank:
        x = reshape(x, [x.shape[i] for i in keep])
        dims = [dims[i] for i in keep]
    return broadcast_in_dim(x, shape, dims)


def _binary(op: str, a: ValueLike, b: ValueLike) -> Value:
    a0, b0 = a, b
    if not isinstance(a, Value):
        a = as_value(a, like=b if isinstance(b, Value) else None)
    if not isinstance(b, Value):
        b = as_value(b, like=a)
    out_dtype = promote_dtypes(a.dtype, b.dtype)
    a = convert(a, out_dtype) if a.dtype != out_dtype else a
    b = convert(b, out_dtype) if b.dtype != out_dtype else b
    a, b = _auto_broadcast(a, b)
    if op in _COMPARE:
        out_t = TensorType(a.shape, "bool")
    else:
        out_t = a.type
    return Node(op, [a, b], {}, [out_t]).out()


def add(a, b): return _binary("Add", a, b)
def subtract(a, b): return _binary("Subtract", a, b)
def multiply(a, b): return _binary("Multiply", a, b)
def divide(a, b): return _binary("Divide", a, b)
def power(a, b): return _binary("Power", a, b)
def maximum(a, b): return _binary("Maximum", a, b)
def minimum(a, b): return _binary("Minimum", a, b)
def less(a, b): return _binary("Less", a, b)
def less_equal(a, b): return _binary("LessEqual", a, b)
def greater(a, b): return _binary("Greater", a, b)
def greater_equal(a, b): return _binary("GreaterEqual", a, b)
def equal(a, b): return _binary("Equal", a, b)
def not_equal(a, b): return _binary("NotEqual", a, b)


def logical_and(a, b): return _binary("And", a, b)
def logical_or(a, b): return _binary("Or", a, b)


def logical_not(x: Value) -> Value:
    if as_dtype(x.dtype) != as_dtype("bool"):
        raise TypeError("Not requires bool")
    return Node("Not", [x], {}, [x.type]).out()


_register("Select")


def select(cond: Value, on_true: ValueLike, on_false: ValueLike) -> Value:
    on_true = as_value(on_true)
    on_false = as_value(on_false)
    out_dtype = promote_dtypes(on_true.dtype, on_false.dtype)
    on_true = convert(on_true, out_dtype)
    on_false = convert(on_false, out_dtype)
    shape = broadcast_shapes(cond.shape, on_true.shape, on_false.shape)
    cond = _broadcast_to(cond, shape)
    on_true = _broadcast_to(on_true, shape)
    on_false = _broadcast_to(on_false, shape)
    return Node("Select", [cond, on_true, on_false], {}, [on_true.type]).out()


_register("Convert")


def convert(x: ValueLike, dtype: Any) -> Value:
    x = as_value(x)
    dt = as_dtype(dtype)
    if x.dtype == dt:
        return x
    return Node("Convert", [x], {"dtype": dt}, [x.type.with_dtype(dt)]).out()


_register("StopGradient")


def stop_gradient(x: Value) -> Value:
    return Node("StopGradient", [x], {}, [x.type]).out()


_register("OptimizationBarrier")


def optimization_barrier(x: Value) -> Value:
    """Identity that backend optimizers may not move code across.  Used
    on residual-stack slices inside backward scan bodies to stop XLA
    hoisting per-step f32 converts out of the loop (which would
    materialize an f32 copy of the whole (L,B,S,D) residual stack)."""
    return Node("OptimizationBarrier", [x], {}, [x.type]).out()


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------
_register("Reshape")


def reshape(x: Value, shape: Sequence[int]) -> Value:
    shape = list(int(s) for s in shape)
    if shape.count(-1) == 1:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = x.type.size // max(known, 1)
    shape = tuple(shape)
    if (math.prod(shape) if shape else 1) != x.type.size:
        raise ValueError(f"reshape {x.shape} -> {shape}: size mismatch")
    if shape == x.shape:
        return x
    return Node("Reshape", [x], {"shape": shape}, [x.type.with_shape(shape)]).out()


_register("Transpose")


def transpose(x: Value, perm: Sequence[int]) -> Value:
    perm = tuple(int(p) for p in perm)
    if sorted(perm) != list(range(x.rank)):
        raise ValueError(f"bad permutation {perm} for rank {x.rank}")
    if perm == tuple(range(x.rank)):
        return x
    shape = tuple(x.shape[p] for p in perm)
    return Node("Transpose", [x], {"perm": perm}, [x.type.with_shape(shape)]).out()


_register("BroadcastInDim")


def broadcast_in_dim(x: Value, shape: Sequence[int], broadcast_dims: Sequence[int]) -> Value:
    shape = tuple(int(s) for s in shape)
    dims = tuple(int(d) for d in broadcast_dims)
    if len(dims) != x.rank:
        raise ValueError("broadcast_dims must map every input dim")
    for i, d in enumerate(dims):
        if x.shape[i] not in (1, shape[d]):
            raise ValueError(f"dim {i} ({x.shape[i]}) does not broadcast to {shape[d]}")
    return Node(
        "BroadcastInDim", [x], {"shape": shape, "broadcast_dims": dims},
        [x.type.with_shape(shape)],
    ).out()


def broadcast_to(x: ValueLike, shape: Sequence[int]) -> Value:
    return _broadcast_to(as_value(x), tuple(int(s) for s in shape))


_register("Slice")


def slice_(x: Value, starts: Sequence[int], stops: Sequence[int],
           strides: Optional[Sequence[int]] = None) -> Value:
    strides = tuple(int(s) for s in (strides or [1] * x.rank))
    starts = tuple(int(s) for s in starts)
    stops = tuple(int(s) for s in stops)
    if not (len(starts) == len(stops) == len(strides) == x.rank):
        raise ValueError("slice spec must cover every dim")
    shape = []
    for st, sp, sd, full in zip(starts, stops, strides, x.shape):
        if not (0 <= st <= sp <= full):
            raise ValueError(f"bad slice [{st}:{sp}] on dim of size {full}")
        shape.append(-(-(sp - st) // sd))
    return Node(
        "Slice", [x], {"starts": starts, "stops": stops, "strides": strides},
        [x.type.with_shape(shape)],
    ).out()


_register("Concat")


def concat(xs: Sequence[Value], axis: int) -> Value:
    xs = [as_value(x) for x in xs]
    if len(xs) == 1:
        return xs[0]
    axis = axis % xs[0].rank
    base = list(xs[0].shape)
    total = 0
    for x in xs:
        if x.dtype != xs[0].dtype:
            raise TypeError("concat dtype mismatch")
        s = list(x.shape)
        total += s[axis]
        s[axis] = base[axis] = 0
        if s != base:
            raise ValueError(f"concat shape mismatch: {x.shape} vs {xs[0].shape}")
    base[axis] = total
    return Node("Concat", list(xs), {"axis": axis}, [xs[0].type.with_shape(base)]).out()


_register("Pad")


def pad(x: Value, low: Sequence[int], high: Sequence[int], value: float = 0.0) -> Value:
    low = tuple(int(s) for s in low)
    high = tuple(int(s) for s in high)
    shape = tuple(s + l + h for s, l, h in zip(x.shape, low, high))
    return Node(
        "Pad", [x], {"low": low, "high": high, "value": float(value)},
        [x.type.with_shape(shape)],
    ).out()


_register("Reverse")


def reverse(x: Value, axes: Sequence[int]) -> Value:
    axes = tuple(a % x.rank for a in axes)
    return Node("Reverse", [x], {"axes": axes}, [x.type]).out()


def squeeze(x: Value, axis: int) -> Value:
    axis = axis % x.rank
    if x.shape[axis] != 1:
        raise ValueError(f"cannot squeeze dim {axis} of {x.shape}")
    return reshape(x, x.shape[:axis] + x.shape[axis + 1:])


def expand_dims(x: Value, axis: int) -> Value:
    axis = axis % (x.rank + 1)
    return reshape(x, x.shape[:axis] + (1,) + x.shape[axis:])


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
for _op in ("ReduceSum", "ReduceMax", "ReduceMin"):
    _register(_op)


def _reduce(op: str, x: Value, axes: Optional[Sequence[int]], keepdims: bool) -> Value:
    if axes is None:
        axes = tuple(range(x.rank))
    axes = tuple(sorted(a % x.rank for a in axes))
    if keepdims:
        shape = tuple(1 if i in axes else s for i, s in enumerate(x.shape))
    else:
        shape = tuple(s for i, s in enumerate(x.shape) if i not in axes)
    return Node(
        op, [x], {"axes": axes, "keepdims": bool(keepdims)},
        [x.type.with_shape(shape)],
    ).out()


def reduce_sum(x, axes=None, keepdims=False): return _reduce("ReduceSum", x, axes, keepdims)
def reduce_max(x, axes=None, keepdims=False): return _reduce("ReduceMax", x, axes, keepdims)
def reduce_min(x, axes=None, keepdims=False): return _reduce("ReduceMin", x, axes, keepdims)


def reduce_mean(x: Value, axes=None, keepdims=False) -> Value:
    if axes is None:
        axes = tuple(range(x.rank))
    axes = tuple(a % x.rank for a in axes)
    denom = math.prod(x.shape[a] for a in axes)
    return multiply(reduce_sum(x, axes, keepdims), constant(1.0 / denom, dtype=x.dtype))


_register("CumSum")


def cumsum(x: Value, axis: int, exclusive: bool = False) -> Value:
    axis = axis % x.rank
    return Node("CumSum", [x], {"axis": axis, "exclusive": bool(exclusive)}, [x.type]).out()


_register("ArgMax")


def argmax(x: Value, axis: int) -> Value:
    axis = axis % x.rank
    shape = tuple(s for i, s in enumerate(x.shape) if i != axis)
    return Node("ArgMax", [x], {"axis": axis}, [TensorType(shape, "i32")]).out()


_register("TopK", 2)


def top_k(x: Value, k: int) -> Tuple[Value, Value]:
    """Top-k along the last axis -> (values, i32 indices)."""
    if x.shape[-1] < k:
        raise ValueError(f"k={k} > last dim {x.shape[-1]}")
    shape = x.shape[:-1] + (k,)
    n = Node("TopK", [x], {"k": int(k)},
             [x.type.with_shape(shape), TensorType(shape, "i32")])
    return n.out(0), n.out(1)


# ---------------------------------------------------------------------------
# contraction
# ---------------------------------------------------------------------------
_register("DotGeneral")


def dot_general(
    a: Value,
    b: Value,
    contracting: Tuple[Sequence[int], Sequence[int]],
    batch: Tuple[Sequence[int], Sequence[int]] = ((), ()),
    preferred_dtype: Any = None,
) -> Value:
    lc = tuple(d % a.rank for d in contracting[0])
    rc = tuple(d % b.rank for d in contracting[1])
    lb = tuple(d % a.rank for d in batch[0])
    rb = tuple(d % b.rank for d in batch[1])
    if len(lc) != len(rc) or len(lb) != len(rb):
        raise ValueError("contracting/batch dim count mismatch")
    for dl, dr in zip(lc, rc):
        if a.shape[dl] != b.shape[dr]:
            raise ValueError(f"contract {a.shape}@{dl} vs {b.shape}@{dr}")
    for dl, dr in zip(lb, rb):
        if a.shape[dl] != b.shape[dr]:
            raise ValueError(f"batch {a.shape}@{dl} vs {b.shape}@{dr}")
    out_shape = (
        tuple(a.shape[d] for d in lb)
        + tuple(s for i, s in enumerate(a.shape) if i not in lc + lb)
        + tuple(s for i, s in enumerate(b.shape) if i not in rc + rb)
    )
    out_dtype = as_dtype(preferred_dtype) if preferred_dtype else promote_dtypes(a.dtype, b.dtype)
    return Node(
        "DotGeneral", [a, b],
        {"contracting": (lc, rc), "batch": (lb, rb)},
        [TensorType(out_shape, out_dtype)],
    ).out()


def matmul(a: Value, b: Value) -> Value:
    """numpy-style matmul with batch broadcasting limited to equal batches."""
    if a.rank == 1 or b.rank == 1:
        raise ValueError("matmul requires rank >= 2 (use dot_general)")
    if b.rank == 2:  # numpy-style: apply to last dim of a
        return dot_general(a, b, contracting=((a.rank - 1,), (0,)))
    n_batch = min(a.rank, b.rank) - 2
    if a.rank != b.rank:
        raise ValueError("matmul ranks must match (use dot_general)")
    return dot_general(
        a, b,
        contracting=((a.rank - 1,), (b.rank - 2,)),
        batch=(tuple(range(n_batch)), tuple(range(n_batch))),
    )


def einsum(spec: str, a: Value, b: Value, preferred_dtype: Any = None) -> Value:
    """Two-operand einsum lowered to DotGeneral (+ transpose/reshape)."""
    lhs, out = spec.split("->")
    sa, sb = lhs.split(",")
    sa, sb, out = sa.strip(), sb.strip(), out.strip()
    if len(sa) != a.rank or len(sb) != b.rank:
        raise ValueError(f"einsum {spec}: rank mismatch {a.shape} {b.shape}")
    batch = [c for c in sa if c in sb and c in out]
    contract = [c for c in sa if c in sb and c not in out]
    lc = tuple(sa.index(c) for c in contract)
    rc = tuple(sb.index(c) for c in contract)
    lb = tuple(sa.index(c) for c in batch)
    rb = tuple(sb.index(c) for c in batch)
    res = dot_general(a, b, (lc, rc), (lb, rb), preferred_dtype)
    # result layout: batch + a-free + b-free
    a_free = [c for c in sa if c not in contract and c not in batch]
    b_free = [c for c in sb if c not in contract and c not in batch]
    natural = batch + a_free + b_free
    if len(set(natural)) != len(natural):
        raise ValueError(f"einsum {spec}: repeated free index")
    if "".join(natural) != out:
        perm = [natural.index(c) for c in out]
        res = transpose(res, perm)
    return res


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------
_register("Gather")


def gather(operand: Value, indices: Value, axis: int = 0) -> Value:
    """jnp.take semantics: out = operand[..., indices, ...] along ``axis``."""
    if not is_int(indices.dtype):
        raise TypeError("gather indices must be integer")
    axis = axis % operand.rank
    shape = operand.shape[:axis] + indices.shape + operand.shape[axis + 1:]
    return Node("Gather", [operand, indices], {"axis": axis},
                [operand.type.with_shape(shape)]).out()


_register("ScatterAdd")


def scatter_add(operand: Value, indices: Value, updates: Value) -> Value:
    """operand.at[indices].add(updates) along axis 0.

    updates.shape == indices.shape + operand.shape[1:].
    """
    if not is_int(indices.dtype):
        raise TypeError("scatter indices must be integer")
    expected = indices.shape + operand.shape[1:]
    if updates.shape != expected:
        raise ValueError(f"scatter updates {updates.shape} != {expected}")
    return Node("ScatterAdd", [operand, indices, updates], {}, [operand.type]).out()


_register("DynamicSlice")


def dynamic_slice(x: Value, starts: Sequence[Value], sizes: Sequence[int]) -> Value:
    starts = [as_value(s) for s in starts]
    if len(starts) != x.rank or len(sizes) != x.rank:
        raise ValueError("dynamic_slice needs a start and size per dim")
    for s in starts:
        if s.shape != () or not is_int(s.dtype):
            raise TypeError("dynamic_slice starts must be integer scalars")
    sizes = tuple(int(s) for s in sizes)
    return Node("DynamicSlice", [x, *starts], {"sizes": sizes},
                [x.type.with_shape(sizes)]).out()


_register("DynamicUpdateSlice")


def dynamic_update_slice(x: Value, update: Value, starts: Sequence[Value]) -> Value:
    starts = [as_value(s) for s in starts]
    if len(starts) != x.rank or update.rank != x.rank:
        raise ValueError("dynamic_update_slice rank mismatch")
    if update.dtype != x.dtype:
        raise TypeError("dynamic_update_slice dtype mismatch")
    return Node("DynamicUpdateSlice", [x, update, *starts], {}, [x.type]).out()


def one_hot(indices: Value, depth: int, dtype: Any = "f32", axis: int = -1) -> Value:
    """Builder composite: one-hot encode along a new trailing axis."""
    if axis != -1:
        raise NotImplementedError("one_hot supports axis=-1")
    ind = expand_dims(indices, indices.rank)
    classes = iota(ind.shape[:-1] + (depth,), dim=indices.rank, dtype=indices.dtype)
    return convert(equal(_broadcast_to(ind, classes.shape), classes), dtype)


def take_along_last(x: Value, idx: Value) -> Value:
    """x: (..., N), idx: (..., K) int -> (..., K) via one-hot contraction."""
    oh = one_hot(idx, x.shape[-1], dtype=x.dtype)  # (..., K, N)
    ba = tuple(range(x.rank - 1))
    return dot_general(oh, x, ((oh.rank - 1,), (x.rank - 1,)), (ba, ba))


# ---------------------------------------------------------------------------
# normalization / activation compounds (primitive here, with reference
# decompositions in passes/decompose.py for the paper-faithful baseline)
# ---------------------------------------------------------------------------
_register("Softmax")


def softmax(x: Value, axis: int = -1) -> Value:
    return Node("Softmax", [x], {"axis": axis % x.rank}, [x.type]).out()


_register("LogSoftmax")


def log_softmax(x: Value, axis: int = -1) -> Value:
    return Node("LogSoftmax", [x], {"axis": axis % x.rank}, [x.type]).out()


_register("RMSNorm")


def rms_norm(x: Value, weight: Value, eps: float = 1e-6) -> Value:
    """Normalize the last axis: x * rsqrt(mean(x^2) + eps) * weight."""
    if weight.shape != (x.shape[-1],):
        raise ValueError(f"rms_norm weight {weight.shape} != ({x.shape[-1]},)")
    return Node("RMSNorm", [x, weight], {"eps": float(eps)}, [x.type]).out()


_register("LayerNorm")


def layer_norm(x: Value, weight: Value, bias: Value, eps: float = 1e-5) -> Value:
    if weight.shape != (x.shape[-1],) or bias.shape != (x.shape[-1],):
        raise ValueError("layer_norm scale/bias must match last axis")
    return Node("LayerNorm", [x, weight, bias], {"eps": float(eps)}, [x.type]).out()


_register("Attention")


def attention(
    q: Value,
    k: Value,
    v: Value,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: Optional[Value] = None,
    sinks: bool = False,
) -> Value:
    """Scaled-dot-product attention compound op (BHSD layout, GQA-aware).

    q: (B, Hq, Sq, Dk); k: (B, Hkv, Skv, Dk); v: (B, Hkv, Skv, Dv) with
    Hq % Hkv == 0.  Dv may differ from Dk (MLA-style latent attention).
    ``q_offset`` (scalar i32) offsets query positions for decode-with-cache
    causal masking.  ``window`` is a sliding-window size (None = full).
    """
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    Dv = v.shape[-1]
    if (Bk, Dk) != (B, D) or v.shape != (B, Hkv, Skv, Dv):
        raise ValueError(f"attention shapes q={q.shape} k={k.shape} v={v.shape}")
    if Hq % Hkv != 0:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    inputs = [q, k, v]
    attrs = {
        "causal": bool(causal),
        "window": None if window is None else int(window),
        "scale": float(scale if scale is not None else 1.0 / math.sqrt(D)),
        "has_offset": q_offset is not None,
    }
    if q_offset is not None:
        inputs.append(q_offset)
    return Node("Attention", inputs, attrs,
                [q.type.with_shape((B, Hq, Sq, Dv))]).out()


_register("SwiGLU")


def swiglu(x: Value, w_gate: Value, w_up: Value, w_down: Value) -> Value:
    """Fused SwiGLU MLP: matmul(silu(x @ w_gate) * (x @ w_up), w_down).

    x: (..., D); w_gate/w_up: (D, F); w_down: (F, Do) -> (..., Do).
    The gate activation stays resident in the kernel (never hits HBM);
    the interpreter/XLA fallbacks recompute the same math op-by-op.
    """
    D = x.shape[-1]
    for name, w in (("w_gate", w_gate), ("w_up", w_up)):
        if len(w.shape) != 2 or w.shape[0] != D:
            raise ValueError(f"swiglu {name} must be ({D}, F), got {w.shape}")
    if w_gate.shape[1] != w_up.shape[1]:
        raise ValueError(f"swiglu gate/up widths differ: "
                         f"{w_gate.shape} vs {w_up.shape}")
    F = w_gate.shape[1]
    if len(w_down.shape) != 2 or w_down.shape[0] != F:
        raise ValueError(f"swiglu w_down must be ({F}, Do), got {w_down.shape}")
    out_t = TensorType(x.shape[:-1] + (w_down.shape[1],),
                       promote_dtypes(x.dtype, w_down.dtype))
    return Node("SwiGLU", [x, w_gate, w_up, w_down], {}, [out_t]).out()


_register("NormMatmul")


def norm_matmul(x: Value, weight: Value, w: Value, eps: float = 1e-6) -> Value:
    """Fused RMSNorm feeding a matmul: matmul(rms_norm(x, weight, eps), w).

    x: (..., D); weight: (D,); w: (D, N) -> (..., N).  The normalized
    rows never round-trip through HBM in the Pallas realization.
    """
    D = x.shape[-1]
    if weight.shape != (D,):
        raise ValueError(f"norm_matmul weight {weight.shape} != ({D},)")
    if len(w.shape) != 2 or w.shape[0] != D:
        raise ValueError(f"norm_matmul w must be ({D}, N), got {w.shape}")
    out_t = TensorType(x.shape[:-1] + (w.shape[1],),
                       promote_dtypes(x.dtype, w.dtype))
    return Node("NormMatmul", [x, weight, w], {"eps": float(eps)},
                [out_t]).out()


_register("RotaryQKV", 3)


def rotary_qkv(
    x: Value,
    wq: Value,
    wk: Value,
    wv: Value,
    cos: Value,
    sin: Value,
    *,
    n_heads: int,
    n_kv: int,
) -> Tuple[Value, Value, Value]:
    """Fused QKV projection + rotary embedding (rotate-half convention).

    x: (B, S, D); wq: (D, Hq*Dh); wk/wv: (D, Hkv*Dh); cos/sin: (S, Dh/2)
    -> q: (B, Hq, S, Dh), k: (B, Hkv, S, Dh), v: (B, Hkv, S, Dh), with
    rope applied to q and k (v is a plain projection).
    """
    if len(x.shape) != 3:
        raise ValueError(f"rotary_qkv x must be (B, S, D), got {x.shape}")
    B, S, D = x.shape
    if len(wq.shape) != 2 or wq.shape[0] != D or wq.shape[1] % n_heads:
        raise ValueError(f"rotary_qkv wq {wq.shape} vs D={D} Hq={n_heads}")
    Dh = wq.shape[1] // n_heads
    for name, w in (("wk", wk), ("wv", wv)):
        if w.shape != (D, n_kv * Dh):
            raise ValueError(f"rotary_qkv {name} must be ({D}, {n_kv * Dh}), "
                             f"got {w.shape}")
    if Dh % 2:
        raise ValueError(f"rotary_qkv head dim {Dh} must be even")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.shape != (S, Dh // 2):
            raise ValueError(f"rotary_qkv {name} must be ({S}, {Dh // 2}), "
                             f"got {t.shape}")
    dt = promote_dtypes(x.dtype, wq.dtype)
    tq = TensorType((B, n_heads, S, Dh), dt)
    tkv = TensorType((B, n_kv, S, Dh), dt)
    n = Node("RotaryQKV", [x, wq, wk, wv, cos, sin],
             {"n_heads": int(n_heads), "n_kv": int(n_kv)}, [tq, tkv, tkv])
    return n.out(0), n.out(1), n.out(2)


_register("SoftmaxCrossEntropy")


def softmax_cross_entropy(logits: Value, labels: Value) -> Value:
    """Per-token xent: logits (..., V) float, labels (...) int -> (...) f32."""
    if labels.shape != logits.shape[:-1]:
        raise ValueError(f"labels {labels.shape} vs logits {logits.shape}")
    return Node("SoftmaxCrossEntropy", [logits, labels], {},
                [TensorType(labels.shape, "f32")]).out()


# ---------------------------------------------------------------------------
# structured control flow (extension over the paper's pure-DAG IR; see
# DESIGN.md sec. 2) and linear recurrences
# ---------------------------------------------------------------------------
_register("Scan", "*")


def scan(
    body,  # Function
    carries: Sequence[Value],
    xs: Sequence[Value] = (),
    consts: Sequence[Value] = (),
    length: Optional[int] = None,
    reverse: bool = False,
    unroll: int = 1,
) -> List[Value]:
    """lax.scan-style structured loop.

    body(c_0..c_nc, x_0..x_nx, w_0..w_nw) -> (c'_0..c'_nc, y_0..y_ny)
    returns [final carries..., stacked ys...].
    """
    carries = [as_value(c) for c in carries]
    xs = [as_value(x) for x in xs]
    consts = [as_value(w) for w in consts]
    if length is None:
        if not xs:
            raise ValueError("scan needs xs or an explicit length")
        length = xs[0].shape[0]
    nc, nx, nw = len(carries), len(xs), len(consts)
    bt = body.in_types
    if len(bt) != nc + nx + nw:
        raise ValueError(f"scan body takes {len(bt)} params, given {nc}+{nx}+{nw}")
    for i, c in enumerate(carries):
        if bt[i].shape != c.shape or bt[i].dtype != c.dtype:
            raise ValueError(f"scan carry {i}: body {bt[i]} vs init {c.type}")
    for i, x in enumerate(xs):
        if x.shape[0] != length:
            raise ValueError(f"scan xs {i} leading dim {x.shape[0]} != {length}")
        if bt[nc + i].shape != x.shape[1:] or bt[nc + i].dtype != x.dtype:
            raise ValueError(f"scan xs {i}: body {bt[nc+i]} vs slice of {x.type}")
    for i, w in enumerate(consts):
        if bt[nc + nx + i].shape != w.shape:
            raise ValueError(f"scan const {i}: body {bt[nc+nx+i]} vs {w.type}")
    ot = body.out_types
    if len(ot) < nc:
        raise ValueError("scan body must return every carry")
    for i in range(nc):
        if ot[i].shape != carries[i].shape or ot[i].dtype != carries[i].dtype:
            raise ValueError(f"scan carry {i} out {ot[i]} != {carries[i].type}")
    out_types = list(ot[:nc]) + [
        t.with_shape((length,) + t.shape) for t in ot[nc:]
    ]
    n = Node(
        "Scan", carries + xs + consts,
        {
            "body": body, "length": int(length), "n_carry": nc, "n_xs": nx,
            "reverse": bool(reverse), "unroll": int(unroll),
        },
        out_types,
    )
    return list(n.outs())


_register("LinearRecurrence")


def linear_recurrence(a: Value, b: Value, axis: int = -2, reverse: bool = False) -> Value:
    """h_t = a_t * h_{t-1} + b_t along ``axis`` (h_{-1} = 0), elementwise.

    Backbone of RG-LRU / mLSTM-style gated linear recurrences; lowered to
    an associative scan on backends that support it.
    """
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"linear_recurrence a {a.type} vs b {b.type}")
    axis = axis % a.rank
    return Node("LinearRecurrence", [a, b],
                {"axis": axis, "reverse": bool(reverse)}, [b.type]).out()


# ---------------------------------------------------------------------------
# collectives: core graph ops (paper sec. 4)
# ---------------------------------------------------------------------------
_register("AllReduce")


def all_reduce(x: Value, axis_name: str, reduce_op: str = "sum") -> Value:
    if reduce_op not in ("sum", "max", "min", "mean"):
        raise ValueError(f"bad reduce_op {reduce_op}")
    return Node("AllReduce", [x], {"axis_name": axis_name, "reduce_op": reduce_op},
                [x.type]).out()


_register("AllGather")


def all_gather(x: Value, axis_name: str, axis: int, axis_size: int) -> Value:
    axis = axis % x.rank
    shape = list(x.shape)
    shape[axis] *= axis_size
    return Node("AllGather", [x],
                {"axis_name": axis_name, "axis": axis, "axis_size": axis_size},
                [x.type.with_shape(shape)]).out()


_register("ReduceScatter")


def reduce_scatter(x: Value, axis_name: str, axis: int, axis_size: int) -> Value:
    axis = axis % x.rank
    if x.shape[axis] % axis_size:
        raise ValueError(f"reduce_scatter dim {x.shape[axis]} % {axis_size}")
    shape = list(x.shape)
    shape[axis] //= axis_size
    return Node("ReduceScatter", [x],
                {"axis_name": axis_name, "axis": axis, "axis_size": axis_size},
                [x.type.with_shape(shape)]).out()


_register("AllToAll")


def all_to_all(x: Value, axis_name: str, split_axis: int, concat_axis: int,
               axis_size: int) -> Value:
    split_axis = split_axis % x.rank
    concat_axis = concat_axis % x.rank
    if x.shape[split_axis] % axis_size:
        raise ValueError("all_to_all split dim not divisible")
    shape = list(x.shape)
    shape[split_axis] //= axis_size
    shape[concat_axis] *= axis_size
    return Node("AllToAll", [x],
                {"axis_name": axis_name, "split_axis": split_axis,
                 "concat_axis": concat_axis, "axis_size": axis_size},
                [x.type.with_shape(shape)]).out()


_register("CollectivePermute")


def collective_permute(x: Value, axis_name: str, pairs: Sequence[Tuple[int, int]]) -> Value:
    return Node("CollectivePermute", [x],
                {"axis_name": axis_name, "pairs": tuple(map(tuple, pairs))},
                [x.type]).out()


def send_recv(x: Value, axis_name: str, shift: int, axis_size: int) -> Value:
    """Point-to-point ring shift (paper: point-to-point primitives)."""
    pairs = [(i, (i + shift) % axis_size) for i in range(axis_size)]
    return collective_permute(x, axis_name, pairs)


_register("ShardingConstraint")


def sharding_constraint(x: Value, spec: Sequence[Any]) -> Value:
    """Attach a partitioning hint (PartitionSpec-like tuple of axis names,
    None, or tuples of names).  Identity on single-device backends."""
    return Node("ShardingConstraint", [x], {"spec": tuple(spec)}, [x.type]).out()


# install `a + b` style sugar on Value
_node_mod.install_operators(__import__("sys").modules[__name__])
