"""Torch code generation for the IR: the port of
``repro/transformers/jax_backend.py``.

``emit_callable`` walks an optimized Function once and returns a plain
Python callable that runs it eagerly with torch ops on one device.  The
numerics are the reference's: sub-f32 floats are upcast for reductions
and products and the result cast to the node's type (``_f32up`` /
``_outcast``), ``ArgMax``/``TopK``/``Iota`` give int32, integer
``Divide`` floors, ``DynamicSlice``/``DynamicUpdateSlice`` clamp their
starts as ``lax`` does, and ``Gather``/``ScatterAdd`` treat out-of-range
indices as ``jnp.take`` (fill) and ``.at[].add`` (drop) do.  No emitter
reads a device value back to the host or copies host memory to the
device, so a dispatch runs without a synchronisation and can be
captured as a CUDA graph (:mod:`repro_torch.backend.graphed`).
``CumSum`` and ``ScatterAdd`` run on the card under
:func:`deterministic_algorithms`, so their sums keep one order from run
to run, as the reference's do.  A ``Scan`` evaluates the body nodes that
depend only on its loop constants once, before the loop (see
:class:`ScanBody`).

The kernel-selection points mirror the reference: ``DotGeneral``,
``RMSNorm``, ``SwiGLU``, ``NormMatmul`` (and ``RotaryQKV``'s projections)
go to the hand-written Hopper kernels (:mod:`repro_torch.kernels`) under
``use_pallas`` when the reference's dtype conditions and the kernel's
shape predicate hold.  ``Attention`` goes to the flash-attention kernel
under ``use_pallas`` where the kernel takes the shapes and the head
width is a multiple of 128 (the reference's rule, so a model gets flash
numerics in the port exactly where it gets them in the reference), else
to the chunked composition where the reference selects its chunked XLA
attention, else to the plain composition.  Collectives come with the
tensor-parallel slice.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.function import Function
from ..core.node import Node
from ..core.types import is_float
from ..devices import as_tensor, numpy_dtype, torch_dtype
from ..kernels import flash_attention as _k_flash
from ..kernels import matmul as _k_matmul
from ..kernels import norm_matmul as _k_norm_matmul
from ..kernels import rmsnorm as _k_rmsnorm
from ..kernels import swiglu as _k_swiglu
from ..kernels.ref import attention_mask
from ..kernels.xla_attention import chunked_attention

EMIT: Dict[str, Callable] = {}

_LATER_TP = "the tensor-parallel slice of the torch port"


def _em(op: str):
    def deco(f):
        EMIT[op] = f
        return f
    return deco


class EmitCtx:
    """Emission options: the device every tensor lives on, whether the
    Hopper kernels are selected (``use_pallas``, the reference's name),
    and the attention realization knobs the kernel check reads."""

    def __init__(self, device: torch.device, use_pallas: bool = False,
                 attn_impl: str = "auto", attn_chunk: int = 1024):
        self.device = torch.device(device)
        self.use_pallas = use_pallas
        self.attn_impl = attn_impl
        self.attn_chunk = attn_chunk
        self._body_cache: Dict[Tuple[int, int], "ScanBody"] = {}

    def scan_body(self, body: Function, n_variant: int) -> "ScanBody":
        key = (id(body), n_variant)
        if key not in self._body_cache:
            self._body_cache[key] = ScanBody(body, self, n_variant)
        return self._body_cache[key]


def _f32up(x: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point() and x.element_size() < 4:
        return x.float()
    return x


def _outcast(node: Node, x: torch.Tensor, i: int = 0) -> torch.Tensor:
    dt = torch_dtype(node.out_types[i].dtype)
    return x if x.dtype == dt else x.to(dt)


def _np_dtype(x: torch.Tensor) -> np.dtype:
    return numpy_dtype(x.dtype)


@contextlib.contextmanager
def deterministic_algorithms() -> Iterator[None]:
    """``torch.use_deterministic_algorithms(True)`` for the ops inside the
    block, then the caller's setting (and its ``warn_only``) back.  On
    CUDA, float ``cumsum`` and ``index_add_`` then take PyTorch's
    fixed-order kernels instead of a scan whose look-back and an
    accumulation whose atomics change the order from run to run.  The
    flag is process-wide while the block runs; the engine thread is the
    only thread that calls torch."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def _fixed_order(x: torch.Tensor):
    """The deterministic guard on the card; nothing on the CPU, whose
    kernels keep one order already."""
    return deterministic_algorithms() if x.is_cuda \
        else contextlib.nullcontext()


# -- leaves (computed once, at emit time; see emit_callable) --------------------
def _leaf_constant(node: Node, ctx: EmitCtx) -> torch.Tensor:
    return as_tensor(np.asarray(node.attrs["value"]), ctx.device)


def _leaf_iota(node: Node, ctx: EmitCtx) -> torch.Tensor:
    t = node.out_types[0]
    dim = node.attrs["dim"]
    n = t.shape[dim]
    shape = [1] * len(t.shape)
    shape[dim] = n
    ar = torch.arange(n, device=ctx.device).to(torch_dtype(t.dtype))
    return ar.reshape(shape).expand(t.shape)


_LEAVES = {"Constant": _leaf_constant, "Iota": _leaf_iota}


# -- elementwise --------------------------------------------------------------
def _gelu(x):
    return F.gelu(x, approximate="none")


def _sigmoid(x):
    """``jax.nn.sigmoid`` as XLA expands it: 1 / (1 + exp(-x)), each op
    rounded to x's type (a bf16 sigmoid rounds three times)."""
    return torch.reciprocal(torch.exp(-x) + 1)


def _silu(x):
    """``jax.nn.silu``: x * sigmoid(x), the product rounded once more
    (``F.silu`` would round once in all)."""
    return x * _sigmoid(x)


_UNARY = {
    "Negative": torch.neg,
    "Exp": torch.exp, "Log": torch.log, "Log1p": torch.log1p,
    "Expm1": torch.expm1, "Tanh": torch.tanh, "Sigmoid": _sigmoid,
    "Relu": lambda x: torch.clamp_min(x, 0), "Abs": torch.abs,
    "Sign": torch.sign, "Sqrt": torch.sqrt, "Rsqrt": torch.rsqrt,
    "Erf": torch.erf, "Sin": torch.sin, "Cos": torch.cos,
    "Floor": torch.floor, "Gelu": _gelu, "Silu": _silu,
}
for _opname, _fn in _UNARY.items():
    def _mk(fn):
        def run(node, args, ctx):
            return [_outcast(node, fn(args[0]))]
        return run
    EMIT[_opname] = _mk(_fn)


def _divide(a, b):
    if a.is_floating_point():
        return torch.div(a, b)
    return torch.div(a, b, rounding_mode="floor")


_BINOP = {
    "Add": torch.add, "Subtract": torch.sub, "Multiply": torch.mul,
    "Divide": _divide, "Power": torch.pow,
    "Maximum": torch.maximum, "Minimum": torch.minimum,
    "Less": torch.lt, "LessEqual": torch.le, "Greater": torch.gt,
    "GreaterEqual": torch.ge, "Equal": torch.eq, "NotEqual": torch.ne,
    "And": torch.logical_and, "Or": torch.logical_or,
}
for _opname, _fn in _BINOP.items():
    def _mk2(fn):
        def run(node, args, ctx):
            return [_outcast(node, fn(args[0], args[1]))]
        return run
    EMIT[_opname] = _mk2(_fn)


@_em("Not")
def _(node, args, ctx):
    return [torch.logical_not(args[0])]


@_em("Select")
def _(node, args, ctx):
    return [_outcast(node, torch.where(args[0], args[1], args[2]))]


@_em("Convert")
def _(node, args, ctx):
    return [args[0].to(torch_dtype(node.attrs["dtype"]))]


@_em("StopGradient")
def _(node, args, ctx):
    return [args[0].detach()]


@_em("OptimizationBarrier")
def _(node, args, ctx):
    return [args[0]]


@_em("ShardingConstraint")
def _(node, args, ctx):
    return [args[0]]   # one device: nothing to constrain


# -- shape --------------------------------------------------------------------
@_em("Reshape")
def _(node, args, ctx):
    return [args[0].reshape(node.attrs["shape"])]


@_em("Transpose")
def _(node, args, ctx):
    return [args[0].permute(tuple(node.attrs["perm"]))]


@_em("BroadcastInDim")
def _(node, args, ctx):
    shape = tuple(node.attrs["shape"])
    inter = [1] * len(shape)
    for i, d in enumerate(node.attrs["broadcast_dims"]):
        inter[d] = args[0].shape[i]
    return [args[0].reshape(inter).expand(shape)]


@_em("Slice")
def _(node, args, ctx):
    sl = tuple(slice(st, sp, sd) for st, sp, sd in zip(
        node.attrs["starts"], node.attrs["stops"], node.attrs["strides"]))
    return [args[0][sl]]


@_em("Concat")
def _(node, args, ctx):
    return [torch.cat(list(args), dim=node.attrs["axis"])]


@_em("Pad")
def _(node, args, ctx):
    pads: List[int] = []
    for lo, hi in reversed(list(zip(node.attrs["low"], node.attrs["high"]))):
        pads += [int(lo), int(hi)]
    return [F.pad(args[0], pads, value=float(node.attrs["value"]))]


@_em("Reverse")
def _(node, args, ctx):
    return [torch.flip(args[0], dims=tuple(node.attrs["axes"]))]


# -- reductions -----------------------------------------------------------
def _emit_reduce(fn):
    def run(node, args, ctx):
        x = _f32up(args[0])
        axes = tuple(node.attrs["axes"])
        out = fn(x, dim=axes, keepdim=bool(node.attrs["keepdims"])) \
            if axes else x
        return [_outcast(node, out)]
    return run


EMIT["ReduceSum"] = _emit_reduce(torch.sum)
EMIT["ReduceMax"] = _emit_reduce(torch.amax)
EMIT["ReduceMin"] = _emit_reduce(torch.amin)


@_em("CumSum")
def _(node, args, ctx):
    x = _f32up(args[0])
    with _fixed_order(x):
        out = torch.cumsum(x, dim=node.attrs["axis"])
    if node.attrs["exclusive"]:
        out = out - x
    return [_outcast(node, out)]


@_em("ArgMax")
def _(node, args, ctx):
    return [torch.argmax(args[0], dim=node.attrs["axis"]).to(torch.int32)]


@_em("TopK")
def _(node, args, ctx):
    # a stable descending sort: ties keep the lower index first, as
    # lax.top_k does
    v, i = torch.sort(args[0], dim=-1, descending=True, stable=True)
    k = node.attrs["k"]
    return [v[..., :k], i[..., :k].to(torch.int32)]


# -- contraction ----------------------------------------------------------
_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _dot_spec(a_nd: int, b_nd: int, contracting, batch) -> str:
    (lc, rc), (lb, rb) = contracting, batch
    it = iter(_LETTERS)
    a_sub: List[Optional[str]] = [None] * a_nd
    b_sub: List[Optional[str]] = [None] * b_nd
    for dl, dr in zip(lb, rb):
        c = next(it)
        a_sub[dl] = b_sub[dr] = c
    for dl, dr in zip(lc, rc):
        c = next(it)
        a_sub[dl] = b_sub[dr] = c
    a_free, b_free = [], []
    for i in range(a_nd):
        if a_sub[i] is None:
            a_sub[i] = next(it)
            a_free.append(a_sub[i])
    for i in range(b_nd):
        if b_sub[i] is None:
            b_sub[i] = next(it)
            b_free.append(b_sub[i])
    out_sub = [a_sub[d] for d in lb] + a_free + b_free
    return f"{''.join(a_sub)},{''.join(b_sub)}->{''.join(out_sub)}"


def _mm_f32(a, b):
    """``jnp.dot(a, b, preferred_element_type=f32)``: a plain product
    accumulated in f32 (sub-f32 operands upcast)."""
    return torch.matmul(_f32up(a), _f32up(b))


@_em("DotGeneral")
def _(node, args, ctx):
    a, b = args
    t = node.out_types[0]
    contracting = tuple(tuple(x) for x in node.attrs["contracting"])
    batch = tuple(tuple(x) for x in node.attrs["batch"])
    # plain matmul-shaped dots route through the Hopper tiled kernel when
    # the kernel takes the shape; batched einsums and one-hot
    # contractions stay plain products
    if ctx.use_pallas and b.ndim == 2 and a.ndim >= 2 and \
            (contracting, batch) == (((a.ndim - 1,), (0,)), ((), ())) and \
            _np_dtype(a) == _np_dtype(b) == t.dtype and is_float(t.dtype):
        rows = a.numel() // a.shape[-1]
        a2 = a.reshape(rows, a.shape[-1])
        if _k_matmul.supported(a2, b):
            return [_outcast(node, _k_matmul.matmul(a2, b).reshape(t.shape))]
    spec = _dot_spec(a.ndim, b.ndim, contracting, batch)
    if a.is_floating_point():
        out = torch.einsum(spec, _f32up(a), _f32up(b))
    else:
        # integer contractions (one-hot index picks): CUDA has no integer
        # GEMM, and f64 holds every sum below 2^53 exactly
        out = torch.einsum(spec, a.double(), b.double()).round()
    return [_outcast(node, out)]


# -- indexing ---------------------------------------------------------------
def _fill_value(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed else \
        torch.iinfo(dtype).max


@_em("Gather")
def _(node, args, ctx):
    """``jnp.take(x, idx, axis)``: negative indices count from the end,
    indices outside [-n, n) give the fill value (NaN for floats, the
    lowest integer for signed ints)."""
    x, idx = args
    ax = node.attrs["axis"]
    n = x.shape[ax]
    idx = idx.to(torch.int64)
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(valid, torch.where(idx < 0, idx + n, idx),
                       torch.zeros_like(idx))
    out = torch.index_select(x, ax, safe.reshape(-1))
    shape = tuple(x.shape[:ax]) + tuple(idx.shape) + tuple(x.shape[ax + 1:])
    out = out.reshape(shape)
    mask = valid.reshape((1,) * ax + tuple(idx.shape)
                         + (1,) * (x.ndim - ax - 1))
    fill = torch.full((), _fill_value(x.dtype), dtype=x.dtype,
                      device=x.device)
    return [torch.where(mask, out, fill)]


@_em("ScatterAdd")
def _(node, args, ctx):
    """``op.at[idx].add(upd)``: negative indices count from the end,
    updates at indices outside [-n, n) are dropped."""
    op, idx, upd = args
    n = op.shape[0]
    idx = idx.to(torch.int64).reshape(-1)
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(valid, torch.where(idx < 0, idx + n, idx),
                       torch.zeros_like(idx))
    upd = upd.to(op.dtype).reshape((idx.numel(),) + tuple(op.shape[1:]))
    keep = valid.reshape((-1,) + (1,) * (op.ndim - 1))
    upd = torch.where(keep, upd, torch.zeros((), dtype=op.dtype,
                                             device=op.device))
    with _fixed_order(op):
        return [op.clone().index_add_(0, safe, upd)]


def _clamped_index(start: torch.Tensor, dim: int, size: int,
                   device: torch.device) -> torch.Tensor:
    """``lax``'s start rule on the device (no host read of ``start``): a
    negative start counts from the end, then the start is clamped to
    [0, dim - size]; returns the ``size`` indices from there."""
    s = start.reshape(()).to(torch.int64)
    s = torch.clamp(torch.where(s < 0, s + dim, s), 0, dim - size)
    return s + torch.arange(size, device=device)


@_em("DynamicSlice")
def _(node, args, ctx):
    x = args[0]
    out = x
    for d, (start, size) in enumerate(zip(args[1:], node.attrs["sizes"])):
        if size == x.shape[d]:
            continue   # the clamp pins the start to 0
        out = torch.index_select(
            out, d, _clamped_index(start, x.shape[d], size, x.device))
    return [out]


@_em("DynamicUpdateSlice")
def _(node, args, ctx):
    x, upd = args[0], args[1]
    index = []
    for d, start in enumerate(args[2:]):
        ix = _clamped_index(start, x.shape[d], upd.shape[d], x.device)
        shape = [1] * x.ndim
        shape[d] = upd.shape[d]
        index.append(ix.reshape(shape))
    out = x.clone()
    out.index_put_(tuple(index), upd.to(x.dtype))
    return [out]


# -- compounds (kernel-selection points) ---------------------------------------
@_em("Softmax")
def _(node, args, ctx):
    return [_outcast(node, torch.softmax(_f32up(args[0]),
                                         dim=node.attrs["axis"]))]


@_em("LogSoftmax")
def _(node, args, ctx):
    return [_outcast(node, torch.log_softmax(_f32up(args[0]),
                                             dim=node.attrs["axis"]))]


@_em("RMSNorm")
def _(node, args, ctx):
    x, w = args
    if ctx.use_pallas and _k_rmsnorm.supported(x, w):
        return [_outcast(node, _k_rmsnorm.rmsnorm(x, w, node.attrs["eps"]))]
    xf = _f32up(x)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return [_outcast(node, xf * torch.rsqrt(var + node.attrs["eps"])
                     * _f32up(w))]


@_em("LayerNorm")
def _(node, args, ctx):
    x, w, b = (_f32up(a) for a in args)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return [_outcast(node, (x - mu) * torch.rsqrt(var + node.attrs["eps"])
                     * w + b)]


@_em("SwiGLU")
def _(node, args, ctx):
    x, wg, wu, wd = args
    t = node.out_types[0]
    d = x.shape[-1]
    rows = x.numel() // d
    if ctx.use_pallas and x.dtype == wg.dtype == wd.dtype:
        x2 = x.reshape(rows, d)
        if _k_swiglu.supported(x2, wg, wd):
            out = _k_swiglu.swiglu(x2, wg, wu, wd)
            return [_outcast(node, out.reshape(t.shape))]
    g = _silu(_mm_f32(x, wg).to(x.dtype))
    u = _mm_f32(x, wu).to(x.dtype)
    return [_outcast(node, _mm_f32(g * u, wd))]


@_em("NormMatmul")
def _(node, args, ctx):
    x, g, w = args
    t = node.out_types[0]
    d = x.shape[-1]
    rows = x.numel() // d
    eps = node.attrs["eps"]
    if ctx.use_pallas and x.dtype == w.dtype:
        x2 = x.reshape(rows, d)
        if _k_norm_matmul.supported(x2, w):
            out = _k_norm_matmul.norm_matmul(x2, g, w, eps=eps)
            return [_outcast(node, out.reshape(t.shape))]
    xf = _f32up(x)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    nrm = (xf * torch.rsqrt(var + eps) * _f32up(g)).to(x.dtype)
    return [_outcast(node, _mm_f32(nrm, w))]


@_em("RotaryQKV")
def _(node, args, ctx):
    x, wq, wk, wv, cos, sin = args
    at = node.attrs
    B, S, D = x.shape

    def mm(a2, w):
        # projections route through the Hopper tiled matmul; the rope
        # epilogue is elementwise and stays plain
        if ctx.use_pallas and x.dtype == w.dtype and \
                _k_matmul.supported(a2, w):
            return _k_matmul.matmul(a2, w)
        return _mm_f32(a2, w).to(x.dtype)

    def split(y, h):
        return y.reshape(B, S, h, -1).permute(0, 2, 1, 3)

    def rope(v4):
        half = v4.shape[-1] // 2
        x1, x2 = v4[..., :half], v4[..., half:]
        c = cos[None, None].to(v4.dtype)
        s = sin[None, None].to(v4.dtype)
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    x2d = x.reshape(B * S, D)
    q = rope(split(mm(x2d, wq), at["n_heads"]))
    k = rope(split(mm(x2d, wk), at["n_kv"]))
    v = split(mm(x2d, wv), at["n_kv"])
    return [_outcast(node, q, 0), _outcast(node, k, 1), _outcast(node, v, 2)]


def reference_attention(q, k, v, *, causal, window, scale, q_offset=None):
    """Plain attention (BHSD, GQA by head repeat, f32 scores and softmax,
    probabilities cast to v's dtype), the reference's
    ``reference_attention``."""
    _B, Hq, Sq, _D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq != Hkv:
        k = torch.repeat_interleave(k, Hq // Hkv, dim=1)
        v = torch.repeat_interleave(v, Hq // Hkv, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", _f32up(q), _f32up(k)) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    scores = torch.where(mask, scores, torch.full((), -1e30,
                                                  device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", _f32up(probs.to(v.dtype)),
                        _f32up(v)).to(v.dtype)


@_em("Attention")
def _(node, args, ctx):
    at = node.attrs
    q, k, v = args[:3]
    q_offset = args[3] if at["has_offset"] else None
    if ctx.use_pallas and q.ndim == 4 and q.shape[-1] % 128 == 0 and \
            _k_flash.supported(q, k, v):
        return [_outcast(node, _k_flash.flash_attention(
            q, k, v, causal=at["causal"], window=at["window"],
            scale=at["scale"], q_offset=q_offset))]
    Sq, Skv = q.shape[2], k.shape[2]
    if ctx.attn_impl == "chunked" or (
            ctx.attn_impl == "auto" and Sq > 1 and Skv > 2048
            and Skv % ctx.attn_chunk == 0):
        return [_outcast(node, chunked_attention(
            q, k, v, causal=at["causal"], window=at["window"],
            scale=at["scale"], q_offset=q_offset, bk=ctx.attn_chunk))]
    return [_outcast(node, reference_attention(
        q, k, v, causal=at["causal"], window=at["window"],
        scale=at["scale"], q_offset=q_offset))]


@_em("SoftmaxCrossEntropy")
def _(node, args, ctx):
    logits, labels = args
    lg = _f32up(logits)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None].to(torch.int64))[..., 0]
    return [(lse - ll).to(torch.float32)]


def _later(op: str, slice_name: str):
    def run(node, args, ctx):
        raise NotImplementedError(f"{op} comes with {slice_name}")
    return run


for _opname in ("AllReduce", "AllGather", "ReduceScatter", "AllToAll",
                "CollectivePermute"):
    EMIT[_opname] = _later(_opname, _LATER_TP)
EMIT["LinearRecurrence"] = _later(
    "LinearRecurrence", "the recurrent-family slice of the torch port")


# -- structured control -------------------------------------------------------
@_em("Scan")
def _(node, args, ctx):
    """``lax.scan`` as a Python loop: xs are sliced along axis 0, ys are
    stacked at the step's index (``reverse`` walks the steps backwards
    and still stores step t's y at index t).  The body's loop-invariant
    nodes run once, before the first step (:class:`ScanBody`)."""
    at = node.attrs
    nc, nx = at["n_carry"], at["n_xs"]
    carries = list(args[:nc])
    xs = list(args[nc:nc + nx])
    consts = list(args[nc + nx:])
    body = ctx.scan_body(at["body"], nc + nx)
    length = at["length"]
    n_ys = len(node.out_types) - nc
    ys: List[List[Any]] = [[None] * length for _ in range(n_ys)]
    order = range(length - 1, -1, -1) if at["reverse"] else range(length)
    base = body.prologue(consts) if length else None
    for t in order:
        outs = body.step(base, carries + [x[t] for x in xs])
        carries = list(outs[:nc])
        for j in range(n_ys):
            ys[j][t] = outs[nc + j]
    stacked = []
    for j in range(n_ys):
        if length:
            stacked.append(torch.stack(ys[j]))
        else:
            ty = node.out_types[nc + j]
            stacked.append(torch.empty(ty.shape, dtype=torch_dtype(ty.dtype),
                                       device=ctx.device))
    return carries + stacked


# ---------------------------------------------------------------------------
# (emit, node, input slots, first output slot, slots dead after the step)
_Step = Tuple[Callable, Node, List[int], int, List[int]]


class _Slots:
    """An optimized Function's values as integer slots: each node's
    outputs take consecutive slots; Constant and Iota become device
    tensors once, here."""

    def __init__(self, fn: Function, ctx: EmitCtx):
        self.nodes = fn.nodes()
        for n in self.nodes:
            if n.op != "Parameter" and n.op not in EMIT \
                    and n.op not in _LEAVES:
                raise NotImplementedError(
                    f"torch backend: no emitter for {n.op}")
        self.of: Dict[int, int] = {}   # id(node) -> first slot of its outputs
        self.n = 0
        for n in self.nodes:
            self.of[id(n)] = self.n
            self.n += len(n.out_types)
        self.params = [self.of[id(p)] for p in fn.parameters]
        self.results = [self.of[id(r.node)] + r.index for r in fn.results]
        self.leaves: Dict[int, torch.Tensor] = {
            self.of[id(n)]: _LEAVES[n.op](n, ctx)
            for n in self.nodes if n.op in _LEAVES}

    def plan(self, nodes: List[Node], keep) -> List[_Step]:
        """``nodes`` (in order) as steps that drop each slot right after
        its last use, except the slots in ``keep`` and the leaves."""
        steps = []
        last_use: Dict[int, int] = {}
        for n in nodes:
            ins = [self.of[id(v.node)] + v.index for v in n.inputs]
            for s in ins:
                last_use[s] = len(steps)
            steps.append((EMIT[n.op], n, ins, self.of[id(n)]))
        frees: List[List[int]] = [[] for _ in steps]
        for s, i in last_use.items():
            if s not in keep and s not in self.leaves:
                frees[i].append(s)
        return [(emit, n, ins, out0, frees[i])
                for i, (emit, n, ins, out0) in enumerate(steps)]


def _execute(plan: List[_Step], env: List[Any], ctx: EmitCtx,
             name: str) -> None:
    """Run ``plan`` over ``env`` in place.  An exception leaves with a
    note naming the op it came from (a capture that fails names it)."""
    try:
        for emit, node, ins, out0, dead in plan:
            outs = emit(node, [env[s] for s in ins], ctx)
            for j, o in enumerate(outs):
                env[out0 + j] = o
            for s in dead:
                env[s] = None
    except Exception as exc:
        exc.add_note(f"while running {node.op} {node.name!r} in {name}")
        raise


class ScanBody:
    """A Scan body split at its loop invariants.

    The first ``n_variant`` parameters change every step (carries, then
    xs); the rest are the Scan's consts.  A node is invariant when every
    input is a const, a leaf or another invariant node: ``prologue``
    evaluates those once per Scan execution, and ``step`` runs the rest
    for one step.  A hoisted op is the same op on the same values, so
    every output is bitwise the one a plain per-step walk gives; the IR
    is unchanged.  (XLA's while-loop invariant code motion does this for
    the reference, so an f32 weight a chunk step converts to bf16 is
    converted once per dispatch on both sides.)"""

    def __init__(self, fn: Function, ctx: EmitCtx, n_variant: int):
        self.ctx = ctx
        self.name = fn.name
        sl = self.slots = _Slots(fn, ctx)
        inv = {id(p) for p in fn.parameters[n_variant:]}
        hoisted, rest = [], []
        for n in sl.nodes:
            if n.op == "Parameter" or n.op in _LEAVES:
                continue
            if all(id(v.node) in inv or v.node.op in _LEAVES
                   for v in n.inputs):
                inv.add(id(n))
                hoisted.append(n)
            else:
                rest.append(n)
        # the base environment each step starts from: leaves, consts and
        # the hoisted values a step or a result reads
        needed = set(sl.results)
        for n in rest:
            for v in n.inputs:
                if id(v.node) in inv:
                    needed.add(sl.of[id(v.node)] + v.index)
        self.const_slots = sl.params[n_variant:]
        self.variant_slots = sl.params[:n_variant]
        self.pro_plan = sl.plan(hoisted, needed)
        # a step frees slots in its own copy of the base only
        self.step_plan = sl.plan(rest, set(sl.results))

    def prologue(self, consts: List[Any]) -> List[Any]:
        env: List[Any] = [None] * self.slots.n
        for s, t in self.slots.leaves.items():
            env[s] = t
        for s, a in zip(self.const_slots, consts):
            env[s] = a
        _execute(self.pro_plan, env, self.ctx, self.name)
        return env

    def step(self, base: List[Any], variant: List[Any]) -> List[Any]:
        env = list(base)
        for s, a in zip(self.variant_slots, variant):
            env[s] = a
        _execute(self.step_plan, env, self.ctx, self.name)
        return [env[s] for s in self.slots.results]


def emit_callable(fn: Function, ctx: EmitCtx) -> Callable:
    """Emit ``fn`` as a Python callable over torch tensors on
    ``ctx.device``.

    Constants and iotas become device tensors once, here.  The walk is
    flattened into a list of steps over integer value slots, and a value
    is dropped from the slot table right after its last use, so a
    dispatch holds only the live intermediates (and a donated input the
    caller no longer references can be reused by the allocator)."""
    sl = _Slots(fn, ctx)
    plan = sl.plan([n for n in sl.nodes
                    if n.op != "Parameter" and n.op not in _LEAVES],
                   set(sl.results))
    dev = ctx.device
    name = fn.name
    n_params = len(fn.parameters)

    def run(*args):
        if len(args) != n_params:
            raise TypeError(f"{name}: expected {n_params} args, "
                            f"got {len(args)}")
        env: List[Any] = [None] * sl.n
        for s, a in zip(sl.params, args):
            env[s] = a if isinstance(a, torch.Tensor) and a.device == dev \
                else as_tensor(a, dev)
        for s, t in sl.leaves.items():
            env[s] = t
        _execute(plan, env, ctx, name)
        return tuple(env[s] for s in sl.results)

    run.__name__ = f"ngraph_{fn.name}"
    return run
