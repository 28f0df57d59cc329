"""Decompose compound ops into primitive ops.

Two uses:
  * the *paper-faithful baseline* emission (compounds realized by generic
    primitives — the graph a bridge would hand an unsophisticated backend);
  * the round-trip oracle for the fusion pass (decompose -> fuse -> same
    compounds back).
"""
from __future__ import annotations

import math
from typing import List, Optional

from .. import ops
from ..function import Function, transform
from ..node import Node, Value
from .base import Pass


def decompose_softmax(x: Value, axis: int) -> Value:
    m = ops.reduce_max(x, [axis], keepdims=True)
    e = ops.exp(ops.subtract(x, ops.broadcast_to(m, x.shape)))
    s = ops.reduce_sum(e, [axis], keepdims=True)
    return ops.divide(e, ops.broadcast_to(s, x.shape))


def decompose_rmsnorm(x: Value, w: Value, eps: float) -> Value:
    xf = ops.convert(x, "f32")
    var = ops.reduce_mean(ops.multiply(xf, xf), [-1], keepdims=True)
    r = ops.rsqrt(ops.add(var, ops.constant(eps, dtype="f32")))
    y = ops.multiply(ops.multiply(xf, ops.broadcast_to(r, xf.shape)),
                     ops.broadcast_to(ops.convert(w, "f32"), xf.shape))
    return ops.convert(y, x.dtype)


def decompose_swiglu(x: Value, w_gate: Value, w_up: Value,
                     w_down: Value) -> Value:
    """Mirror of ``components.apply_mlp``'s swiglu emission (minus the
    sharding constraints, which the fusion matcher skips over)."""
    g = ops.silu(ops.matmul(x, w_gate))
    u = ops.matmul(x, w_up)
    return ops.matmul(ops.multiply(g, u), w_down)


def decompose_norm_matmul(x: Value, weight: Value, w: Value,
                          eps: float) -> Value:
    return ops.matmul(ops.rms_norm(x, weight, eps=eps), w)


def _split_heads(y: Value, n_heads: int) -> Value:
    B, S, HD = y.shape
    d = HD // n_heads
    return ops.transpose(ops.reshape(y, (B, S, n_heads, d)), (0, 2, 1, 3))


def _apply_rope(t: Value, cos: Value, sin: Value) -> Value:
    """Rotate-half rope, op-for-op the ``components.apply_rope`` emission."""
    B, H, S, D = t.shape
    half = D // 2
    x1 = ops.slice_(t, [0, 0, 0, 0], [B, H, S, half])
    x2 = ops.slice_(t, [0, 0, 0, half], [B, H, S, D])
    c = ops.convert(ops.broadcast_to(ops.reshape(cos, (1, 1, S, half)),
                                     (B, H, S, half)), t.dtype)
    s = ops.convert(ops.broadcast_to(ops.reshape(sin, (1, 1, S, half)),
                                     (B, H, S, half)), t.dtype)
    return ops.concat([ops.subtract(ops.multiply(x1, c), ops.multiply(x2, s)),
                       ops.add(ops.multiply(x2, c), ops.multiply(x1, s))],
                      axis=3)


def decompose_rotary_qkv(node: Node, ins: List[Value]) -> List[Value]:
    x, wq, wk, wv, cos, sin = ins
    n_heads = node.attrs["n_heads"]
    n_kv = node.attrs["n_kv"]
    q = _split_heads(ops.matmul(x, wq), n_heads)
    k = _split_heads(ops.matmul(x, wk), n_kv)
    v = _split_heads(ops.matmul(x, wv), n_kv)
    return [_apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v]


def decompose_attention(node: Node) -> Value:
    at = node.attrs
    q, k, v = node.inputs[:3]
    q_offset = node.inputs[3] if at["has_offset"] else None
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = Hq // Hkv
    qf = ops.convert(q, "f32")
    kf = ops.convert(k, "f32")
    vf = ops.convert(v, "f32")
    q5 = ops.reshape(qf, (B, Hkv, rep, Sq, D))
    scores = ops.multiply(ops.einsum("bhrqd,bhkd->bhrqk", q5, kf),
                          ops.broadcast_to(ops.constant(at["scale"], dtype="f32"),
                                           (B, Hkv, rep, Sq, Skv)))
    qpos = ops.iota((Sq, Skv), 0, "i32")
    if q_offset is not None:
        qpos = ops.add(qpos, ops.broadcast_to(ops.reshape(q_offset, (1, 1)), (Sq, Skv)))
    kpos = ops.iota((Sq, Skv), 1, "i32")
    mask = ops.broadcast_to(ops.constant(True), (Sq, Skv))
    if at["causal"]:
        mask = ops.logical_and(mask, ops.less_equal(kpos, qpos))
    if at["window"] is not None:
        w = ops.constant(at["window"], dtype="i32")
        mask = ops.logical_and(mask, ops.greater(kpos, ops.subtract(qpos, ops.broadcast_to(w, (Sq, Skv)))))
    maskb = ops.broadcast_to(ops.reshape(mask, (1, 1, 1, Sq, Skv)), scores.shape)
    neg = ops.broadcast_to(ops.constant(-1e30, dtype="f32"), scores.shape)
    scores = ops.select(maskb, scores, neg)
    p = decompose_softmax(scores, axis=4)
    out = ops.einsum("bhrqk,bhkd->bhrqd", p, vf)
    return ops.convert(ops.reshape(out, (B, Hq, Sq, Dv)), q.dtype)


class Decompose(Pass):
    """Expand compound ops into primitives.  ``keep`` lists compounds to
    leave alone (e.g. keep Attention but expand norms)."""

    name = "decompose"

    def __init__(self, keep: Optional[List[str]] = None):
        self.keep = set(keep or [])

    def run(self, fn: Function):
        stats = {"expanded": 0}

        def rule(node: Node, ins: List[Value]) -> Optional[List[Value]]:
            op = node.op
            if op in self.keep:
                return None
            if op == "Softmax":
                stats["expanded"] += 1
                return [decompose_softmax(ins[0], node.attrs["axis"])]
            if op == "LogSoftmax":
                x = ins[0]
                ax = node.attrs["axis"]
                stats["expanded"] += 1
                m = ops.reduce_max(x, [ax], keepdims=True)
                s = ops.subtract(x, ops.broadcast_to(m, x.shape))
                lse = ops.log(ops.reduce_sum(ops.exp(s), [ax], keepdims=True))
                return [ops.subtract(s, ops.broadcast_to(lse, x.shape))]
            if op == "RMSNorm":
                stats["expanded"] += 1
                return [decompose_rmsnorm(ins[0], ins[1], node.attrs["eps"])]
            if op == "Gelu":
                x = ins[0]
                stats["expanded"] += 1
                half = ops.constant(0.5, dtype=x.dtype)
                one = ops.constant(1.0, dtype=x.dtype)
                isq2 = ops.constant(1.0 / math.sqrt(2.0), dtype=x.dtype)
                return [ops.multiply(
                    ops.multiply(ops.broadcast_to(half, x.shape), x),
                    ops.add(ops.broadcast_to(one, x.shape),
                            ops.erf(ops.multiply(x, ops.broadcast_to(isq2, x.shape)))))]
            if op == "Silu":
                x = ins[0]
                stats["expanded"] += 1
                return [ops.multiply(x, ops.sigmoid(x))]
            if op == "Attention":
                stats["expanded"] += 1
                clone = Node(node.op, ins, dict(node.attrs), node.out_types)
                return [decompose_attention(clone)]
            if op == "SwiGLU":
                stats["expanded"] += 1
                return [decompose_swiglu(*ins)]
            if op == "NormMatmul":
                stats["expanded"] += 1
                return [decompose_norm_matmul(ins[0], ins[1], ins[2],
                                              node.attrs["eps"])]
            if op == "RotaryQKV":
                stats["expanded"] += 1
                return decompose_rotary_qkv(node, ins)
            if op == "SoftmaxCrossEntropy":
                logits, labels = ins
                stats["expanded"] += 1
                lg = ops.convert(logits, "f32")
                ls = ops.log_softmax(lg, axis=-1)
                oh = ops.one_hot(labels, logits.shape[-1], dtype="f32")
                return [ops.negative(ops.reduce_sum(ops.multiply(ls, oh), [-1]))]
            return None

        # iterate: rules may emit fresh compounds (e.g. xent -> LogSoftmax)
        out = fn
        for _ in range(4):
            before = stats["expanded"]
            out = transform(out, rule, name=fn.name)
            if stats["expanded"] == before:
                break
        return out, stats
