"""IR-level cost model: exact FLOPs / bytes-moved per Function.

XLA's ``cost_analysis()`` counts while-loop bodies once (scan trip counts
are invisible to it), so a scanned 80-layer model under-reports by ~80x.
The IR knows every Scan length, so this walk gives the true per-step
numbers; the dry-run records both and the roofline uses these.

Bytes are "HBM traffic" estimates: every op reads its inputs and writes
its outputs once (fusion makes this an upper bound for elementwise
chains; for the big contractions it is the right order).  The Attention
compound is parameterized by its backend realization:

  * "chunked"/"naive": the (Sq x Skv) score/prob tensors are written and
    re-read once in f32 — what the XLA emission does;
  * "flash": scores never leave VMEM (the Pallas kernel) — only q/k/v/out
    move.  The delta between these two IS the kernel-selection win.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from .function import Function
from .node import Node

# flops per element for transcendental-ish unaries
_TRANS = {"Exp", "Log", "Log1p", "Expm1", "Tanh", "Sigmoid", "Erf", "Sin",
          "Cos", "Gelu", "Silu", "Sqrt", "Rsqrt", "Power"}
_CHEAP = {"Negative", "Abs", "Sign", "Floor", "Add", "Subtract", "Multiply",
          "Divide", "Maximum", "Minimum", "Less", "LessEqual", "Greater",
          "GreaterEqual", "Equal", "NotEqual", "And", "Or", "Not", "Select",
          "Convert"}
_FREE = {"Parameter", "Constant", "Iota", "Reshape", "Transpose",
         "BroadcastInDim", "Slice", "Concat", "Pad", "Reverse",
         "StopGradient", "ShardingConstraint", "DynamicSlice",
         "DynamicUpdateSlice", "Gather", "ScatterAdd", "ArgMax"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    by_op: Optional[Dict[str, float]] = None

    def add(self, op: str, flops: float, bytes_: float, mult: float = 1.0):
        self.flops += flops * mult
        self.bytes += bytes_ * mult
        if self.by_op is not None:
            self.by_op[op] = self.by_op.get(op, 0.0) + flops * mult


def _io_bytes(node: Node) -> float:
    b = sum(v.type.nbytes for v in node.inputs)
    b += sum(t.nbytes for t in node.out_types)
    return float(b)


def _node_cost(node: Node, cost: Cost, mult: float, attn_impl: str) -> None:
    op = node.op
    out_elems = sum(t.size for t in node.out_types)
    if op == "Scan":
        body: Function = node.attrs["body"]
        inner = function_cost(body, attn_impl=attn_impl,
                              by_op=cost.by_op is not None)
        L = node.attrs["length"]
        cost.add("Scan", inner.flops, inner.bytes, mult * L)
        if cost.by_op is not None and inner.by_op:
            for k, v in inner.by_op.items():
                cost.by_op[k] = cost.by_op.get(k, 0.0) + v * mult * L
        # xs/ys stacked traffic is already counted by the body reads/writes
        return
    if op == "DotGeneral":
        (lc, _rc) = node.attrs["contracting"]
        a = node.inputs[0]
        k = 1
        for d in lc:
            k *= a.shape[d]
        cost.add(op, 2.0 * out_elems * k, _io_bytes(node), mult)
        return
    if op == "Attention":
        q, kk, v = node.inputs[:3]
        B, Hq, Sq, Dk = q.shape
        Skv = kk.shape[2]
        Dv = v.shape[-1]
        causal = node.attrs.get("causal", False)
        win = node.attrs.get("window")
        eff = Skv
        if win is not None:
            eff = min(win, Skv)
        elif causal and Sq == Skv:
            eff = Skv / 2.0
        flops = 2.0 * B * Hq * Sq * eff * (Dk + Dv) + 5.0 * B * Hq * Sq * eff
        bytes_ = _io_bytes(node)
        if attn_impl != "flash":
            bytes_ += 2.0 * B * Hq * Sq * eff * 4.0  # scores+probs, f32
        cost.add(op, flops, bytes_, mult)
        return
    if op == "SwiGLU":
        x, wg, _wu, wd = node.inputs
        D, F = wg.shape
        Do = wd.shape[1]
        rows = out_elems / max(Do, 1)
        flops = 2.0 * rows * D * F * 2 + 6.0 * rows * F + 2.0 * rows * F * Do
        cost.add(op, flops, _io_bytes(node), mult)
        return
    if op == "NormMatmul":
        x, _w, w2 = node.inputs
        D, N = w2.shape
        rows = out_elems / max(N, 1)
        cost.add(op, 2.0 * rows * D * N + 5.0 * rows * D,
                 _io_bytes(node), mult)
        return
    if op == "RotaryQKV":
        x, wq, wk, _wv = node.inputs[:4]
        B, S, D = x.shape
        proj = 2.0 * B * S * D * (wq.shape[1] + 2 * wk.shape[1])
        tq, tk = node.out_types[0], node.out_types[1]
        rope = 6.0 * (tq.size + tk.size)
        cost.add(op, proj + rope, _io_bytes(node), mult)
        return
    if op in ("Softmax", "LogSoftmax"):
        cost.add(op, 5.0 * out_elems, _io_bytes(node), mult)
        return
    if op == "RMSNorm":
        cost.add(op, 5.0 * out_elems, _io_bytes(node), mult)
        return
    if op == "LayerNorm":
        cost.add(op, 7.0 * out_elems, _io_bytes(node), mult)
        return
    if op == "SoftmaxCrossEntropy":
        logits = node.inputs[0]
        cost.add(op, 5.0 * logits.type.size, _io_bytes(node), mult)
        return
    if op == "LinearRecurrence":
        # associative scan: ~3 elementwise ops per element per log2(S) level
        axis = node.attrs["axis"]
        S = node.inputs[0].shape[axis]
        levels = max(1, math.ceil(math.log2(max(S, 2))))
        cost.add(op, 3.0 * out_elems * levels,
                 _io_bytes(node) * max(1, levels // 2), mult)
        return
    if op in ("ReduceSum", "ReduceMax", "ReduceMin", "CumSum"):
        cost.add(op, float(node.inputs[0].type.size), _io_bytes(node), mult)
        return
    if op == "TopK":
        x = node.inputs[0]
        k = node.attrs["k"]
        cost.add(op, float(x.type.size) * max(1, int(math.log2(max(k, 2)))),
                 _io_bytes(node), mult)
        return
    if op in ("AllReduce", "AllGather", "ReduceScatter", "AllToAll",
              "CollectivePermute"):
        cost.add(op, 0.0, _io_bytes(node), mult)
        return
    if op in _TRANS or op in _CHEAP:
        # producer-fusion model: elementwise ops fuse into chains, so
        # each op pays its output write only; reads happen once at the
        # chain boundary (paid by the non-elementwise consumer's input
        # accounting).  Without this, a 10-op fused chain would be
        # charged 10x the traffic XLA actually emits.
        out_bytes = float(sum(t.nbytes for t in node.out_types))
        flops = (4.0 if op in _TRANS else 1.0) * out_elems
        cost.add(op, flops, out_bytes, mult)
        return
    if op in _FREE:
        # pure data movement: bytes only (Gather/Scatter move real data)
        moved = _io_bytes(node) if op in (
            "Gather", "ScatterAdd", "DynamicSlice", "DynamicUpdateSlice",
            "Concat", "Pad", "Slice", "Reverse", "Transpose") else 0.0
        cost.add(op, 0.0, moved, mult)
        return
    # default: elementwise-ish
    cost.add(op, float(out_elems), _io_bytes(node), mult)


def function_cost(fn: Function, attn_impl: str = "chunked",
                  by_op: bool = False) -> Cost:
    cost = Cost(by_op={} if by_op else None)
    for node in fn.nodes():
        _node_cost(node, cost, 1.0, attn_impl)
    return cost
