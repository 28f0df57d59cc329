"""Algebraic simplification: identity/zero folding, involution collapsing."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import ops
from ..function import Function, transform
from ..node import Node, Value
from ..pattern import is_scalar_const, scalar_of
from .base import Pass


def _is_full_const(v: Value, value: float) -> bool:
    n = v.node
    if n.op == "Constant":
        arr = n.attrs["value"]
        return bool(np.all(arr == value))
    if n.op == "BroadcastInDim":
        return _is_full_const(n.inputs[0], value)
    return False


class AlgebraicSimplify(Pass):
    name = "algebraic"

    def run(self, fn: Function):
        stats = {"rewrites": 0}

        def hit(v):
            stats["rewrites"] += 1
            return v

        def rule(node: Node, ins: List[Value]) -> Optional[List[Value]]:
            op = node.op
            if op == "Add":
                a, b = ins
                if _is_full_const(b, 0.0):
                    return hit([a])
                if _is_full_const(a, 0.0):
                    return hit([b])
            elif op == "Subtract":
                a, b = ins
                if _is_full_const(b, 0.0):
                    return hit([a])
            elif op == "Multiply":
                a, b = ins
                if _is_full_const(b, 1.0):
                    return hit([a])
                if _is_full_const(a, 1.0):
                    return hit([b])
                if _is_full_const(b, 0.0):
                    return hit([b])
                if _is_full_const(a, 0.0):
                    return hit([a])
            elif op == "Divide":
                a, b = ins
                if _is_full_const(b, 1.0):
                    return hit([a])
            elif op == "Power":
                a, b = ins
                if _is_full_const(b, 1.0):
                    return hit([a])
                if _is_full_const(b, 2.0):
                    return hit([ops.multiply(a, a)])
            elif op == "Negative":
                if ins[0].node.op == "Negative":
                    return hit([ins[0].node.inputs[0]])
            elif op == "Transpose":
                inner = ins[0].node
                if inner.op == "Transpose":
                    outer_perm = node.attrs["perm"]
                    inner_perm = inner.attrs["perm"]
                    comp = tuple(inner_perm[p] for p in outer_perm)
                    return hit([ops.transpose(inner.inputs[0], comp)])
                if node.attrs["perm"] == tuple(range(len(node.attrs["perm"]))):
                    return hit([ins[0]])
            elif op == "Reshape":
                inner = ins[0].node
                if inner.op == "Reshape":
                    return hit([ops.reshape(inner.inputs[0], node.attrs["shape"])])
                if node.attrs["shape"] == ins[0].shape:
                    return hit([ins[0]])
            elif op == "Convert":
                inner = ins[0].node
                if node.attrs["dtype"] == ins[0].dtype:
                    return hit([ins[0]])
                if inner.op == "Convert":
                    src = inner.inputs[0]
                    # collapse only if no precision was dropped in between
                    if src.dtype.itemsize <= ins[0].dtype.itemsize:
                        return hit([ops.convert(src, node.attrs["dtype"])])
            elif op == "Select":
                c, a, b = ins
                if _is_full_const(c, True):
                    return hit([a])
                if _is_full_const(c, False):
                    return hit([b])
            elif op == "BroadcastInDim":
                if node.attrs["shape"] == ins[0].shape and \
                        node.attrs["broadcast_dims"] == tuple(range(ins[0].rank)):
                    return hit([ins[0]])
            elif op == "Pad":
                if all(l == 0 for l in node.attrs["low"]) and \
                        all(h == 0 for h in node.attrs["high"]):
                    return hit([ins[0]])
            elif op == "Slice":
                if node.out_types[0].shape == ins[0].shape and \
                        all(s == 0 for s in node.attrs["starts"]) and \
                        all(st == 1 for st in node.attrs["strides"]):
                    return hit([ins[0]])
            elif op == "Concat":
                if len(ins) == 1:
                    return hit([ins[0]])
            return None

        return transform(fn, rule, name=fn.name), stats
