"""Constant folding: evaluate nodes whose inputs are all Constants using
the interpreter's op table (one evaluator, two uses — same trick nGraph's
INTERPRETER backend enables)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import ops
from ..function import Function, transform
from ..node import Node, Value
from .base import Pass

# ops never folded (stateful-ish / distribution / control)
_SKIP = {"Parameter", "Constant", "Scan", "AllReduce", "AllGather",
         "ReduceScatter", "AllToAll", "CollectivePermute",
         "ShardingConstraint", "StopGradient"}

_MAX_FOLD_ELEMS = 1 << 22  # don't materialize constants > 4M elements


class ConstantFolding(Pass):
    name = "constant-folding"

    def run(self, fn: Function):
        from ...transformers.interpreter import EVAL

        stats = {"folded": 0}

        def rule(node: Node, new_inputs: List[Value]) -> Optional[List[Value]]:
            if node.op in _SKIP or node.op not in EVAL:
                return None
            if not new_inputs:
                if node.op != "Iota":
                    return None
            if not all(v.node.op == "Constant" for v in new_inputs):
                return None
            if sum(t.size for t in node.out_types) > _MAX_FOLD_ELEMS:
                return None
            args = [v.node.attrs["value"] for v in new_inputs]
            try:
                outs = EVAL[node.op](node, args)
            except Exception:
                return None
            # raw EVAL rules don't normalize shapes the way execution does
            # (a () x (1,) broadcast yields (1,) for a ()-typed node): conform
            # each folded value to its declared type or leave the node alone
            arrs = []
            for o, t in zip(outs, node.out_types):
                arr = np.ascontiguousarray(np.asarray(o, dtype=t.dtype))
                if arr.shape != t.shape:
                    if arr.size != t.size:
                        return None
                    arr = arr.reshape(t.shape)
                arrs.append(arr)
            stats["folded"] += 1
            return [ops.constant(a, dtype=t.dtype)
                    for a, t in zip(arrs, node.out_types)]

        return transform(fn, rule, name=fn.name), stats
