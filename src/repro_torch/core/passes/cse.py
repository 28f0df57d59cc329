"""Common-subexpression elimination."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..function import Function, transform
from ..node import Node, Value
from .base import Pass


def _attr_key(v):
    if isinstance(v, np.ndarray):
        if v.size <= 1024:
            return ("arr", v.shape, str(v.dtype), v.tobytes())
        return ("bigarr", id(v))
    if isinstance(v, Function):
        return ("fn", id(v))
    if isinstance(v, np.dtype):
        return ("dt", str(v))
    if isinstance(v, (list, tuple)):
        return tuple(_attr_key(x) for x in v)
    return v


class CSE(Pass):
    name = "cse"

    def run(self, fn: Function):
        stats = {"merged": 0}
        table: Dict[Tuple, List[Value]] = {}

        def rule(node: Node, new_inputs: List[Value]) -> Optional[List[Value]]:
            if node.op == "Parameter":
                return None
            key = (
                node.op,
                tuple((id(v.node), v.index) for v in new_inputs),
                tuple(sorted((k, _attr_key(v)) for k, v in node.attrs.items())),
            )
            if key in table:
                stats["merged"] += 1
                return table[key]
            # keep (possibly rewritten-input) node: register canonical outputs
            if all(a is b or a == b for a, b in zip(new_inputs, node.inputs)):
                outs = node.outs()
            else:
                clone = Node(node.op, new_inputs, dict(node.attrs), node.out_types)
                outs = clone.outs()
                table[key] = list(outs)
                return list(outs)
            table[key] = list(outs)
            return None

        return transform(fn, rule, name=fn.name), stats
