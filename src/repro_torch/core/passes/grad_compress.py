"""Gradient compression: rewrite f32 AllReduce to bf16 (or f8) on the wire.

A distributed-optimization trick for multi-pod training: gradient
all-reduce bytes halve at the cost of reduced mantissa; error stays
bounded because the optimizer consumes the result immediately.
"""
from __future__ import annotations

from typing import List, Optional

from .. import ops
from ..function import Function, transform
from ..node import Node, Value
from ..types import as_dtype
from .base import Pass


class CompressAllReduce(Pass):
    name = "grad-compress"

    def __init__(self, wire_dtype: str = "bf16"):
        self.wire_dtype = wire_dtype

    def run(self, fn: Function):
        stats = {"compressed": 0}
        wire = as_dtype(self.wire_dtype)

        def rule(node: Node, ins: List[Value]) -> Optional[List[Value]]:
            if node.op != "AllReduce":
                return None
            x = ins[0]
            if x.dtype != as_dtype("f32") or x.type.nbytes < (1 << 16):
                return None  # only big f32 reductions benefit
            stats["compressed"] += 1
            small = ops.convert(x, wire)
            red = ops.all_reduce(small, node.attrs["axis_name"],
                                 node.attrs["reduce_op"])
            return [ops.convert(red, "f32")]

        return transform(fn, rule, name=fn.name), stats
