"""Dead-code elimination: graphs are defined by reachability from results,
so DCE is a rebuild + report."""
from __future__ import annotations

from ..function import Function
from .base import Pass


class DCE(Pass):
    name = "dce"

    def run(self, fn: Function):
        # transform() naturally drops unreachable nodes; counting only
        rebuilt = Function(fn.parameters, fn.results, fn.name)
        return rebuilt, {"live_nodes": len(rebuilt.nodes())}
