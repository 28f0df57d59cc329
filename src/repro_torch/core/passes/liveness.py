"""Liveness analysis (paper sec. 4: transformers provide liveness
analysis used for memory management)."""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..function import Function
from ..node import Node, Value

ValueKey = Tuple[int, int]  # (node id(), output index)


def liveness_intervals(fn: Function):
    """Return (order, intervals) where intervals maps value-key ->
    [def_index, last_use_index].  Results stay live to the end; parameters
    are defined at -1 (live on entry)."""
    order: List[Node] = fn.nodes()
    pos = {id(n): i for i, n in enumerate(order)}
    intervals: Dict[ValueKey, List[int]] = {}
    for n in order:
        d = -1 if n.op == "Parameter" else pos[id(n)]
        for i in range(n.n_outputs):
            intervals[(id(n), i)] = [d, d]
    for n in order:
        for v in n.inputs:
            intervals[(id(v.node), v.index)][1] = pos[id(n)]
    end = len(order)
    for r in fn.results:
        intervals[(id(r.node), r.index)][1] = end
    return order, intervals
