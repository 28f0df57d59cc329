"""Layout assignment (paper sec. 2/4: the IR keeps *no fixed relationship
between axis order and tensor element layout*; transformers combine layout
and shape management with kernel selection).

On this backend, layout choice materializes as *where transposes live*:
the pass (a) collapses transpose chains, (b) sinks transposes into
DotGeneral by remapping contraction/batch dims (so the data is consumed in
its producer layout — no copy), and (c) reports how many contractions are
already in backend-preferred (contract-minor) layout for the MXU.
"""
from __future__ import annotations

from typing import List, Optional

from .. import ops
from ..function import Function, transform
from ..node import Node, Value
from .base import Pass


class LayoutAssignment(Pass):
    name = "layout"

    def run(self, fn: Function):
        stats = {"transposes_sunk": 0, "transposes_collapsed": 0,
                 "contract_minor": 0, "contract_nonminor": 0}

        def rule(node: Node, ins: List[Value]) -> Optional[List[Value]]:
            if node.op == "Transpose":
                inner = ins[0].node
                if inner.op == "Transpose":
                    stats["transposes_collapsed"] += 1
                    comp = tuple(inner.attrs["perm"][p] for p in node.attrs["perm"])
                    return [ops.transpose(inner.inputs[0], comp)]
                return None
            if node.op != "DotGeneral":
                return None
            (lc, rc) = node.attrs["contracting"]
            (lb, rb) = node.attrs["batch"]
            a, b = ins
            changed = False

            def sink(side: Value, cdims, bdims):
                nonlocal changed
                n = side.node
                if n.op != "Transpose":
                    return side, cdims, bdims
                perm = n.attrs["perm"]
                free = [d for d in range(side.rank) if d not in tuple(cdims) + tuple(bdims)]
                if len(free) > 1:
                    # sinking would permute output free dims; skip
                    return side, cdims, bdims
                changed = True
                stats["transposes_sunk"] += 1
                new_c = tuple(perm[d] for d in cdims)
                new_b = tuple(perm[d] for d in bdims)
                return n.inputs[0], new_c, new_b

            a2, lc2, lb2 = sink(a, lc, lb)
            b2, rc2, rb2 = sink(b, rc, rb)
            # preferred-layout census
            if lc2 and max(lc2) == a2.rank - 1:
                stats["contract_minor"] += 1
            else:
                stats["contract_nonminor"] += 1
            if not changed:
                return None
            return [ops.dot_general(a2, b2, (lc2, rc2), (lb2, rb2),
                                    preferred_dtype=node.out_types[0].dtype)]

        return transform(fn, rule, name=fn.name), stats
