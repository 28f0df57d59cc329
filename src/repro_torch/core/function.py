"""Function: the unit of compilation.

An nGraph ``Function`` is a DAG with named ``Parameter`` nodes as graph
inputs and an ordered list of result :class:`Value`\\ s as outputs.  This is
what framework bridges build and what transformers compile.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .node import Node, Value
from .types import TensorType


def topo_sort(roots: Sequence[Value]) -> List[Node]:
    """Deterministic post-order topological sort of all nodes reachable
    from ``roots``.  Iterative (graphs can be thousands of nodes deep)."""
    seen: Dict[int, Node] = {}
    order: List[Node] = []
    stack: List[Tuple[Node, bool]] = [(v.node, False) for v in reversed(roots)]
    on_path = set()
    while stack:
        node, processed = stack.pop()
        if processed:
            on_path.discard(id(node))
            if id(node) not in seen:
                seen[id(node)] = node
                order.append(node)
            continue
        if id(node) in seen:
            continue
        if id(node) in on_path:
            raise ValueError(f"cycle detected at {node.name}")
        on_path.add(id(node))
        stack.append((node, True))
        for v in reversed(node.inputs):
            if id(v.node) not in seen:
                stack.append((v.node, False))
    return order


class Function:
    """A compilable graph: ordered parameters -> ordered results."""

    def __init__(
        self,
        parameters: Sequence[Node],
        results: Sequence[Value],
        name: str = "main",
    ):
        self.parameters: List[Node] = list(parameters)
        self.results: List[Value] = list(results)
        self.name = name
        for p in self.parameters:
            if p.op != "Parameter":
                raise TypeError(f"{p.name} is not a Parameter node")
        self.validate()

    # -- structure ---------------------------------------------------------
    def nodes(self) -> List[Node]:
        return topo_sort(self.results)

    def validate(self) -> None:
        params_in_graph = [n for n in self.nodes() if n.op == "Parameter"]
        declared = {id(p) for p in self.parameters}
        for p in params_in_graph:
            if id(p) not in declared:
                raise ValueError(
                    f"graph reaches undeclared Parameter {p.name}; "
                    f"declared: {[q.name for q in self.parameters]}"
                )

    @property
    def in_types(self) -> List[TensorType]:
        return [p.out_types[0] for p in self.parameters]

    @property
    def out_types(self) -> List[TensorType]:
        return [r.type for r in self.results]

    def signature(self) -> str:
        """Canonical structural hash (hex sha256) of this graph.

        Independent of node/function names: two structurally-identical
        rebuilt graphs share a signature.  Used as the backend compile-cache
        key (see :mod:`repro.backend`)."""
        from . import serialize  # local import: serialize imports this module
        return serialize.signature(self)

    def op_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for n in self.nodes():
            counts[n.op] = counts.get(n.op, 0) + 1
        return counts

    def __repr__(self) -> str:
        ins = ", ".join(f"{p.name}: {p.out_types[0]!r}" for p in self.parameters)
        outs = ", ".join(repr(t) for t in self.out_types)
        return f"Function {self.name}({ins}) -> ({outs}) [{len(self.nodes())} nodes]"

    def pretty(self, max_nodes: int = 10_000) -> str:
        lines = [repr(self)]
        for n in self.nodes()[:max_nodes]:
            lines.append(f"  {n!r}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Graph rewriting.  Passes are functional: they rebuild the graph bottom-up,
# applying a rule at each node.  A rule may return replacement output Values
# (to substitute the node) or None (keep a copy with rewritten inputs).
# ---------------------------------------------------------------------------

RewriteRule = Callable[[Node, List[Value]], Optional[List[Value]]]


def _clone_node(node: Node, new_inputs: List[Value]) -> Node:
    n = Node(node.op, new_inputs, dict(node.attrs), node.out_types, name=None)
    return n


def transform(
    fn: Function,
    rule: RewriteRule,
    name: Optional[str] = None,
    reuse_params: bool = True,
) -> Function:
    """Rebuild ``fn`` applying ``rule`` to every node in topo order.

    Parameter nodes are reused identically (so callers keep their handles)
    unless the rule replaces them.
    """
    mapping: Dict[Tuple[int, int], Value] = {}

    def lookup(v: Value) -> Value:
        return mapping.get((id(v.node), v.index), v)

    for node in fn.nodes():
        new_inputs = [lookup(v) for v in node.inputs]
        replaced = rule(node, new_inputs)
        if replaced is not None:
            if len(replaced) != node.n_outputs:
                raise ValueError(
                    f"rule for {node.op} returned {len(replaced)} values, "
                    f"expected {node.n_outputs}"
                )
            for i, v in enumerate(replaced):
                if v.type.shape != node.out_types[i].shape:
                    raise ValueError(
                        f"rewrite of {node.name} changed shape "
                        f"{node.out_types[i]} -> {v.type}"
                    )
                mapping[(id(node), i)] = v
            continue
        if node.op == "Parameter" and reuse_params:
            continue  # identity mapping
        unchanged = all(a is b or a == b for a, b in zip(new_inputs, node.inputs))
        if unchanged:
            continue  # identity mapping; keep original node
        clone = _clone_node(node, new_inputs)
        for i in range(node.n_outputs):
            mapping[(id(node), i)] = Value(clone, i)

    new_results = [lookup(r) for r in fn.results]
    return Function(fn.parameters, new_results, name or fn.name)


def replace_values(fn: Function, replacements: Dict[Value, Value]) -> Function:
    """Substitute specific values throughout the graph."""
    table = {(id(v.node), v.index): nv for v, nv in replacements.items()}

    def rule(node: Node, new_inputs: List[Value]) -> Optional[List[Value]]:
        outs = []
        hit = False
        for i in range(node.n_outputs):
            key = (id(node), i)
            if key in table:
                outs.append(table[key])
                hit = True
            else:
                outs.append(None)
        if not hit:
            return None
        # mixed replacement: clone for non-replaced outputs
        clone = _clone_node(node, new_inputs)
        return [o if o is not None else Value(clone, i) for i, o in enumerate(outs)]

    return transform(fn, rule)


def users_map(fn: Function) -> Dict[int, List[Node]]:
    """node-id -> list of consumer nodes (plus a synthetic None for results)."""
    users: Dict[int, List[Node]] = {}
    for n in fn.nodes():
        for v in n.inputs:
            users.setdefault(id(v.node), []).append(n)
    return users
