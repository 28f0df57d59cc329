"""Graph pattern matching (paper sec. 4: transformers provide
"facilities for pattern matching").

A :class:`Pat` is a small tree matched against a producer subgraph rooted
at a :class:`Value`.  Used by the fusion (compounding) pass.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .node import Node, Value


class Pat:
    """Match a Value produced by op ``op`` whose inputs match ``inputs``.

    op=None matches anything.  ``capture`` stores the matched Value under
    that name.  ``pred`` is an extra predicate on the producing node.
    ``commutative`` tries both input orders (binary ops only).
    """

    def __init__(
        self,
        op: Optional[str] = None,
        inputs: Optional[Sequence["Pat"]] = None,
        capture: Optional[str] = None,
        pred: Optional[Callable[[Node], bool]] = None,
        output: int = 0,
        commutative: bool = False,
    ):
        self.op = op
        self.inputs = list(inputs) if inputs is not None else None
        self.capture = capture
        self.pred = pred
        self.output = output
        self.commutative = commutative

    def match(self, value: Value, captures: Dict[str, Value]) -> bool:
        if self.op is not None:
            node = value.node
            if node.op != self.op or value.index != self.output:
                return False
            if self.pred is not None and not self.pred(node):
                return False
            if self.inputs is not None:
                if len(self.inputs) != len(node.inputs):
                    return False
                orders = [node.inputs]
                if self.commutative and len(node.inputs) == 2:
                    orders.append(node.inputs[::-1])
                ok = False
                for order in orders:
                    trial = dict(captures)
                    if all(p.match(v, trial) for p, v in zip(self.inputs, order)):
                        captures.clear()
                        captures.update(trial)
                        ok = True
                        break
                if not ok:
                    return False
        if self.capture is not None:
            if self.capture in captures and captures[self.capture] != value:
                return False
            captures[self.capture] = value
        return True


class Skip(Pat):
    """Descend through chains of the given single-input ops, then match."""

    def __init__(self, through: Sequence[str], inner: Pat):
        super().__init__(None)
        self.through = set(through)
        self.inner = inner

    def match(self, value: Value, captures: Dict[str, Value]) -> bool:
        v = value
        while v.node.op in self.through and len(v.node.inputs) == 1:
            v = v.node.inputs[0]
        return self.inner.match(v, captures)


def skip_(through: Sequence[str], inner: Pat) -> Pat:
    return Skip(through, inner)


def skip_reshape(v: Value) -> Value:
    while v.node.op == "Reshape":
        v = v.node.inputs[0]
    return v


def any_(capture: Optional[str] = None) -> Pat:
    return Pat(None, capture=capture)


def op_(op: str, *inputs: Pat, capture=None, pred=None, commutative=False) -> Pat:
    return Pat(op, inputs=list(inputs) if inputs else None, capture=capture,
               pred=pred, commutative=commutative)


def const_(value: Optional[float] = None, capture: Optional[str] = None,
           tol: float = 0.0) -> Pat:
    def pred(node: Node) -> bool:
        if value is None:
            return True
        arr = node.attrs["value"]
        if arr.size != 1:
            return False
        return abs(float(arr.reshape(())) - value) <= tol

    return Pat("Constant", capture=capture, pred=pred)


def is_scalar_const(v: Value) -> bool:
    return v.node.op == "Constant" and v.node.attrs["value"].size == 1


def scalar_of(v: Value) -> float:
    return float(np.asarray(v.node.attrs["value"]).reshape(()))


def match(pattern: Pat, value: Value) -> Optional[Dict[str, Value]]:
    captures: Dict[str, Value] = {}
    if pattern.match(value, captures):
        return captures
    return None
