"""IR nodes and values.

The nGraph IR (paper sec. 2) is "a directed acyclic graph of stateless
operation nodes. Each node has zero or more inputs and zero or more
outputs. Nodes may have additional constant attributes that affect their
behavior."  A :class:`Node` is one operation; a :class:`Value` is one of
its outputs (op, output-index).  Graphs are immutable once built; compiler
passes rewrite by reconstruction (see ``function.transform``).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Sequence, Tuple

from .types import TensorType

_ids = itertools.count()


class Node:
    """One stateless operation in the dataflow graph."""

    __slots__ = ("op", "inputs", "attrs", "out_types", "id", "name", "_hash")

    def __init__(
        self,
        op: str,
        inputs: Sequence["Value"],
        attrs: Optional[Dict[str, Any]] = None,
        out_types: Sequence[TensorType] = (),
        name: Optional[str] = None,
    ):
        self.op = op
        self.inputs: Tuple[Value, ...] = tuple(inputs)
        for v in self.inputs:
            if not isinstance(v, Value):
                raise TypeError(f"{op}: input {v!r} is not a Value")
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.out_types: Tuple[TensorType, ...] = tuple(out_types)
        self.id = next(_ids)
        self.name = name or f"{op.lower()}_{self.id}"
        self._hash = None

    # -- outputs -----------------------------------------------------------
    @property
    def n_outputs(self) -> int:
        return len(self.out_types)

    def out(self, index: int = 0) -> "Value":
        if not (0 <= index < len(self.out_types)):
            raise IndexError(f"{self.name} has {len(self.out_types)} outputs")
        return Value(self, index)

    def outs(self) -> Tuple["Value", ...]:
        return tuple(Value(self, i) for i in range(len(self.out_types)))

    def __repr__(self) -> str:
        ins = ", ".join(v.short() for v in self.inputs)
        outs = ", ".join(repr(t) for t in self.out_types)
        return f"{self.name} = {self.op}({ins}) -> ({outs})"


class Value:
    """One output of a node: the edge type of the dataflow graph."""

    __slots__ = ("node", "index")

    def __init__(self, node: Node, index: int = 0):
        self.node = node
        self.index = index

    @property
    def type(self) -> TensorType:
        return self.node.out_types[self.index]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.type.shape

    @property
    def dtype(self):
        return self.type.dtype

    @property
    def rank(self) -> int:
        return self.type.rank

    def short(self) -> str:
        if self.node.n_outputs == 1:
            return self.node.name
        return f"{self.node.name}#{self.index}"

    def __repr__(self) -> str:
        return f"<{self.short()}: {self.type!r}>"

    def __hash__(self) -> int:
        return hash((id(self.node), self.index))

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Value)
            and other.node is self.node
            and other.index == self.index
        )

    # Operator overloads are installed by repro.core.ops at import time so
    # model code can write ``a * b + c`` and get IR nodes.
    # (Kept here as stubs to make the dependency explicit.)


def install_operators(ops) -> None:
    """Called by repro.core.ops to wire python operators to IR builders."""
    Value.__add__ = lambda self, o: ops.add(self, o)
    Value.__radd__ = lambda self, o: ops.add(o, self)
    Value.__sub__ = lambda self, o: ops.subtract(self, o)
    Value.__rsub__ = lambda self, o: ops.subtract(o, self)
    Value.__mul__ = lambda self, o: ops.multiply(self, o)
    Value.__rmul__ = lambda self, o: ops.multiply(o, self)
    Value.__truediv__ = lambda self, o: ops.divide(self, o)
    Value.__rtruediv__ = lambda self, o: ops.divide(o, self)
    Value.__pow__ = lambda self, o: ops.power(self, o)
    Value.__neg__ = lambda self: ops.negative(self)
    Value.__matmul__ = lambda self, o: ops.matmul(self, o)
    Value.__lt__ = lambda self, o: ops.less(self, o)
    Value.__le__ = lambda self, o: ops.less_equal(self, o)
    Value.__gt__ = lambda self, o: ops.greater(self, o)
    Value.__ge__ = lambda self, o: ops.greater_equal(self, o)
