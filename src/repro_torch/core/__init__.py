"""repro.core: the nGraph-style IR, ops, autodiff and compiler passes.

The paper's primary contribution — a framework/hardware-independent IR
with compiler passes and per-backend transformers — lives here.
"""
from . import ops  # noqa: F401
from .function import Function, topo_sort, transform, replace_values  # noqa: F401
from .node import Node, Value  # noqa: F401
from .types import TensorType, DTYPES, as_dtype, dtype_name  # noqa: F401
