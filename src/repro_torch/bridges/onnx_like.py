"""ONNX-like bridge: import/export serialized graphs (paper sec. 1.1).

A foreign producer can hand us a JSON graph document; we import it as
first-class IR (same Function type every other bridge produces), run the
same passes, and execute on any transformer.
"""
from __future__ import annotations

from ..core import serialize
from ..core.function import Function

export_graph = serialize.dumps
export_file = serialize.save


def import_graph(doc: str) -> Function:
    return serialize.loads(doc)


def import_file(path: str) -> Function:
    return serialize.load(path)
