"""Graph serialization: JSON round-trip of Functions.

This is the ONNX-interoperability story of the paper (sec. 1.1: "We will
aim for ONNX interoperability") scaled to this repo: a stable exchange
format that a foreign frontend can produce and the bridge can import
(see ``repro.bridges.onnx_like``).
"""
from __future__ import annotations

import base64
import hashlib
import json
from typing import Any, Dict, List

import numpy as np

from . import ops
from .function import Function
from .node import Node, Value
from .types import TensorType, as_dtype, dtype_name


def _enc_attr(v: Any):
    if isinstance(v, np.ndarray):
        return {"__nd__": True, "dtype": dtype_name(v.dtype), "shape": list(v.shape),
                "data": base64.b64encode(np.ascontiguousarray(v).tobytes()).decode()}
    if isinstance(v, np.dtype):
        return {"__dt__": dtype_name(v)}
    if isinstance(v, Function):
        return {"__fn__": _encode_function(v)}
    if isinstance(v, tuple):
        return {"__tu__": [_enc_attr(x) for x in v]}
    if isinstance(v, list):
        return [_enc_attr(x) for x in v]
    return v


def _dec_attr(v: Any):
    if isinstance(v, dict):
        if v.get("__nd__"):
            arr = np.frombuffer(base64.b64decode(v["data"]), dtype=as_dtype(v["dtype"]))
            return arr.reshape(v["shape"]).copy()
        if "__dt__" in v:
            return as_dtype(v["__dt__"])
        if "__fn__" in v:
            return _decode_function(v["__fn__"])
        if "__tu__" in v:
            return tuple(_dec_attr(x) for x in v["__tu__"])
    if isinstance(v, list):
        return [_dec_attr(x) for x in v]
    return v


def _encode_function(fn: Function) -> Dict:
    nodes = fn.nodes()
    idx = {id(n): i for i, n in enumerate(nodes)}
    return {
        "name": fn.name,
        "nodes": [
            {
                "op": n.op,
                "name": n.name,
                "inputs": [[idx[id(v.node)], v.index] for v in n.inputs],
                "attrs": {k: _enc_attr(v) for k, v in n.attrs.items()},
                "out_types": [[list(t.shape), dtype_name(t.dtype)] for t in n.out_types],
            }
            for n in nodes
        ],
        "parameters": [idx[id(p)] for p in fn.parameters],
        "results": [[idx[id(r.node)], r.index] for r in fn.results],
    }


def _decode_function(doc: Dict) -> Function:
    built: List[Node] = []
    for nd in doc["nodes"]:
        inputs = [Value(built[i], j) for i, j in nd["inputs"]]
        attrs = {k: _dec_attr(v) for k, v in nd["attrs"].items()}
        out_types = [TensorType(s, d) for s, d in nd["out_types"]]
        node = Node(nd["op"], inputs, attrs, out_types, name=nd["name"])
        built.append(node)
    params = [built[i] for i in doc["parameters"]]
    results = [Value(built[i], j) for i, j in doc["results"]]
    return Function(params, results, doc["name"])


# ---------------------------------------------------------------------------
# Canonical graph signature (compile-cache key).
#
# Unlike the JSON round-trip above, the signature is *structural*: node and
# function names are dropped, attribute keys are sorted, and large constant
# payloads are digested rather than base64-embedded, so two independently
# rebuilt but structurally-identical graphs hash identically while any change
# to an op, edge, attribute, dtype, or shape changes the hash.
# ---------------------------------------------------------------------------

def _sig_attr(v: Any):
    if isinstance(v, np.ndarray):
        return ("nd", dtype_name(v.dtype), tuple(v.shape),
                hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest())
    if isinstance(v, np.dtype):
        return ("dt", dtype_name(v))
    if isinstance(v, Function):
        return ("fn", signature(v))
    if isinstance(v, (tuple, list)):
        return ("seq", type(v).__name__, tuple(_sig_attr(x) for x in v))
    if isinstance(v, dict):
        return ("map", tuple(sorted((str(k), _sig_attr(x))
                                    for k, x in v.items())))
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        v = v.item()
    # tag with the type name so 1, 1.0 and True stay distinct
    return (type(v).__name__, repr(v))


def signature(fn: Function) -> str:
    """Stable structural hash of ``fn`` (hex sha256).

    Built on the same canonical walk as serialization but independent of
    node/function *names*: the key for the backend compile cache."""
    nodes = fn.nodes()
    idx = {id(n): i for i, n in enumerate(nodes)}
    doc = (
        "ngraph-sig-v1",
        tuple((idx.get(id(p), -1),
               tuple(p.out_types[0].shape), dtype_name(p.out_types[0].dtype))
              for p in fn.parameters),
        tuple((idx[id(r.node)], r.index) for r in fn.results),
        tuple((n.op,
               tuple((idx[id(v.node)], v.index) for v in n.inputs),
               tuple(sorted((k, _sig_attr(v)) for k, v in n.attrs.items())),
               tuple((tuple(t.shape), dtype_name(t.dtype))
                     for t in n.out_types))
              for n in nodes),
    )
    return hashlib.sha256(repr(doc).encode()).hexdigest()


# Bumped whenever the encoding above changes shape: persisted graph docs
# (e.g. repro.backend.diskcache entries) embed it so a stale on-disk
# artifact is an explicit invalidation, never a mis-decode.
FORMAT_VERSION = 1


def to_doc(fn: Function) -> Dict:
    """Encode ``fn`` as a JSON-ready dict (the persistence format)."""
    return _encode_function(fn)


def from_doc(doc: Dict) -> Function:
    """Decode a :func:`to_doc` dict back into a Function."""
    return _decode_function(doc)


def dumps(fn: Function) -> str:
    return json.dumps(_encode_function(fn))


def loads(s: str) -> Function:
    return _decode_function(json.loads(s))


def save(fn: Function, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(fn))


def load(path: str) -> Function:
    with open(path) as f:
        return loads(f.read())
