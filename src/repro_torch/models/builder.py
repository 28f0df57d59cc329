"""ModelBuilder: parameter registry + scan-over-layers helper.

The builder is the glue between *stateful framework land* (named
parameters, initializers, logical sharding axes) and the *stateless IR*:
it creates Parameter nodes, records ``ParamSpec`` metadata (consumed by
the sharding policy and by smoke-test initialization), and provides
``scan_blocks`` which stacks per-layer weights along a leading layer dim
and runs the block body through the IR ``Scan`` op — the construction
that keeps an 80-layer / 512-chip graph compilable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import ops
from ..core.function import Function
from ..core.node import Node, Value
from ..core.types import TensorType, as_dtype


# -- initializers (smoke-test scale only; the dry run never allocates) --------
def normal_init(scale: float = 0.02):
    def init(rng: np.random.Generator, shape, dtype) -> np.ndarray:
        return (rng.normal(size=shape) * scale).astype(dtype)
    return init


def fanin_init():
    def init(rng: np.random.Generator, shape, dtype) -> np.ndarray:
        fan = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
        return (rng.normal(size=shape) / math.sqrt(fan)).astype(dtype)
    return init


def zeros_init():
    def init(rng: np.random.Generator, shape, dtype) -> np.ndarray:
        return np.zeros(shape, dtype)
    return init


def ones_init():
    def init(rng: np.random.Generator, shape, dtype) -> np.ndarray:
        return np.ones(shape, dtype)
    return init


@dataclasses.dataclass
class ParamSpec:
    name: str
    shape: Tuple[int, ...]
    dtype: Any
    logical_axes: Tuple[Optional[str], ...]
    init: Callable
    node: Node  # the Parameter node in the graph

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


class ModelBuilder:
    """Collects Parameter nodes + metadata while a model graph is built."""

    def __init__(self, param_dtype: Any = "f32", compute_dtype: Any = "bf16"):
        self.param_dtype = as_dtype(param_dtype)
        self.compute_dtype = as_dtype(compute_dtype)
        self.params: Dict[str, ParamSpec] = {}
        self.inputs: List[Node] = []  # non-weight graph inputs, in order
        # logical sharding spec per input (one entry per dim; names are
        # logical axes the policy maps onto the mesh)
        self.input_specs: Dict[str, Tuple[Optional[Any], ...]] = {}

    # -- inputs ----------------------------------------------------------------
    def input(self, name: str, shape: Sequence[int], dtype: Any = "i32",
              spec: Optional[Sequence[Optional[Any]]] = None) -> Value:
        p = ops.parameter(shape, dtype, name)
        self.inputs.append(p)
        if spec is None:
            spec = ("batch",) + (None,) * (len(tuple(shape)) - 1) if shape else ()
        self.input_specs[name] = tuple(spec)
        # stamped on the node so the backend can derive shardings from the
        # Function alone (PartitionGraph pass, pjit auto-shardings)
        p.attrs["logical_axes"] = tuple(spec)
        return p.out()

    # -- parameters -------------------------------------------------------------
    def param(
        self,
        name: str,
        shape: Sequence[int],
        logical: Sequence[Optional[str]],
        init: Optional[Callable] = None,
        dtype: Any = None,
    ) -> Value:
        """Declare a weight; returns its Value in *compute* dtype."""
        if name in self.params:
            raise ValueError(f"duplicate param {name}")
        dtype = as_dtype(dtype) if dtype is not None else self.param_dtype
        shape = tuple(int(s) for s in shape)
        logical = tuple(logical)
        if len(logical) != len(shape):
            raise ValueError(f"{name}: logical axes {logical} vs shape {shape}")
        node = ops.parameter(shape, dtype, name)
        node.attrs["logical_axes"] = logical
        self.params[name] = ParamSpec(name, shape, dtype, logical,
                                      init or normal_init(), node)
        return self.cast(node.out())

    def raw_param(self, name: str, shape, logical, init=None, dtype=None) -> Value:
        """Like param() but returns the storage-dtype Value (norm scales,
        router weights that want f32 math)."""
        self.param(name, shape, logical, init, dtype)
        return self.params[name].node.out()

    def cast(self, x: Value) -> Value:
        return ops.convert(x, self.compute_dtype)

    # -- assembly -----------------------------------------------------------------
    def param_nodes(self) -> List[Node]:
        return [self.params[n].node for n in self.params]

    def param_names(self) -> List[str]:
        return list(self.params)

    def finish(self, results: Sequence[Value], name: str) -> Function:
        return Function(self.inputs + self.param_nodes(), list(results), name)

    def init_params(self, seed: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        return {s.name: s.init(rng, s.shape, s.dtype)
                for s in self.params.values()}

    def n_params(self) -> int:
        return sum(s.size for s in self.params.values())

    # -- scan over layers -----------------------------------------------------------
    def scan_blocks(
        self,
        name: str,
        n: int,
        weight_specs: Dict[str, Tuple[Tuple[int, ...], Tuple[Optional[str], ...]]],
        body_fn: Callable,
        carries: Sequence[Value],
        consts: Sequence[Value] = (),
        xs_extra: Optional[Dict[str, Value]] = None,
        n_ys: int = 0,
        weight_inits: Optional[Dict[str, Callable]] = None,
        weight_dtypes: Optional[Dict[str, Any]] = None,
        unroll: int = 1,
        gather_dtype: str = "compute",
    ) -> Tuple[List[Value], List[Value]]:
        """Run ``body_fn`` over ``n`` stacked layer groups via the Scan op.

        weight_specs: per-layer weight name -> (shape, logical_axes); the
            builder declares each as a stacked (n, *shape) Parameter.
        body_fn(carries, weights, consts) -> (new_carries, ys) where
            ``weights`` maps name -> per-layer Value (storage dtype —
            body casts via ``self.cast`` where it wants compute dtype).
        xs_extra: additional per-layer inputs already stacked (n, ...)
            (e.g. KV caches in decode); appear in ``weights`` under their
            name.
        Returns (final_carries, stacked_ys).
        """
        weight_inits = weight_inits or {}
        weight_dtypes = weight_dtypes or {}
        xs_extra = xs_extra or {}

        # 1. declare stacked weights.  With gather_dtype="compute" the
        # f32 master weights are cast to the compute dtype BEFORE the
        # scan consumes them, so the ZeRO-3 per-layer weight all-gathers
        # GSPMD inserts inside the loop move bf16, not f32 — half the
        # wire bytes (EXPERIMENTS.md Perf iter 9).  Grads flow back
        # through the Convert VJP to f32 masters automatically.
        stacked: List[Value] = []
        for wname, (shape, logical) in weight_specs.items():
            dt = weight_dtypes.get(wname)
            v = self.raw_param(
                f"{name}/{wname}", (n,) + tuple(shape),
                ("layers",) + tuple(logical),
                weight_inits.get(wname), dt)
            from ..core.types import is_float
            if (gather_dtype == "compute" and dt is None
                    and is_float(v.dtype)):
                v = ops.convert(v, self.compute_dtype)
            stacked.append(v)
        xs_names = list(weight_specs) + list(xs_extra)
        xs_vals = stacked + list(xs_extra.values())

        # 2. body Function on fresh Parameter nodes
        carry_params = [ops.parameter(c.shape, c.dtype, f"c{i}")
                        for i, c in enumerate(carries)]
        x_params = []
        for wname, xv in zip(xs_names, xs_vals):
            t = xv.type
            x_params.append(ops.parameter(t.shape[1:], t.dtype, wname))
        const_params = [ops.parameter(w.shape, w.dtype, f"w{i}")
                        for i, w in enumerate(consts)]
        weights = {wname: p.out() for wname, p in zip(xs_names, x_params)}
        new_carries, ys = body_fn(
            [p.out() for p in carry_params], weights,
            [p.out() for p in const_params])
        if len(ys) != n_ys:
            raise ValueError(f"{name}: body returned {len(ys)} ys, declared {n_ys}")
        body = Function(carry_params + x_params + const_params,
                        list(new_carries) + list(ys), name=f"{name}_body")

        # 3. the Scan node
        outs = ops.scan(body, carries, xs=xs_vals, consts=list(consts),
                        length=n, unroll=unroll)
        nc = len(carries)
        return outs[:nc], outs[nc:]
