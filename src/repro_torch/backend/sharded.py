"""The shard executor: one process drives the N shards of a partitioned
graph (the port of ``JaxBackend._shardmap_mesh``/``_wrap_shard_map``).

The :class:`~repro_torch.core.passes.PartitionGraph` pass stamps every
Parameter with its ``pspec`` and every result producer with its
``out_pspecs``, and rebuilds the graph at local (per-shard) shapes with
explicit collective nodes.  :class:`ShardedProgram` runs that graph the
way ``shard_map`` runs the reference's, single-controller:

- callers pass *global* tensors; each is split along its ``pspec`` into
  one piece per shard, on the shard's device (a replicated input is
  handed to every shard on its device as it is);
- the N shard environments walk the emitted plan side by side, step by
  step.  An ordinary op runs once per shard through ``EMIT``; a
  collective reads every shard of its group and writes each its output
  (``torch_emit.COLLECTIVES``, combined in shard order); a ``Scan`` runs
  its hoisted prologue and then each step as a group walk of its own,
  because the partitioned graph's AllGathers sit inside the layer Scan's
  body and in its prologue;
- the outputs are joined along their ``out_pspecs`` onto the home device
  (a replicated output is shard 0's).

This is :func:`~repro_torch.core.passes.partition.simulate_shards`' own
structure, with the torch emitters in place of the numpy ones.  The walk
is its own function (:func:`_execute_group`): the one-shard path
(``torch_emit._execute``, ``ScanBody``) is unchanged.

A mesh whose shards all name the backend's device is one stream, so
:class:`~repro_torch.backend.graphed.GraphedProgram` captures the whole
walk, splits and joins included, and writes donated inputs back from the
joined outputs.  Shards on different devices run eagerly, and their
collectives copy with ``.to(device)``.

``sole_shard=True`` (a dry run's meta mesh of hundreds of shards) walks
shard 0 alone: its piece of each input, each collective a meta tensor
of its IR out type (:data:`SOLE_COLLECTIVES`), each Scan body once
(every trip has the same shapes), and each output a meta tensor of its
global type.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.function import Function
from ..core.types import TensorType
from ..devices import as_tensor, torch_dtype
from ..transformers.torch_emit import COLLECTIVES, EmitCtx, function_plan

Spec = Tuple[Optional[str], ...]


class ShardLayout:
    """Shard ``i`` of a mesh: its mesh coordinate, its device, and the
    groups a collective over each mesh axis combines (shard indices in
    axis order)."""

    def __init__(self, mesh):
        self.axis_names = tuple(mesh.axis_names)
        shape = tuple(mesh.devices.shape)
        self.sizes = dict(zip(self.axis_names, shape))
        self.coords = list(np.ndindex(shape))
        self.devices = [torch.device(mesh.devices[c]) for c in self.coords]
        self.n = len(self.coords)
        self._index = {c: i for i, c in enumerate(self.coords)}
        self._groups: Dict[str, List[List[int]]] = {}

    def groups(self, axis: str) -> List[List[int]]:
        if axis not in self._groups:
            if axis not in self.sizes:
                raise ValueError(f"collective over {axis!r}; the mesh has "
                                 f"axes {self.axis_names}")
            k = self.axis_names.index(axis)
            gs: Dict[Tuple[int, ...], List[int]] = {}
            for i, c in enumerate(self.coords):
                gs.setdefault(c[:k] + c[k + 1:], []).append(i)
            self._groups[axis] = list(gs.values())
        return self._groups[axis]

    def global_type(self, t: TensorType, spec: Spec) -> TensorType:
        return t.with_shape(tuple(
            sz * self.sizes[a] if a else sz for sz, a in zip(t.shape, spec)))

    def split(self, t: torch.Tensor, spec: Spec) -> List[torch.Tensor]:
        """One piece of ``t`` per shard, on the shard's device: the
        shard's block of each dim ``spec`` names an axis for (a copy),
        else ``t`` itself."""
        return [self.piece(t, spec, i) for i in range(self.n)]

    def piece(self, t: torch.Tensor, spec: Spec, i: int) -> torch.Tensor:
        """Shard ``i``'s piece of ``t`` (see :meth:`split`)."""
        c, dev = self.coords[i], self.devices[i]
        p = t
        cut = False
        for d, a in enumerate(spec):
            if a:
                blk = t.shape[d] // self.sizes[a]
                p = p.narrow(d, c[self.axis_names.index(a)] * blk, blk)
                cut = True
        if cut:
            p = p.contiguous()
        return p if p.device == dev else p.to(dev)

    def join(self, pieces: Sequence[torch.Tensor], spec: Spec,
             home: torch.device) -> torch.Tensor:
        """The global value of per-shard ``pieces`` on ``home``:
        concatenated in axis order along each dim ``spec`` names an axis
        for; a dim no axis shards is read from coordinate 0."""
        cuts = [(d, a) for d, a in enumerate(spec) if a]

        def build(k: int, at: Dict[str, int]) -> torch.Tensor:
            if k == len(cuts):
                c = tuple(at.get(a, 0) for a in self.axis_names)
                p = pieces[self._index[c]]
                return p if p.device == home else p.to(home)
            d, a = cuts[k]
            return torch.cat([build(k + 1, {**at, a: j})
                              for j in range(self.sizes[a])], dim=d)

        return build(0, {})


def _sole_collective(node, argss, ctxs):
    """A collective seen from shard 0 alone: a meta tensor of its IR out
    type (the other shards' values are not walked)."""
    return [[torch.empty(t.shape, dtype=torch_dtype(t.dtype),
                         device=c.device) for t in node.out_types]
            for c in ctxs]


SOLE_COLLECTIVES = {op: _sole_collective for op in COLLECTIVES}


class _SoleShard:
    """Shard 0 as a group of one, over its mesh's axes."""

    def __init__(self, layout: ShardLayout):
        self.axis_names = layout.axis_names

    def groups(self, axis: str) -> List[List[int]]:
        if axis not in self.axis_names:
            raise ValueError(f"collective over {axis!r}; the mesh has "
                             f"axes {self.axis_names}")
        return [[0]]


def _execute_group(plan: List[tuple], envs: List[List[Any]],
                   ctxs: List[EmitCtx], layout: ShardLayout,
                   name: str, collectives=COLLECTIVES) -> None:
    """Run ``plan`` over every shard's environment in place, step by
    step: an op once per shard, a collective once per group, a Scan as a
    group walk (:func:`_group_scan`)."""
    try:
        for emit, node, ins, out0, dead in plan:
            argss = [[env[s] for s in ins] for env in envs]
            op = node.op
            if op in collectives:
                outss: List[Any] = [None] * len(envs)
                for g in layout.groups(node.attrs["axis_name"]):
                    res = collectives[op](node, [argss[i] for i in g],
                                          [ctxs[i] for i in g])
                    for i, r in zip(g, res):
                        outss[i] = r
            elif op == "Scan":
                outss = _group_scan(node, argss, ctxs, layout, collectives)
            else:
                outss = [emit(node, a, c) for a, c in zip(argss, ctxs)]
            for env, outs in zip(envs, outss):
                for j, o in enumerate(outs):
                    env[out0 + j] = o
                for s in dead:
                    env[s] = None
    except Exception as exc:
        exc.add_note(f"while running {node.op} {node.name!r} in {name} "
                     f"({len(envs)} shards)")
        raise


def _group_scan(node, argss: List[List[Any]], ctxs: List[EmitCtx],
                layout: ShardLayout, collectives=COLLECTIVES
                ) -> List[List[Any]]:
    """The ``Scan`` emitter over a group: the body's loop-invariant
    prologue once per Scan, then each step, each as a group walk
    (``torch_emit.ScanBody``'s plans)."""
    at = node.attrs
    nc, nx = at["n_carry"], at["n_xs"]
    body = ctxs[0].scan_body(at["body"], nc + nx)
    sl = body.slots
    length = at["length"]
    n_ys = len(node.out_types) - nc
    n = len(argss)
    carries = [list(a[:nc]) for a in argss]
    ys = [[[None] * length for _ in range(n_ys)] for _ in range(n)]
    if length:
        bases = []
        for a, c in zip(argss, ctxs):
            env: List[Any] = [None] * sl.n
            for s, t in sl.leaves_for(c).items():
                env[s] = t
            for s, v in zip(body.const_slots, a[nc + nx:]):
                env[s] = v
            bases.append(env)
        _execute_group(body.pro_plan, bases, ctxs, layout, body.name,
                       collectives)
    order = range(length - 1, -1, -1) if at["reverse"] else range(length)
    if collectives is SOLE_COLLECTIVES:
        # a meta walk: every trip has the same shapes, so one trip stands
        # for all (a 4096-step time Scan walks once)
        order = order[:1]
    for t in order:
        envs = []
        for i, a in enumerate(argss):
            env = list(bases[i])
            variant = carries[i] + [x[t] for x in a[nc:nc + nx]]
            for s, v in zip(body.variant_slots, variant):
                env[s] = v
            envs.append(env)
        _execute_group(body.step_plan, envs, ctxs, layout, body.name,
                       collectives)
        for i, env in enumerate(envs):
            outs = [env[s] for s in sl.results]
            carries[i] = outs[:nc]
            for j in range(n_ys):
                ys[i][j][t] = outs[nc + j]
    result = []
    for i, c in enumerate(ctxs):
        stacked = []
        for j in range(n_ys):
            if length and collectives is SOLE_COLLECTIVES:
                y = ys[i][j][order[0]]
                stacked.append(y.unsqueeze(0).expand(length, *y.shape))
            elif length:
                stacked.append(torch.stack(ys[i][j]))
            else:
                ty = node.out_types[nc + j]
                stacked.append(torch.empty(
                    ty.shape, dtype=torch_dtype(ty.dtype), device=c.device))
        result.append(carries[i] + stacked)
    return result


def graph_specs(fn: Function) -> Tuple[List[Spec], List[Spec]]:
    """The ``pspec`` of each parameter and the ``out_pspecs`` entry of
    each result the partition pass stamped (replicated where none)."""
    ins = [tuple(p.attrs.get("pspec") or (None,) * len(p.out_types[0].shape))
           for p in fn.parameters]
    outs = []
    for r in fn.results:
        ps = r.node.attrs.get("out_pspecs")
        outs.append(tuple(ps[r.index]) if ps else (None,) * len(r.shape))
    return ins, outs


class ShardedProgram:
    """A partitioned Function run over a mesh's shards (see the module
    docstring).  Called with global tensors (or host arrays), returns the
    global outputs on ``home``.  ``in_types``/``out_types`` are the
    global types; ``donation`` is set by the backend as for any
    program."""

    def __init__(self, fn: Function, mesh, ctx_for: Callable[[torch.device],
                                                            EmitCtx],
                 home: torch.device, in_specs: Optional[Sequence[Spec]] = None,
                 out_specs: Optional[Sequence[Spec]] = None,
                 sole_shard: bool = False):
        self.layout = lay = ShardLayout(mesh)
        g_in, g_out = graph_specs(fn)
        self.in_specs = [tuple(s) for s in (in_specs or g_in)]
        self.out_specs = [tuple(s) for s in (out_specs or g_out)]
        self.sole_shard = bool(sole_shard)
        if self.sole_shard and any(d.type != "meta" for d in lay.devices):
            raise ValueError("sole_shard walks shard 0 of a meta mesh; "
                             f"this mesh has {lay.devices[0]}")
        self.ctxs = [ctx_for(d) for d in
                     (lay.devices[:1] if self.sole_shard else lay.devices)]
        self.home = torch.device(home)
        self.name = fn.name
        self.slots, self.plan = function_plan(fn, self.ctxs[0])
        self.in_types = [lay.global_type(t, s)
                         for t, s in zip(fn.in_types, self.in_specs)]
        self.out_types = [lay.global_type(t, s)
                          for t, s in zip(fn.out_types, self.out_specs)]
        self.local_out_types = list(fn.out_types)
        self.donation: Dict[int, int] = {}
        self.__name__ = f"ngraph_{fn.name}_x{lay.n}"

    def __call__(self, *args):
        sl, lay = self.slots, self.layout
        if len(args) != len(sl.params):
            raise TypeError(f"{self.name}: expected {len(sl.params)} args, "
                            f"got {len(args)}")
        if self.sole_shard:
            return self._walk_sole(args)
        envs: List[List[Any]] = [[None] * sl.n for _ in range(lay.n)]
        for s, a, spec in zip(sl.params, args, self.in_specs):
            t = a if isinstance(a, torch.Tensor) else as_tensor(a, self.home)
            for env, piece in zip(envs, lay.split(t, spec)):
                env[s] = piece
        for env, c in zip(envs, self.ctxs):
            for s, t in sl.leaves_for(c).items():
                env[s] = t
        _execute_group(self.plan, envs, self.ctxs, lay, self.name)
        return tuple(lay.join([env[s] for env in envs], spec, self.home)
                     for s, spec in zip(sl.results, self.out_specs))

    def _walk_sole(self, args):
        sl, lay = self.slots, self.layout
        env: List[Any] = [None] * sl.n
        for s, a, spec, ty in zip(sl.params, args, self.in_specs,
                                  self.in_types):
            t = a if isinstance(a, torch.Tensor) else as_tensor(a, self.home)
            if tuple(t.shape) != tuple(ty.shape):
                raise ValueError(f"{self.name}: an input of shape "
                                 f"{tuple(t.shape)}, the graph's is "
                                 f"{tuple(ty.shape)}")
            env[s] = lay.piece(t, spec, 0)
        for s, t in sl.leaves_for(self.ctxs[0]).items():
            env[s] = t
        _execute_group(self.plan, [env], self.ctxs, _SoleShard(lay),
                       self.name, SOLE_COLLECTIVES)
        for s, ty in zip(sl.results, self.local_out_types):
            got = env[s]
            if tuple(got.shape) != ty.shape or \
                    got.dtype != torch_dtype(ty.dtype):
                raise ValueError(f"{self.name}: shard 0 gave "
                                 f"{tuple(got.shape)} {got.dtype}, the "
                                 f"graph's result is {ty}")
        return tuple(torch.empty(ty.shape, dtype=torch_dtype(ty.dtype),
                                 device=self.home) for ty in self.out_types)


def shard_map(cf, mesh, in_specs: Sequence[Spec],
              out_specs: Sequence[Spec]) -> ShardedProgram:
    """Run a compiled per-device program over ``mesh`` with the given
    specs, as ``shard_map(run, mesh, in_specs, out_specs)`` runs the
    reference's: for graphs whose collectives were written by hand (the
    partition pass's graphs carry their specs and need no wrap).  The
    outputs are joined onto the mesh's first device."""
    o = cf.options

    def ctx_for(dev):
        return EmitCtx(dev, use_pallas=o.use_pallas, attn_impl=o.attn_impl,
                       attn_chunk=o.attn_chunk, mode="shardmap")

    return ShardedProgram(cf.function, mesh, ctx_for,
                          home=mesh.devices.flat[0], in_specs=in_specs,
                          out_specs=out_specs)
