"""PartitionGraph: cut a Function into a per-device program.

The pass is the shardmap counterpart of the pjit sharding policy
(``repro.backend.sharding``): given a rule table mapping the *logical*
axes stamped on Parameter nodes (``attrs["logical_axes"]``) onto named
mesh axes, it

  1. infers a per-dim shard spec for every Value in the graph (forward
     fixpoint, with a backward-unification step that pushes a shard
     through broadcast/convert chains so e.g. rope tables rebuild at the
     local shape instead of forcing a gather), and
  2. rebuilds the graph with *local* (per-device) shapes, inserting
     explicit collective nodes at every sharding boundary: AllGather
     where a sharded value meets an op that needs it replicated (layout
     transitions back to replicated weights), AllReduce after matmuls
     whose contraction dim is sharded on both sides (row-parallel cuts).

The result is self-describing: every Parameter carries
``attrs["pspec"]`` (tuple of mesh-axis-or-None per dim), result
producers carry ``attrs["out_pspecs"]``, and the inserted collectives
are ordinary IR nodes the cost model prices and any backend can lower
(the jax backend wraps the emitted callable in ``shard_map`` with
exactly these specs; the interpreter runs the identical-shards
convention; :func:`simulate_shards` runs real multi-shard semantics
in-process for tests).

Ops the pass has no rule for fall back to gathering every sharded
operand dim — always correct, never silently wrong.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import ops
from ..function import Function
from ..node import Node, Value
from .base import Pass

Spec = Tuple[Optional[str], ...]


class PartitionError(ValueError):
    """Raised when a graph cannot be partitioned under the profile."""


def _vkey(v: Value) -> Tuple[int, int]:
    return (id(v.node), v.index)


_UNARY = frozenset({
    "Negative", "Exp", "Log", "Log1p", "Expm1", "Tanh", "Sigmoid", "Relu",
    "Abs", "Sign", "Sqrt", "Rsqrt", "Erf", "Sin", "Cos", "Floor", "Gelu",
    "Silu", "Not", "Convert", "StopGradient", "OptimizationBarrier",
})
_BINARY = frozenset({
    "Add", "Subtract", "Multiply", "Divide", "Power", "Maximum", "Minimum",
    "Less", "LessEqual", "Greater", "GreaterEqual", "Equal", "NotEqual",
    "And", "Or",
})


class _Step:
    """One op's partitioning decision given its current input specs."""

    __slots__ = ("out", "consumed", "reduces", "wishes")

    def __init__(self, out, consumed, reduces=(), wishes=()):
        self.out = [tuple(s) for s in out]            # spec per output
        self.consumed = [tuple(s) for s in consumed]  # spec per input after
        #                                               any inserted gathers
        self.reduces = list(reduces)   # (axis_name, reduce_op) post output 0
        self.wishes = list(wishes)     # (input idx, {dim: axis}) backward asks


class PartitionGraph(Pass):
    """Annotate, cut, and re-specialize a Function onto a device mesh."""

    name = "partition"

    def __init__(self, rules: Dict[str, str], axis_sizes: Dict[str, int],
                 last_dim_only: bool = False,
                 anywhere: Sequence[str] = (),
                 param_specs: Optional[Sequence[Spec]] = None):
        self.rules = dict(rules)
        self.sizes = {a: int(n) for a, n in axis_sizes.items()}
        self.last_dim_only = bool(last_dim_only)
        self.anywhere = frozenset(anywhere)
        # one spec per Parameter, in order, in place of the seeds the
        # rules give (``mode="pjit"``'s in_shardings)
        self.param_specs = (None if param_specs is None else
                            [tuple(s) for s in param_specs])
        # exact profiles never row-parallelize a contraction they could
        # gather instead: split-contraction re-rounding would break
        # bit-identical greedy serving (see backend.sharding docstring)
        self.exact = self.last_dim_only

    @classmethod
    def from_profile(cls, profile, mesh_shape) -> "PartitionGraph":
        return cls.from_profile_sizes(profile,
                                      profile.axis_sizes(mesh_shape))

    @classmethod
    def from_profile_sizes(cls, profile,
                           axis_sizes: Dict[str, int]) -> "PartitionGraph":
        return cls(profile.rules, axis_sizes,
                   profile.last_dim_only, profile.anywhere)

    # -- seeding ------------------------------------------------------------
    def seed_spec(self, p: Node) -> Spec:
        shape = p.out_types[0].shape
        logical = p.attrs.get("logical_axes")
        if logical is None or len(logical) != len(shape):
            return (None,) * len(shape)
        spec: List[Optional[str]] = []
        used = set()
        last = len(shape) - 1
        for d, (sz, lg) in enumerate(zip(shape, logical)):
            a = self.rules.get(lg) if lg is not None else None
            if a is None or a not in self.sizes or self.sizes[a] <= 1 \
                    or sz % self.sizes[a] or a in used:
                spec.append(None)
                continue
            if (self.last_dim_only and lg not in self.anywhere
                    and len(shape) > 1 and d != last):
                spec.append(None)
                continue
            spec.append(a)
            used.add(a)
        return tuple(spec)

    def local(self, shape: Sequence[int], spec: Spec) -> Tuple[int, ...]:
        return tuple(sz // self.sizes[a] if a else sz
                     for sz, a in zip(shape, spec))

    # -- driver -------------------------------------------------------------
    def run(self, fn: Function):
        if any("pspec" in p.attrs for p in fn.parameters):
            return fn, {"already_partitioned": 1}
        if self.param_specs is None:
            seeds = [self.seed_spec(p) for p in fn.parameters]
        elif len(self.param_specs) != len(fn.parameters):
            raise PartitionError(
                f"{len(self.param_specs)} parameter specs for "
                f"{len(fn.parameters)} parameters of {fn.name}")
        else:
            seeds = self.param_specs
        inf = _Infer(self, fn, seeds)
        inf.run()
        rb = _Rebuild(self, inf)
        new_fn = rb.build(fn)
        stats = dict(rb.stats)
        stats["params_total"] = len(fn.parameters)
        return new_fn, stats


# ---------------------------------------------------------------------------
# phase 1: forward spec inference to fixpoint, with backward unification
# ---------------------------------------------------------------------------
class _Infer:
    def __init__(self, p: PartitionGraph, fn: Function,
                 param_specs: List[Spec]):
        self.p = p
        self.fn = fn
        self.param_specs = [tuple(s) for s in param_specs]
        self.specs: Dict[Tuple[int, int], Spec] = {}
        self.floors: Dict[Tuple[int, int], Dict[int, str]] = {}
        self.failed = set()              # memoized failed force attempts
        self.scan_memo: Dict[Tuple, Tuple[_Step, "_Infer", List[Spec]]] = {}
        self.result_specs: List[Spec] = []
        # (value, dim) pairs no backward force may shard: floors that a
        # later spec of the producer's inputs left it unable to honour
        self.veto: set = set()

    def spec(self, v: Value) -> Spec:
        return self.specs[_vkey(v)]

    def run(self) -> None:
        nodes = self.fn.nodes()
        for _ in range(8):
            for _ in range(16):
                if not self._forward(nodes, wish=True):
                    break
            else:
                raise PartitionError(
                    f"partition inference did not converge on "
                    f"{self.fn.name}")
            # one wish-free pass so recorded decisions match the fixpoint
            self._forward(nodes, wish=False)
            bad = self._unhonoured(nodes)
            if not bad:
                break
            # a floor was set while the producer's inputs could follow it
            # and a later spec of theirs stopped them: forbid it and infer
            # again from the seeds
            self.veto |= bad
            self.specs.clear()
            self.floors.clear()
            self.failed.clear()
            self.scan_memo.clear()
        else:
            raise PartitionError(
                f"partition floors did not settle on {self.fn.name}")
        self.result_specs = [self.spec(r) for r in self.fn.results]

    def _unhonoured(self, nodes: List[Node]) -> set:
        """(value, dim) pairs whose stored shard its producer's rule does
        not give from its inputs' final specs, for the ops whose floors
        :meth:`_go` pushes into their inputs (a new or size-1 broadcast
        dim is sharded for free and is not one)."""
        bad = set()
        for node in nodes:
            op = node.op
            if not (op in _UNARY or op in _BINARY or op in (
                    "Select", "Transpose", "Softmax", "LogSoftmax", "CumSum",
                    "Slice", "BroadcastInDim")):
                continue
            step = self._step(node, [self.spec(v) for v in node.inputs])
            free = set()
            if op == "BroadcastInDim":
                bdims = tuple(node.attrs["broadcast_dims"])
                xsh = node.inputs[0].shape
                free = {d for d in range(len(node.out_types[0].shape))
                        if d not in bdims or xsh[bdims.index(d)] <= 1}
            for j in range(node.n_outputs):
                got = self.spec(node.out(j))
                for d, (a, b) in enumerate(zip(got, step.out[j])):
                    if a is not None and b is None and d not in free:
                        bad.add((_vkey(node.out(j)), d))
        return bad

    def final_step(self, node: Node) -> _Step:
        ins = [self.spec(v) for v in node.inputs]
        if node.op == "Scan":
            return self.scan_memo[self._scan_key(node, ins)][0]
        return self._step(node, ins)

    def sub_for(self, node: Node) -> Tuple["_Infer", List[Spec]]:
        ins = [self.spec(v) for v in node.inputs]
        _, sub, cs = self.scan_memo[self._scan_key(node, ins)]
        return sub, cs

    # -- the fixpoint loop --------------------------------------------------
    def _forward(self, nodes: List[Node], wish: bool) -> bool:
        changed = False
        for i, p in enumerate(self.fn.parameters):
            changed |= self._store(p.out(0), self.param_specs[i])
        for node in nodes:
            if node.op == "Parameter":
                continue
            ins = [self.spec(v) for v in node.inputs]
            if node.op == "ShardingConstraint":
                changed |= self._store(node.out(0), ins[0])
                continue
            if node.op == "Scan":
                step = self._scan_step(node, ins)
            else:
                step = self._step(node, ins)
            for j in range(node.n_outputs):
                changed |= self._store(node.out(j), step.out[j])
            if wish:
                for (k, add) in step.wishes:
                    changed |= self._force(node.inputs[k], add)
        return changed

    def _store(self, v: Value, spec: Spec) -> bool:
        t = v.type
        spec = list(spec)
        if len(spec) != len(t.shape):
            raise PartitionError(
                f"{v.node.op} {v.node.name}: spec rank {len(spec)} vs "
                f"shape {t.shape}")
        for d, a in self.floors.get(_vkey(v), {}).items():
            if spec[d] is None:
                spec[d] = a
            elif spec[d] != a:
                raise PartitionError(
                    f"{v.node.name}: floor {a} conflicts with {spec[d]}")
        for d, a in enumerate(spec):
            if a is not None and t.shape[d] % self.p.sizes[a]:
                raise PartitionError(
                    f"{v.node.name}: dim {d} ({t.shape[d]}) not divisible "
                    f"by {a}={self.p.sizes[a]}")
        spec = tuple(spec)
        old = self.specs.get(_vkey(v))
        self.specs[_vkey(v)] = spec
        return old != spec

    # -- backward unification ----------------------------------------------
    def _force(self, v: Value, add: Dict[int, str]) -> bool:
        key = (_vkey(v), frozenset(add.items()))
        if key in self.failed:
            return False
        tentative: Dict[Tuple[int, int], Dict[int, str]] = {}
        if not self._go(v, dict(add), tentative):
            self.failed.add(key)
            return False
        for vk, fl in tentative.items():
            self.floors.setdefault(vk, {}).update(fl)
        return bool(tentative)

    def _go(self, v: Value, add: Dict[int, str], tent) -> bool:
        cur = self.specs.get(_vkey(v))
        if cur is None:
            return False
        add = {d: a for d, a in add.items() if cur[d] != a}
        for d, a in add.items():
            if (_vkey(v), d) in self.veto:
                return False
            if cur[d] is not None:        # already sharded differently
                return False
            if a in cur:                  # axis already used on another dim
                return False
            if v.shape[d] % self.p.sizes[a]:
                return False
        if not add:
            return True
        node, op = v.node, v.node.op
        if op == "BroadcastInDim":
            bdims = tuple(node.attrs["broadcast_dims"])
            x = node.inputs[0]
            down = {}
            for d, a in add.items():
                if d in bdims:
                    i = bdims.index(d)
                    if x.shape[i] > 1:
                        down[i] = a
                # else: dim is new or size-1 in the input — the shard is
                # absorbed for free (each device broadcasts to its slice)
            if down and not self._go(x, down, tent):
                return False
        elif op == "Iota":
            if node.attrs.get("dim") in add:
                return False              # values depend on the global index
        elif op in _UNARY:
            if not self._go(node.inputs[0], dict(add), tent):
                return False
        elif op in _BINARY or op == "Select":
            for x in node.inputs:
                if not self._go(x, dict(add), tent):
                    return False
        elif op == "Transpose":
            perm = tuple(node.attrs["perm"])
            if not self._go(node.inputs[0],
                            {perm[d]: a for d, a in add.items()}, tent):
                return False
        elif op in ("Softmax", "LogSoftmax", "CumSum"):
            if node.attrs["axis"] in add:
                return False
            if not self._go(node.inputs[0], dict(add), tent):
                return False
        elif op == "Slice":
            x = node.inputs[0]
            starts, stops = node.attrs["starts"], node.attrs["stops"]
            strides = node.attrs.get("strides") or (1,) * x.rank
            for d in add:
                if not (starts[d] == 0 and stops[d] == x.shape[d]
                        and strides[d] == 1):
                    return False
            if not self._go(x, dict(add), tent):
                return False
        else:
            return False
        tent.setdefault(_vkey(v), {}).update(add)
        return True

    # -- per-op rules -------------------------------------------------------
    def _step(self, node: Node, ins: List[Spec]) -> _Step:
        op = node.op
        if op == "Constant" or op == "Iota":
            return _Step([(None,) * len(t.shape) for t in node.out_types], [])
        if op in _UNARY:
            return _Step([ins[0]], [ins[0]])
        if op in _BINARY or op == "Select":
            out, consumed, wishes = self._unify(ins)
            return _Step([out], consumed, wishes=wishes)
        if op == "BroadcastInDim":
            bdims = tuple(node.attrs["broadcast_dims"])
            xsh = node.inputs[0].shape
            out = [None] * len(node.out_types[0].shape)
            for i, d in enumerate(bdims):
                if xsh[i] > 1:
                    out[d] = ins[0][i]
            return _Step([out], [ins[0]])
        if op == "Transpose":
            perm = tuple(node.attrs["perm"])
            return _Step([tuple(ins[0][p] for p in perm)], [ins[0]])
        if op == "Reshape":
            return self._reshape_step(node, ins)
        if op == "Slice":
            xsh = node.inputs[0].shape
            starts, stops = node.attrs["starts"], node.attrs["stops"]
            strides = node.attrs.get("strides") or (1,) * len(xsh)
            c = [a if a is None or (starts[d] == 0 and stops[d] == xsh[d]
                                    and strides[d] == 1) else None
                 for d, a in enumerate(ins[0])]
            return _Step([c], [c])
        if op == "Pad":
            low, high = node.attrs["low"], node.attrs["high"]
            c = [a if a is None or (low[d] == 0 and high[d] == 0) else None
                 for d, a in enumerate(ins[0])]
            return _Step([c], [c])
        if op == "Reverse":
            axes = set(node.attrs["axes"])
            c = [None if d in axes else a for d, a in enumerate(ins[0])]
            return _Step([c], [c])
        if op == "Concat":
            ax = node.attrs["axis"]
            out, consumed, wishes = self._unify(ins, skip_dims={ax})
            out = list(out)
            out[ax] = None
            consumed = [tuple(None if d == ax else a
                              for d, a in enumerate(c)) for c in consumed]
            return _Step([out], consumed, wishes=wishes)
        if op in ("ReduceSum", "ReduceMax", "ReduceMin"):
            axes = set(node.attrs["axes"])
            keep = node.attrs.get("keepdims", False)
            rop = {"ReduceSum": "sum", "ReduceMax": "max",
                   "ReduceMin": "min"}[op]
            reduces = [(a, rop) for d, a in enumerate(ins[0])
                       if d in axes and a is not None]
            if keep:
                out = [None if d in axes else a
                       for d, a in enumerate(ins[0])]
            else:
                out = [a for d, a in enumerate(ins[0]) if d not in axes]
            return _Step([out], [ins[0]], reduces=reduces)
        if op in ("Softmax", "LogSoftmax", "CumSum"):
            ax = node.attrs["axis"]
            c = [None if d == ax else a for d, a in enumerate(ins[0])]
            return _Step([c], [c])
        if op == "ArgMax":
            ax = node.attrs["axis"]
            c = [None if d == ax else a for d, a in enumerate(ins[0])]
            return _Step([[a for d, a in enumerate(c) if d != ax]], [c])
        if op == "TopK":
            c = list(ins[0][:-1]) + [None]
            return _Step([c, c], [c])
        if op in ("RMSNorm", "LayerNorm"):
            c0 = list(ins[0][:-1]) + [None]      # normalized (last) axis
            cons = [c0] + [(None,) * len(s) for s in ins[1:]]
            return _Step([c0], cons)
        if op == "DotGeneral":
            return self._dot_step(node, ins)
        if op == "Gather":
            ax = node.attrs["axis"]
            c0 = [None if d == ax else a for d, a in enumerate(ins[0])]
            out = list(c0[:ax]) + list(ins[1]) + list(c0[ax + 1:])
            out, fixes = _dedupe(out)
            c1 = list(ins[1])
            for pos in fixes:                    # duplicate axis: gather the
                if ax <= pos < ax + len(c1):     # dim it came from
                    c1[pos - ax] = None
                elif pos < ax:
                    c0[pos] = None
                else:                            # a table dim after axis
                    c0[pos - len(c1) + 1] = None
            return _Step([out], [c0, c1])
        if op == "DynamicSlice":
            xsh = node.inputs[0].shape
            sizes = node.attrs["sizes"]
            c0 = [a if a is None or sizes[d] == xsh[d] else None
                  for d, a in enumerate(ins[0])]
            cons = [c0] + [ins[k] for k in range(1, len(ins))]
            return _Step([c0], cons)
        if op == "Attention":
            return self._attention_step(node, ins)
        if op == "LinearRecurrence":
            ax = node.attrs["axis"]
            out, consumed, wishes = self._unify(ins, skip_dims={ax})
            out = list(out)
            out[ax] = None
            consumed = [tuple(None if d == ax else a
                              for d, a in enumerate(c)) for c in consumed]
            return _Step([out], consumed, wishes=wishes)
        # fallback: gather every sharded operand dim, emit replicated.
        # Covers ScatterAdd/DynamicUpdateSlice/fused compounds/pre-existing
        # collectives/anything new — correct by construction.
        cons = [(None,) * len(s) for s in ins]
        return _Step([(None,) * len(t.shape) for t in node.out_types], cons)

    def _unify(self, ins: List[Spec], skip_dims=frozenset()):
        """Elementwise equal-shape unification with backward wishes."""
        rank = len(ins[0])
        consumed = [list(s) for s in ins]
        out: List[Optional[str]] = []
        wishes = []
        for d in range(rank):
            if d in skip_dims:
                out.append(None)
                continue
            axes = {s[d] for s in ins if s[d] is not None}
            if len(axes) == 1 and all(s[d] is not None for s in ins):
                out.append(next(iter(axes)))
            elif len(axes) == 1:
                a = next(iter(axes))
                for i, s in enumerate(ins):
                    if s[d] is None:
                        wishes.append((i, {d: a}))
                    else:
                        consumed[i][d] = None
                out.append(None)
            elif axes:
                for i in range(len(ins)):
                    consumed[i][d] = None
                out.append(None)
            else:
                out.append(None)
        return out, consumed, wishes

    def _reshape_step(self, node: Node, ins: List[Spec]) -> _Step:
        in_shape = node.inputs[0].shape
        out_shape = node.out_types[0].shape
        consumed = list(ins[0])
        out: List[Optional[str]] = [None] * len(out_shape)
        for in_dims, out_dims in _match_groups(in_shape, out_shape):
            sharded = [(i, ins[0][i]) for i in in_dims if ins[0][i]]
            if not sharded:
                continue
            ok = False
            if len(sharded) == 1:
                i, a = sharded[0]
                size = self.p.sizes[a]
                # a shard survives a reshape iff it sits on the leftmost
                # non-singleton dim of its factor group on both sides
                if all(in_shape[j] == 1 for j in in_dims if j < i):
                    for d in out_dims:
                        if out_shape[d] == 1:
                            continue
                        if out_shape[d] % size == 0:
                            out[d] = a
                            ok = True
                        break
            if not ok:
                for i, _ in sharded:
                    consumed[i] = None
        return _Step([out], [consumed])

    def _dot_step(self, node: Node, ins: List[Spec]) -> _Step:
        lc, rc = node.attrs["contracting"]
        lb, rb = node.attrs["batch"]
        la, ra = ins
        cl, cr = list(la), list(ra)
        wishes, reduces = [], []
        for dl, dr in zip(lb, rb):
            a, b = la[dl], ra[dr]
            if a == b:
                continue
            if a and b:
                cl[dl] = None
                cr[dr] = None
            elif a:
                wishes.append((1, {dr: a}))
                cl[dl] = None
            else:
                wishes.append((0, {dl: b}))
                cr[dr] = None
        for dl, dr in zip(lc, rc):
            a, b = la[dl], ra[dr]
            if a and a == b:
                reduces.append((a, "sum"))       # row-parallel cut
            elif a:
                if not self.p.exact:
                    wishes.append((1, {dr: a}))
                cl[dl] = None
            elif b:
                if not self.p.exact:
                    wishes.append((0, {dl: b}))
                cr[dr] = None
        lfree = [d for d in range(len(la)) if d not in lb and d not in lc]
        rfree = [d for d in range(len(ra)) if d not in rb and d not in rc]
        out = [cl[d] for d in lb] + [cl[d] for d in lfree] \
            + [cr[d] for d in rfree]
        refs = [("b", i) for i in range(len(lb))] \
            + [("l", d) for d in lfree] + [("r", d) for d in rfree]
        seen = {a for a, _ in reduces}
        for pos, a in enumerate(out):
            if a is None:
                continue
            if a in seen:
                out[pos] = None
                side, d = refs[pos]
                if side in ("b", "l"):
                    cl[lb[d] if side == "b" else d] = None
                if side in ("b", "r"):
                    cr[rb[d] if side == "b" else d] = None
            else:
                seen.add(a)
        return _Step([out], [cl, cr], reduces=reduces, wishes=wishes)

    def _attention_step(self, node: Node, ins: List[Spec]) -> _Step:
        q, k, v = ins[0], ins[1], ins[2]
        consumed = [list(s) for s in ins]
        wishes = []
        # batch dim unifies; head dim passes through when q/k/v agree
        # (GQA repetition is a local-shape ratio, unaffected by the cut)
        out = [None, None, None, None]
        for d in (0, 1):
            axes = {s[d] for s in (q, k, v) if s[d] is not None}
            if len(axes) == 1 and all(s[d] is not None for s in (q, k, v)):
                out[d] = next(iter(axes))
            elif len(axes) == 1:
                a = next(iter(axes))
                for i in range(3):
                    if ins[i][d] is None:
                        wishes.append((i, {d: a}))
                    else:
                        consumed[i][d] = None
            elif axes:
                for i in range(3):
                    consumed[i][d] = None
        for i in range(3):                      # seq/head-dim axes: local
            consumed[i][2] = None
            consumed[i][3] = None
        for i in range(3, len(ins)):            # q_offset stays replicated
            consumed[i] = [None] * len(ins[i])
        return _Step([out], consumed, wishes=wishes)

    # -- Scan ---------------------------------------------------------------
    def _scan_key(self, node: Node, ins: List[Spec]):
        return (id(node), tuple(tuple(s) for s in ins))

    def _scan_step(self, node: Node, ins: List[Spec]) -> _Step:
        key = self._scan_key(node, ins)
        if key in self.scan_memo:
            return self.scan_memo[key][0]
        nc, nx = node.attrs["n_carry"], node.attrs["n_xs"]
        body: Function = node.attrs["body"]
        consumed = [list(s) for s in ins]
        xs_specs = []
        for kx in range(nc, nc + nx):
            consumed[kx][0] = None               # the scanned (length) dim
            xs_specs.append(tuple(consumed[kx][1:]))
        consts = [tuple(consumed[kx]) for kx in range(nc + nx, len(ins))]
        cs = [tuple(consumed[kx]) for kx in range(nc)]
        sub = None
        for _ in range(8):
            sub = _Infer(self.p, body, list(cs) + xs_specs + consts)
            sub.run()
            # meet: a carry stays sharded only when the body keeps it so
            meet = [tuple(a if a == b else None for a, b in zip(ci, oi))
                    for ci, oi in zip(cs, sub.result_specs[:nc])]
            if meet == cs:
                break
            cs = meet
        else:
            raise PartitionError(f"scan carry specs did not converge "
                                 f"in {body.name}")
        for kx in range(nc):
            consumed[kx] = list(cs[kx])
        ys = sub.result_specs[nc:]
        out = [list(c) for c in cs] + [[None] + list(y) for y in ys]
        step = _Step(out, consumed)
        self.scan_memo[key] = (step, sub, cs)
        return step


def _dedupe(spec: List[Optional[str]]):
    """Keep the first occurrence of each axis; return fixed positions."""
    seen, fixes = set(), []
    for d, a in enumerate(spec):
        if a is None:
            continue
        if a in seen:
            spec[d] = None
            fixes.append(d)
        else:
            seen.add(a)
    return spec, fixes


def _match_groups(a: Sequence[int], b: Sequence[int]):
    """Factor-group matching between two shapes of equal product."""
    groups = []
    i = j = 0
    while i < len(a) or j < len(b):
        ai, bj = [], []
        pa = pb = 1
        if i < len(a):
            ai.append(i)
            pa = a[i]
            i += 1
        if j < len(b):
            bj.append(j)
            pb = b[j]
            j += 1
        while pa != pb:
            if pa < pb:
                if i >= len(a):
                    raise PartitionError(f"reshape groups: {a} vs {b}")
                pa *= a[i]
                ai.append(i)
                i += 1
            else:
                if j >= len(b):
                    raise PartitionError(f"reshape groups: {a} vs {b}")
                pb *= b[j]
                bj.append(j)
                j += 1
        groups.append((ai, bj))
    return groups


# ---------------------------------------------------------------------------
# phase 2: rebuild at local shapes, inserting collectives
# ---------------------------------------------------------------------------
class _Rebuild:
    def __init__(self, p: PartitionGraph, inf: _Infer):
        self.p = p
        self.inf = inf
        self.map: Dict[Tuple[int, int], Value] = {}
        self.newspecs: Dict[int, List[Spec]] = {}   # id(new node) -> specs
        self.stats = collections.Counter()

    def build(self, fn: Function,
              desired_results: Optional[List[Spec]] = None) -> Function:
        new_params = []
        for p in fn.parameters:
            spec = self.inf.spec(p.out(0))
            t = p.out_types[0]
            q = ops.parameter(self.p.local(t.shape, spec), t.dtype, p.name)
            q.attrs.update(p.attrs)
            q.attrs["pspec"] = tuple(spec)
            self.map[(id(p), 0)] = q.out(0)
            self.newspecs[id(q)] = [tuple(spec)]
            if any(spec):
                self.stats["params_sharded"] += 1
            new_params.append(q)
        for node in fn.nodes():
            if node.op != "Parameter":
                self._emit(node)
        results = []
        for kx, r in enumerate(fn.results):
            v = self.map[_vkey(r)]
            spec = self.newspecs[id(v.node)][v.index]
            want = desired_results[kx] if desired_results else spec
            results.append(self._gather_to(v, spec, want))
        for v in results:
            n = v.node
            n.attrs["out_pspecs"] = tuple(self.newspecs[id(n)])
        return Function(new_params, results, fn.name)

    def _gather_to(self, v: Value, spec: Spec, want: Spec) -> Value:
        for d, (a, w) in enumerate(zip(spec, want)):
            if a == w:
                continue
            if a is None or w is not None:
                raise PartitionError(
                    f"cannot reshard {v.node.name} dim {d}: {a} -> {w}")
            v = ops.all_gather(v, a, axis=d, axis_size=self.p.sizes[a])
            self.stats["all_gather"] += 1
            new_spec = tuple(None if e == d else s
                             for e, s in enumerate(spec))
            self.newspecs[id(v.node)] = [new_spec]
            spec = new_spec
        return v

    def _emit(self, node: Node) -> None:
        if node.op == "ShardingConstraint":
            # the explicit cut supersedes the hint; drop it
            self.map[(id(node), 0)] = self.map[_vkey(node.inputs[0])]
            self.stats["constraints_dropped"] += 1
            return
        step = self.inf.final_step(node)
        new_ins = []
        for v, want in zip(node.inputs, step.consumed):
            nv = self.map[_vkey(v)]
            nv = self._gather_to(nv, self.newspecs[id(nv.node)][nv.index],
                                 tuple(want))
            new_ins.append(nv)
        out_specs = [self.inf.spec(node.out(i))
                     for i in range(node.n_outputs)]
        if node.op == "Scan":
            outs = self._emit_scan(node, new_ins, out_specs)
        else:
            attrs = dict(node.attrs)
            local_types = [t.with_shape(self.p.local(t.shape, s))
                           for t, s in zip(node.out_types, out_specs)]
            if node.op in ("Reshape", "BroadcastInDim"):
                attrs["shape"] = local_types[0].shape
            elif node.op == "Slice":
                # sharded dims are full-extent (enforced in inference):
                # start stays 0, stop shrinks to the local size
                attrs["stops"] = tuple(
                    st // self.p.sizes[a] if a else st
                    for st, a in zip(attrs["stops"], step.consumed[0]))
            elif node.op == "DynamicSlice":
                attrs["sizes"] = tuple(
                    sz // self.p.sizes[a] if a else sz
                    for sz, a in zip(attrs["sizes"], out_specs[0]))
            q = Node(node.op, new_ins, attrs, local_types, name=node.name)
            self.newspecs[id(q)] = [tuple(s) for s in out_specs]
            outs = list(q.outs())
        for a, rop in step.reduces:
            outs[0] = ops.all_reduce(outs[0], a, rop)
            self.stats["all_reduce"] += 1
            self.newspecs[id(outs[0].node)] = [tuple(out_specs[0])]
        for i, v in enumerate(outs):
            self.map[(id(node), i)] = v

    def _emit_scan(self, node: Node, new_ins: List[Value],
                   out_specs: List[Spec]) -> List[Value]:
        nc, nx = node.attrs["n_carry"], node.attrs["n_xs"]
        body: Function = node.attrs["body"]
        sub, cs = self.inf.sub_for(node)
        desired = list(cs) + [tuple(y) for y in sub.result_specs[nc:]]
        body_rb = _Rebuild(self.p, sub)
        new_body = body_rb.build(body, desired_results=desired)
        self.stats.update(body_rb.stats)
        self.stats["scan_bodies"] += 1
        outs = ops.scan(new_body, new_ins[:nc], xs=new_ins[nc:nc + nx],
                        consts=new_ins[nc + nx:],
                        length=node.attrs["length"],
                        reverse=node.attrs.get("reverse", False),
                        unroll=node.attrs.get("unroll", 1))
        for v in outs:
            self.newspecs.setdefault(id(v.node), [None] * v.node.n_outputs)
            self.newspecs[id(v.node)][v.index] = tuple(out_specs[v.index])
        return list(outs)


# the ops :meth:`_Infer._step` has a rule for; any other op takes the
# fallback and gathers each sharded operand
RULED_OPS = _UNARY | _BINARY | frozenset({
    "Parameter", "Constant", "Iota", "Select", "BroadcastInDim",
    "Transpose", "Reshape", "Slice", "Pad", "Reverse", "Concat",
    "ReduceSum", "ReduceMax", "ReduceMin", "Softmax", "LogSoftmax",
    "CumSum", "ArgMax", "TopK", "RMSNorm", "LayerNorm", "DotGeneral",
    "Gather", "DynamicSlice", "Attention", "LinearRecurrence", "Scan",
    "ShardingConstraint"})


_COLLECTIVE_OPS = frozenset({"AllGather", "AllReduce", "ReduceScatter",
                             "AllToAll", "CollectivePermute"})


def fallback_gathers(fn: Function) -> Dict[str, int]:
    """The AllGathers of a partitioned Function that the fallback rule
    inserted, by the op they feed (nodes of Scan bodies counted once,
    not by trip count).  The rebuild inserts one gather per consumer
    edge, so each AllGather that feeds an op outside :data:`RULED_OPS`
    is one the fallback asked for."""
    out: Dict[str, int] = collections.Counter()

    def walk(f: Function) -> None:
        for node in f.nodes():
            if node.op == "Scan":
                walk(node.attrs["body"])
            elif node.op not in RULED_OPS and node.op not in _COLLECTIVE_OPS:
                n = sum(v.node.op == "AllGather" for v in node.inputs)
                if n:
                    out[node.op] += n

    walk(fn)
    return dict(out)


# ---------------------------------------------------------------------------
# multi-shard simulator (tests): real cross-shard collective semantics
# ---------------------------------------------------------------------------
def simulate_shards(fn: Function, inputs: Sequence[Any],
                    axis_sizes: Dict[str, int]) -> List[Any]:
    """Run a partitioned Function over simulated device groups.

    Splits the global ``inputs`` per each Parameter's ``pspec``, walks
    the graph once per shard in lockstep with *real* collective
    semantics (AllReduce combines across shards, AllGather concatenates
    in shard order), and reassembles global outputs from the result
    ``out_pspecs``.  The reference the jax shard_map lowering is checked
    against.  Single mesh axis only (all current profiles that reach
    shardmap serving use one)."""
    import numpy as np

    from ...transformers.interpreter import EVAL

    if len(axis_sizes) != 1:
        raise NotImplementedError("simulate_shards: one mesh axis only")
    (axis, n), = axis_sizes.items()
    n = int(n)

    def split(x, spec):
        x = np.asarray(x)
        for d, a in enumerate(spec):
            if a == axis:
                blk = x.shape[d] // n
                return [np.take(x, range(i * blk, (i + 1) * blk), axis=d)
                        for i in range(n)]
        return [x] * n

    def join(pieces, spec):
        for d, a in enumerate(spec):
            if a == axis:
                return np.concatenate(pieces, axis=d)
        return pieces[0]

    def run(f: Function, shard_inputs: List[List[Any]]) -> List[List[Any]]:
        envs = [dict() for _ in range(n)]
        for i in range(n):
            for p, x in zip(f.parameters, shard_inputs[i]):
                envs[i][id(p)] = [np.asarray(x)]
        for node in f.nodes():
            op = node.op
            if op == "Parameter":
                continue
            argss = [[envs[i][id(v.node)][v.index] for v in node.inputs]
                     for i in range(n)]
            if op == "AllReduce":
                rop = node.attrs.get("reduce_op", "sum")
                stack = [argss[i][0] for i in range(n)]
                tot = stack[0]
                for x in stack[1:]:
                    if rop == "max":
                        tot = np.maximum(tot, x)
                    elif rop == "min":
                        tot = np.minimum(tot, x)
                    else:
                        tot = tot + x
                if rop == "mean":
                    tot = tot / n
                outs = [[tot]] * n
            elif op == "AllGather":
                ax = node.attrs["axis"]
                cat = np.concatenate([argss[i][0] for i in range(n)],
                                     axis=ax)
                outs = [[cat]] * n
            elif op == "ReduceScatter":
                ax = node.attrs["axis"]
                tot = argss[0][0]
                for i in range(1, n):
                    tot = tot + argss[i][0]
                pieces = np.split(tot, n, axis=ax)
                outs = [[pieces[i]] for i in range(n)]
            elif op == "Scan":
                outs = run_scan(node, argss)
            elif op in EVAL:
                outs = [EVAL[op](node, argss[i]) for i in range(n)]
            else:
                raise NotImplementedError(f"simulate_shards: {op}")
            for i in range(n):
                envs[i][id(node)] = outs[i]
        return [[envs[i][id(r.node)][r.index] for r in f.results]
                for i in range(n)]

    def run_scan(node: Node, argss):
        nc, nx = node.attrs["n_carry"], node.attrs["n_xs"]
        if node.attrs.get("reverse"):
            raise NotImplementedError("simulate_shards: reverse scan")
        body: Function = node.attrs["body"]
        length = node.attrs["length"]
        carr = [list(argss[i][:nc]) for i in range(n)]
        consts = [argss[i][nc + nx:] for i in range(n)]
        ys = [[] for _ in range(n)]
        for t in range(length):
            ins_t = [carr[i]
                     + [argss[i][nc + kx][t] for kx in range(nx)]
                     + list(consts[i]) for i in range(n)]
            outs_t = run(body, ins_t)
            for i in range(n):
                carr[i] = list(outs_t[i][:nc])
                ys[i].append(outs_t[i][nc:])
        outs = []
        for i in range(n):
            stacked = [np.stack([ys[i][t][kx] for t in range(length)])
                       for kx in range(len(body.results) - nc)]
            outs.append(carr[i] + stacked)
        return outs

    shard_inputs = [[] for _ in range(n)]
    for p, x in zip(fn.parameters, inputs):
        spec = p.attrs.get("pspec") or (None,) * len(p.out_types[0].shape)
        for i, piece in enumerate(split(x, spec)):
            shard_inputs[i].append(piece)
    per_shard = run(fn, shard_inputs)
    out = []
    for kx, r in enumerate(fn.results):
        pspecs = r.node.attrs.get("out_pspecs")
        spec = pspecs[r.index] if pspecs else (None,) * len(r.shape)
        out.append(join([per_shard[i][kx] for i in range(n)], spec))
    return out
