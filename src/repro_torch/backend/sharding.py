"""The sharding API on torch: policies, meshes and partition profiles (the
port of ``repro/backend/sharding.py``).

Graphs carry *logical* axis names (builders tag every parameter and
input); this module maps them onto mesh axes, as the per-logical-axis
rule table the :class:`~repro_torch.core.passes.PartitionGraph` pass
uses to cut a graph into per-device programs (``partition_profile``).
A policy's specs are plain tuples (one mesh axis, a tuple of axes, or
None per dim), where the reference builds jax ``PartitionSpec``\\ s.

A :class:`DeviceMesh` names the devices a partitioned graph runs on, in
the shape of ``mesh_shape``: the shard executor
(:mod:`repro_torch.backend.sharded`) runs shard ``i`` on device ``i``.
Several shards may name one device: on a one-card machine
``make_mesh((2,), ("model",), devices=["cuda:0"] * 2)`` runs two shards
side by side on ``cuda:0``, and on the CPU every shard names ``cpu``.

The pjit glue (``param_shardings``, ``data_shardings``,
``graph_shardings``, ``train_step_shardings``) gives
``CompileOptions(mode="pjit", in_shardings=...)`` its per-parameter
specs, as the reference's gives jit its shardings.  The port
has no GSPMD: ``mode="pjit"`` runs the PartitionGraph pass with those
specs stamped on the Parameters (:func:`pjit_partition`).  The pass
shards a dim over one mesh axis, so a mesh with a ``pod`` axis is folded
for it: pod x data become one ``data`` axis (:func:`fold_pods`; see
there for what that changes).

``make_production_mesh`` is 256 H100s as 32 HGX nodes of 8, the
``model`` axis inside a node's NVLink; with no devices named its
devices are ``meta`` (a dry run attaches no card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ParamInfo:
    """Logical description of one parameter tensor."""

    name: str
    shape: Tuple[int, ...]
    dtype: Any
    logical_axes: Tuple[Optional[str], ...]  # one entry per dim


# logical axis -> mesh axes, per policy profile
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),  # batch dims (pod filtered out on 1-pod mesh)
    "vocab": ("model",),
    "embed": ("zero",),        # ZeRO/FSDP shard of the embedding dim
    "ffn": ("model",),         # TP shard of the hidden dim
    "heads": ("model",),
    "kv_heads": (),            # few kv heads: keep replicated
    "kv_seq": ("model",),      # decode KV caches: sequence-shard on model
    "experts": ("expert",),    # resolved to real axes by the profile
    "expert_ffn": (),
    "layers": (),              # stacked-layer leading dim stays unsharded
    "conv": (),
    "seq": (),
    "state": (),
    None: (),
}


@dataclasses.dataclass
class ShardingPolicy:
    """Maps logical axes to mesh axes and produces per-dim specs."""

    rules: Dict[str, Tuple[str, ...]]
    zero_axes: Tuple[str, ...] = ("data",)  # FSDP axes of 'embed' dims
    expert_axes: Tuple[str, ...] = ("model",)
    batch_axes: Tuple[str, ...] = ("data",)  # + 'pod' when present

    def resolve(self, logical: Optional[str]) -> Tuple[str, ...]:
        axes = self.rules.get(logical, ())
        out = []
        for a in axes:
            if a == "expert":
                out.extend(self.expert_axes)
            elif a == "zero":
                out.extend(self.zero_axes)
            else:
                out.append(a)
        return tuple(out)

    def spec_for(self, info: ParamInfo, mesh) -> Tuple[Any, ...]:
        """One entry per dim: a mesh axis, a tuple of axes, or None."""
        sizes = mesh_axis_sizes(mesh)
        used = set()
        entries: List[Any] = []
        for dim, logical in zip(info.shape, info.logical_axes):
            axes = [a for a in self.resolve(logical)
                    if a in sizes and a not in used]
            # keep only axes that divide the dim evenly
            keep: List[str] = []
            prod = 1
            for a in axes:
                if dim % (prod * sizes[a]) == 0:
                    keep.append(a)
                    prod *= sizes[a]
            used.update(keep)
            if not keep:
                entries.append(None)
            elif len(keep) == 1:
                entries.append(keep[0])
            else:
                entries.append(tuple(keep))
        return tuple(entries)

    def batch_spec(self, mesh, rank: int = 2) -> Tuple[Any, ...]:
        """Batch tensors: leading dim over (pod+)data axes."""
        axes = tuple(a for a in ("pod",) + tuple(self.batch_axes)
                     if a in mesh.axis_names)
        axes = tuple(dict.fromkeys(axes))
        lead = axes if len(axes) > 1 else (axes[0] if axes else None)
        return (lead,) + (None,) * (rank - 1)

    def sharding_for(self, info: ParamInfo, mesh) -> Tuple[Any, ...]:
        """The spec of ``info`` on ``mesh`` (the reference's
        ``NamedSharding`` is its ``PartitionSpec`` here)."""
        return self.spec_for(info, mesh)

    def replicated(self, mesh) -> Tuple[Any, ...]:
        """Every dim replicated (``PartitionSpec()``)."""
        return ()

    def as_rules(self) -> Dict[str, Tuple[str, ...]]:
        """Flat logical->mesh-axes table: every known logical name,
        resolved."""
        return {k: self.resolve(k) for k in self.rules if k is not None}

    def input_sharding(self, mesh, shape, logical_spec) -> Tuple[Any, ...]:
        """The spec of a data input from its logical per-dim spec."""
        info = ParamInfo("_input", tuple(shape), None, tuple(logical_spec))
        return self.sharding_for(info, mesh)


def policy_for(profile: str = "default", mesh=None) -> ShardingPolicy:
    """Profiles implement per-arch parallelism mixes."""
    rules = dict(DEFAULT_RULES)
    if profile == "default":
        return ShardingPolicy(rules)
    if profile == "zero3_pod":
        # shard the FSDP ('embed') dims across pods too: ZeRO-3 over all chips
        return ShardingPolicy(rules, zero_axes=("pod", "data"))
    if profile == "expert_parallel":
        # MoE: experts across data*model (EP), used when E divides the product
        return ShardingPolicy(rules, expert_axes=("data", "model"))
    if profile == "zero3_pod_ep":
        # deepseek-v3: ZeRO-3 across pods + 256-way expert parallelism
        return ShardingPolicy(rules, zero_axes=("pod", "data"),
                              expert_axes=("data", "model"))
    if profile == "expert_tp":
        # MoE with few experts: shard inside each expert instead
        rules["experts"] = ()
        rules["expert_ffn"] = ("model",)
        return ShardingPolicy(rules)
    raise KeyError(f"unknown sharding profile {profile}")


# per-arch parallelism profile
ARCH_PROFILES: Dict[str, str] = {
    "deepseek-v3-671b": "zero3_pod_ep",
    "mixtral-8x22b": "expert_tp",
}


def policy_for_arch(arch_name: str) -> ShardingPolicy:
    return policy_for(ARCH_PROFILES.get(arch_name, "default"))


def profile_for_arch(arch_name: str) -> str:
    """The arch's profile name, for ``CompileOptions(partition=...)``."""
    return ARCH_PROFILES.get(arch_name, "default")


# ---------------------------------------------------------------------------
# partition profiles: the PartitionGraph pass's view of a policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PartitionProfile:
    """What the :class:`~repro_torch.core.passes.partition.PartitionGraph`
    pass needs from ``CompileOptions(partition=..., mesh_shape=...)``:
    mesh axis names (positional, matching ``mesh_shape``), a
    single-mesh-axis rule per logical axis, and whether parameter
    sharding is restricted to each weight's *output* (last) dim.

    ``last_dim_only=True`` is the serving tensor-parallel plan: only
    column-parallel weight shards (wq/wk/wv/w_gate/w_up on their output
    dim, rank-1 biases), with AllGather at the transitions back to
    replicated weights -- every arithmetic op then computes the
    single-device values, which is what makes greedy serving
    token-for-token reproducible across ``tp``.  Row-parallel cuts
    (AllReduce after the matmul) remain available to profiles with
    ``last_dim_only=False``; they re-round split bf16 contractions and
    so trade exactness for halved activations.
    """

    name: str
    axes: Tuple[str, ...]                 # mesh axis names, one per mesh dim
    rules: Dict[str, str]                 # logical axis -> mesh axis
    last_dim_only: bool = False
    # logical axes exempt from the last-dim restriction (e.g. 'kv_heads',
    # which tags an interior dim of the paged KV pool buffers)
    anywhere: Tuple[str, ...] = ()

    def axis_sizes(self, mesh_shape: Sequence[int]) -> Dict[str, int]:
        if len(mesh_shape) != len(self.axes):
            raise ValueError(
                f"partition profile {self.name!r} has axes {self.axes} "
                f"but mesh_shape {tuple(mesh_shape)}")
        return dict(zip(self.axes, (int(s) for s in mesh_shape)))


def _policy_pass_rules(policy: ShardingPolicy,
                       mesh_axes: Tuple[str, ...]) -> Dict[str, str]:
    """Flatten a policy to the pass's one-axis-per-logical table (the
    pass shards each dim over at most one mesh axis).  Resolved axes
    outside the profile's mesh (e.g. 'pod' on a (data, model) mesh) are
    dropped, not blindly taken first."""
    out = {}
    for logical in policy.rules:
        if logical is None:
            continue
        axes = [a for a in policy.resolve(logical) if a in mesh_axes]
        if axes:
            out[logical] = axes[0]
    return out


def partition_profile(name: str) -> PartitionProfile:
    """Resolve ``CompileOptions.partition`` to a pass profile."""
    if name == "tp":
        return PartitionProfile(
            "tp", axes=("model",),
            rules={"heads": "model", "kv_heads": "model", "ffn": "model"},
            last_dim_only=True, anywhere=("kv_heads",))
    # policy profiles double as partition profiles on a (data, model)
    # mesh; 'batch' resolves to the data axis
    policy = policy_for(name)  # raises KeyError on unknown names
    rules = _policy_pass_rules(policy, ("data", "model"))
    rules.setdefault("batch", "data")
    return PartitionProfile(name, axes=("data", "model"), rules=rules)


PARTITION_PROFILES: Tuple[str, ...] = (
    "tp", "default", "zero3_pod", "expert_parallel", "zero3_pod_ep",
    "expert_tp")


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
class DeviceMesh:
    """Named mesh axes over an ndarray of ``torch.device`` (shaped like
    ``mesh_shape``), as a jax ``Mesh`` has ``axis_names`` and
    ``devices``.  A device may appear more than once."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"mesh of shape {devices.shape} needs {devices.ndim} axis "
                f"names, got {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(str(a) for a in axis_names)

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.flat]
        return (f"DeviceMesh({dict(zip(self.axis_names, self.devices.shape))}"
                f", devices={devs})")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[Any]] = None) -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes`` over ``devices``
    (``"cpu"``, ``"cuda:0"``, ``torch.device``, in mesh order), by default
    the first ``prod(shape)`` cards.  ``devices=["cuda:0"] * 2`` puts two
    shards on one card."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        count = torch.cuda.device_count()
        if count < n:
            raise RuntimeError(
                f"a mesh of shape {shape} needs {n} cards but only "
                f"{count} are attached (name the devices: "
                f"make_mesh({shape}, {tuple(axes)}, devices=[...]))")
        devices = [f"cuda:{i}" for i in range(n)]
    # a bare "cuda" names card 0, as resolve_device reads it
    devs = [torch.device("cuda", 0) if torch.device(d) == torch.device(
        "cuda") else torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"a mesh of shape {shape} takes {n} devices, "
                         f"got {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(shape), axes)


def make_production_mesh(multi_pod: bool = False,
                         devices: Optional[Sequence[Any]] = None
                         ) -> DeviceMesh:
    """The production mesh: 256 H100s as 32 HGX nodes of 8, ``(32, 8)``
    over ``("data", "model")``, the ``model`` axis inside a node's NVLink;
    with ``multi_pod`` two such pods, ``(2, 32, 8)`` over ``("pod",
    "data", "model")``.  With no ``devices`` named every device is
    ``meta``: a dry run compiles and walks the plan with no card."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        devices = ["meta"] * math.prod(shape)
    return make_mesh(shape, axes, devices=devices)


def production_mesh_name(multi_pod: bool) -> str:
    return "hgx2x32x8" if multi_pod else "hgx32x8"


def make_host_mesh(model_parallel: Optional[int] = None,
                   devices: Optional[Sequence[Any]] = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over ``devices``, by default every
    attached card (``devices=["cpu"]`` for the CPU)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "make_host_mesh: no card is attached (name the devices: "
                "make_host_mesh(devices=['cpu']))")
    n = len(devices)
    mp = model_parallel or 1
    return make_mesh((n // mp, mp), ("data", "model"), devices=devices)


def is_meta(mesh) -> bool:
    return all(torch.device(d).type == "meta" for d in mesh.devices.flat)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch (pod+data when present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def shared_card_recipe(shape: Sequence[int],
                       axes: Sequence[str] = ("model",)) -> str:
    """The explicit mesh that runs every shard of ``shape`` on one card."""
    shape = tuple(int(s) for s in shape)
    return (f"make_mesh({shape}, {tuple(axes)}, "
            f"devices=['cuda:0'] * {math.prod(shape)})")


def mesh_for_options(options, device: Any = None) -> Optional[DeviceMesh]:
    """The mesh a shardmap compile runs on: ``options.mesh`` when given,
    else a mesh of ``options.mesh_shape`` with the partition profile's
    axis names over ``device``'s type (a ``torch.device`` or its
    string; None = the card).  On the CPU every shard names ``cpu``; on
    CUDA the mesh needs one card per shard, and with fewer it raises,
    naming the explicit mesh that puts the shards on one card."""
    if options.mesh is not None:
        return options.mesh
    if options.mesh_shape is None:
        return None
    prof = partition_profile(options.partition or "tp")
    n = math.prod(options.mesh_shape)
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cpu":
        devs = ["cpu"] * n
    else:
        count = torch.cuda.device_count()
        if count < n:
            raise RuntimeError(
                f"mesh_shape {options.mesh_shape} needs {n} devices but "
                f"only {count} are attached (for shards that share one "
                f"card pass CompileOptions(mesh="
                f"{shared_card_recipe(options.mesh_shape, prof.axes)}))")
        devs = [f"cuda:{i}" for i in range(n)]
    return make_mesh(options.mesh_shape, prof.axes, devices=devs)


# ---------------------------------------------------------------------------
# mode="pjit": the partition pass under the policy's specs
# ---------------------------------------------------------------------------
def fold_pods(mesh) -> DeviceMesh:
    """The mesh the partition pass and the shard executor see for a pjit
    compile.  The pass shards a dim over one mesh axis, so a ``("pod",
    "data", ...)`` mesh becomes ``("data", ...)`` with pod x data folded
    into one axis (pods are the major axis, so the fold is a reshape and
    shard ``i`` keeps its device).  A dim the policy shards over
    ``("pod", "data")`` (batch; ZeRO under the ``zero3_pod`` profiles)
    keeps its 64 shards.  A dim it shards over ``data`` alone (ZeRO's
    ``embed`` under the other profiles: 32 shards, replicated across the
    pods) is sharded over all 64 here: the pods do not replicate it.
    A mesh without a ``pod`` axis is returned as it is."""
    names = tuple(mesh.axis_names)
    if "pod" not in names:
        return mesh
    if names[:2] != ("pod", "data"):
        raise ValueError(f"a pod axis folds into the data axis after it; "
                         f"the mesh has axes {names}")
    shape = tuple(mesh.devices.shape)
    return DeviceMesh(mesh.devices.reshape((shape[0] * shape[1],) +
                                           shape[2:]), ("data",) + names[2:])


def pass_spec(spec: Sequence[Any], shape: Sequence[int],
              sizes: Dict[str, int], name: str = "") -> Tuple[Any, ...]:
    """An ``in_shardings`` spec (one entry per dim: an axis, a tuple of
    axes or None; shorter than the rank means the rest replicated) as
    the pass's, one axis per dim over the folded mesh's ``sizes``:
    ``pod`` is ``data`` (:func:`fold_pods`), and of several axes the
    first is kept, as :func:`_policy_pass_rules` keeps it.  A dim the
    policy shards over ``pod`` alone (a batch of 32 on the 2 x 32 x 8
    mesh) has no cut on the folded axis: the pods replicate it
    (:func:`pods_replicate` names them).  An axis the mesh lacks, or a
    dim its axis does not divide, raises."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"{name}: spec {spec} has more entries than the "
                         f"shape {tuple(shape)} has dims")
    out: List[Optional[str]] = []
    for dim, e in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        axes = (e,) if isinstance(e, str) else tuple(e or ())
        if axes == ("pod",):
            axes = ()
        axes = tuple(dict.fromkeys("data" if a == "pod" else a
                                   for a in axes))
        if not axes:
            out.append(None)
            continue
        a = axes[0]
        if a not in sizes:
            raise ValueError(f"{name}: spec {spec} names {a!r}; the mesh "
                             f"has axes {tuple(sizes)}")
        if dim % sizes[a]:
            raise ValueError(f"{name}: dim {dim} of {tuple(shape)} does "
                             f"not divide over {a}={sizes[a]}")
        out.append(a)
    return tuple(out)


def pods_replicate(in_shardings, params) -> List[str]:
    """The parameters with a dim the policy shards over ``pod`` alone,
    which the folded mesh replicates (:func:`pass_spec`)."""
    def pod_only(e) -> bool:
        return ((e,) if isinstance(e, str) else tuple(e or ())) == ("pod",)

    return [p.name for s, p in zip(in_shardings, params)
            if any(pod_only(e) for e in s)]


def pjit_partition(options, fn):
    """The PartitionGraph pass of a ``mode="pjit"`` compile: the profile
    ``options.partition`` names ("default" when None) over the folded
    ``options.mesh``'s axis sizes, its Parameters seeded with
    ``options.in_shardings`` (:func:`pass_spec`) when given, else from
    their logical axes.  A mesh that shares no axis with the profile
    raises: nothing falls back to an unpartitioned compile."""
    from ..core.passes import PartitionGraph
    profile = partition_profile(options.partition or "default")
    sizes = mesh_axis_sizes(fold_pods(options.mesh))
    shared = {a: n for a, n in sizes.items() if a in profile.axes}
    if not shared:
        raise ValueError(
            f"mode='pjit': partition profile {profile.name!r} has axes "
            f"{profile.axes}, the mesh {tuple(sizes)}")
    specs = None
    if options.in_shardings is not None:
        params = fn.parameters
        if len(options.in_shardings) != len(params):
            raise ValueError(
                f"mode='pjit': {len(options.in_shardings)} in_shardings "
                f"for {len(params)} parameters of {fn.name}")
        specs = [pass_spec(s, p.out_types[0].shape, sizes, p.name)
                 for s, p in zip(options.in_shardings, params)]
    return PartitionGraph(profile.rules, sizes, profile.last_dim_only,
                          profile.anywhere, param_specs=specs)


# ---------------------------------------------------------------------------
# per-graph pjit glue
# ---------------------------------------------------------------------------
def param_shardings(builder, mesh, policy: ShardingPolicy) -> list:
    out = []
    for name in builder.param_names():
        s = builder.params[name]
        info = ParamInfo(s.name, s.shape, s.dtype, s.logical_axes)
        out.append(policy.sharding_for(info, mesh))
    return out


def data_shardings(builder, mesh, policy: ShardingPolicy) -> list:
    out = []
    for node in builder.inputs:
        spec = builder.input_specs[node.name]
        out.append(policy.input_sharding(mesh, node.out_types[0].shape, spec))
    return out


def graph_shardings(graphs, mesh, policy: Optional[ShardingPolicy] = None):
    """(in_shardings, axis_rules) for a prefill/decode graph."""
    policy = policy or policy_for_arch(graphs.cfg.name)
    ins = data_shardings(graphs.builder, mesh, policy) + \
        param_shardings(graphs.builder, mesh, policy)
    return tuple(ins), policy.as_rules()


def train_step_shardings(ts, mesh, policy: Optional[ShardingPolicy] = None):
    """(in_shardings, out_shardings, donate_argnums, axis_rules) for a
    train-step Function: (data..., step, *params, *m, *v) ->
    (loss, *params', *m', *v')."""
    policy = policy or policy_for_arch(ts.graphs.cfg.name)
    b = ts.graphs.builder
    data = data_shardings(b, mesh, policy)
    repl = policy.replicated(mesh)
    pshard = param_shardings(b, mesh, policy)
    ins = tuple(data) + (repl,) + tuple(pshard) * 3
    outs = (repl,) + tuple(pshard) * 3
    n_data = len(data)
    donate = tuple(range(n_data + 1, n_data + 1 + 3 * len(pshard)))
    return ins, outs, donate, policy.as_rules()
