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

The reference's pjit glue (``param_shardings``, ``data_shardings``,
``graph_shardings``, ``train_step_shardings``,
``make_production_mesh``) serves only its dry-run tooling and is not
ported here.
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

    def as_rules(self) -> Dict[str, Tuple[str, ...]]:
        """Flat logical->mesh-axes table: every known logical name,
        resolved."""
        return {k: self.resolve(k) for k in self.rules if k is not None}


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
