"""Roofline analysis of a compiled, partitioned Function on the H100 (the
port of ``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds per step on the
target card, an H100 SXM (data-sheet constants below):

    compute    = IR FLOPs per device / peak FLOP/s
    memory     = IR bytes per device / HBM bandwidth
    collective = sum over collectives of wire bytes / their axis's link

The FLOPs and bytes are the IR cost model's (``core/cost.py``): the
global ``function_cost`` of the unpartitioned graph (``ir_*``, Scan
bodies times their trip counts) over the devices, beside the per-device
cost of the partitioned function the backend compiled (``hlo_*``,
``CompiledFunction.cost``).

The collective census reads the partitioned IR, not HLO text: the port
has no HLO, so the reference's ``parse_collectives`` (an HLO parser) has
no counterpart.  :func:`census_collectives` walks the partitioned
Function's collective nodes (``torch_emit.COLLECTIVES``' five), scales
those in Scan bodies by the trip counts (nested Scans multiplied, as
``core/cost.py`` does), takes each group's size from the node's mesh
axis, and weights its result bytes by the reference's ring factors.
The IR's dtypes are what the card moves, so there is no bf16-on-TPU
halving: ``total_tpu_bytes`` equals ``total_bytes`` (the key stays, so
records read alike).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# -- target-hardware constants: NVIDIA H100 SXM5 data sheet ------------------
PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s per GPU
HBM_BW = 3.35e12           # HBM3 bytes/s per GPU
NVLINK_BW = 450e9          # NVLink 4, bytes/s per direction per GPU
NIC_BW = 50e9              # one 400 Gb/s NIC per GPU, bytes/s
# the link each mesh axis's collectives cross: ``model`` lies inside one
# 8-GPU HGX node (NVLink), ``data`` and ``pod`` span nodes (the network).
# A TPU pod's ICI is uniform, so the reference has one LINK_BW; an H100
# cluster is not, and one constant would misstate either axis.
LINK_BW: Dict[str, float] = {"model": NVLINK_BW, "data": NIC_BW,
                             "pod": NIC_BW}

COLLECTIVE_KINDS = {"AllGather": "all-gather", "AllReduce": "all-reduce",
                    "ReduceScatter": "reduce-scatter",
                    "AllToAll": "all-to-all",
                    "CollectivePermute": "collective-permute"}


@dataclasses.dataclass
class CollectiveCensus:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]  # ring-weighted wire bytes per device
    tpu_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # wire bytes per device by mesh axis (each axis has its own link)
    bytes_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)
    nodes: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    @property
    def total_tpu_bytes(self) -> float:
        """The reference's bf16-on-TPU estimate; here the bytes as the IR
        types them, the same as :attr:`total_bytes`."""
        return sum(self.tpu_bytes_by_kind.values()) or self.total_bytes


def _wire_bytes(kind: str, size: float, g: int) -> float:
    """The reference's ring factors for a collective whose result holds
    ``size`` bytes per device over a group of ``g``."""
    ring = (g - 1) / g
    if kind == "all-gather":
        return size * ring                # result held per device
    if kind == "all-reduce":
        return 2.0 * size * ring          # RS + AG ring
    if kind == "reduce-scatter":
        return size * (g - 1)             # result is the shard
    if kind == "all-to-all":
        return size * ring
    return size                           # collective-permute


def census_collectives(fn, axis_sizes: Dict[str, int]) -> CollectiveCensus:
    """Every collective node of the partitioned ``fn``, its result bytes
    weighted by the ring factor of its group (the size of its mesh axis,
    ``axis_sizes``), scaled by the trip counts of the Scans around it.
    ``nodes`` counts the nodes themselves, once each."""
    counts: Dict[str, int] = {}
    by_kind: Dict[str, float] = {}
    by_axis: Dict[str, float] = {}
    nodes: Dict[str, int] = {}

    def walk(f, mult: float) -> None:
        for node in f.nodes():
            if node.op == "Scan":
                walk(node.attrs["body"], mult * node.attrs["length"])
                continue
            kind = COLLECTIVE_KINDS.get(node.op)
            if kind is None:
                continue
            nodes[kind] = nodes.get(kind, 0) + 1
            axis = node.attrs["axis_name"]
            g = int(axis_sizes[axis])
            if g <= 1:
                continue
            size = float(sum(t.nbytes for t in node.out_types))
            wire = _wire_bytes(kind, size, g) * mult
            counts[kind] = counts.get(kind, 0) + int(mult)
            by_kind[kind] = by_kind.get(kind, 0.0) + wire
            by_axis[axis] = by_axis.get(axis, 0.0) + wire

    walk(fn, 1.0)
    return CollectiveCensus(counts, by_kind, dict(by_kind), by_axis, nodes)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    hlo_flops: float            # per device: the compiled partitioned cost
    hlo_bytes: float            # per device: the same
    ir_flops: float             # GLOBAL, from the IR cost model (scan-exact)
    ir_bytes: float             # GLOBAL HBM-traffic estimate, scan-exact
    collective_bytes: float     # ring-weighted wire bytes per device
    model_flops: float          # analytic 6ND (train) / 2ND (inference), global
    collectives: Dict[str, int]
    coll_bytes_by_kind: Dict[str, float]
    per_device_memory: float    # peak per-device bytes (the memory plan)
    # each axis's share of collective_bytes; None = every byte on the
    # model axis's NVLink
    coll_bytes_by_axis: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.ir_flops / self.n_devices / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.ir_bytes / self.n_devices / HBM_BW

    @property
    def t_collective(self) -> float:
        by_axis = self.coll_bytes_by_axis
        if by_axis is None:
            by_axis = {"model": self.collective_bytes}
        return sum(b / LINK_BW[a] for a, b in by_axis.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / compiled FLOPs: how much of the compiled compute
        is 'useful' (catches remat/redundancy waste)."""
        return self.model_flops / self.ir_flops if self.ir_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs utilization if the step ran at the max of the three
        terms (the achievable-MFU proxy this report scores)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        denom = t * self.n_devices * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "ir_flops_global": self.ir_flops,
            "ir_bytes_global": self.ir_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_counts": self.collectives,
            "collective_bytes_by_kind": self.coll_bytes_by_kind,
            "per_device_memory_bytes": self.per_device_memory,
        }


def model_flops_for(builder, cfg, shape_kind: str, seq: int, batch: int) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D inference; MoE counts
    active params only (routed experts scaled by top_k/E)."""
    n_total = 0
    n_expert = 0
    for s in builder.params.values():
        n_total += s.size
        if "/we_" in s.name or s.name.endswith(("we_gate", "we_up", "we_down")):
            n_expert += s.size
    active = n_total - n_expert
    if cfg.n_experts:
        active += n_expert * cfg.top_k / cfg.n_experts
    tokens = batch * (seq if shape_kind in ("train", "prefill") else 1)
    factor = 6.0 if shape_kind == "train" else 2.0
    return factor * active * tokens
