"""Compiler passes over the IR (paper sec. 4).

``run_pipeline(fn, level)`` applies the standard nGraph-style pipeline:
  O0: nothing (raw bridge output)
  O1: paper-faithful — constant folding, CSE, algebraic simplification,
      layout assignment (transpose elimination/sinking), DCE
  O2: beyond-paper — O1 + pattern-matched compounding (fusion) + optional
      gradient compression
"""
from .base import Pass, PassManager, PassStats, PipelineReport  # noqa: F401
from .constant_folding import ConstantFolding  # noqa: F401
from .cse import CSE  # noqa: F401
from .dce import DCE  # noqa: F401
from .algebraic import AlgebraicSimplify  # noqa: F401
from .decompose import Decompose  # noqa: F401
from .fusion import FuseCompounds  # noqa: F401
from .layout import LayoutAssignment  # noqa: F401
from .liveness import liveness_intervals  # noqa: F401
from .memory import MemoryPlan, plan_memory  # noqa: F401
from .grad_compress import CompressAllReduce  # noqa: F401
from .partition import PartitionError, PartitionGraph, simulate_shards  # noqa: F401


def standard_pipeline(level: str = "O1", compress_grads: bool = False,
                      fuse: dict = None,
                      partition: PartitionGraph = None) -> PassManager:
    """``fuse`` gates the matmul-level compounds individually (keys
    ``swiglu``/``norm_matmul``/``rotary_qkv``, missing = on) — the
    autotuner flips them per graph via ``CompileOptions.fuse_*``.

    ``partition`` (a configured :class:`PartitionGraph`) runs last: it
    cuts the *optimized* graph into a per-device program with explicit
    collective nodes (``CompileOptions.partition``/``mesh_shape``)."""
    if level == "O0":
        return PassManager([partition] if partition else [])
    passes = [ConstantFolding(), CSE(), AlgebraicSimplify(), LayoutAssignment(),
              CSE(), DCE()]
    if level == "O2":
        # compounding first: constant folding erases the mask subgraphs the
        # attention pattern keys on
        passes = [FuseCompounds(enable=fuse), ConstantFolding(), CSE(),
                  AlgebraicSimplify(), LayoutAssignment(), CSE(), DCE()]
        if compress_grads:
            passes.append(CompressAllReduce())
    if partition is not None:
        passes.append(partition)
    return PassManager(passes)


def run_pipeline(fn, level: str = "O1", **kw):
    return standard_pipeline(level, **kw).run(fn)
