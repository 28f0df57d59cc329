"""Compiler passes over the IR (paper sec. 4).

``run_pipeline(fn, level)`` applies the standard nGraph-style pipeline:
  O0: nothing (raw bridge output)
  O1: paper-faithful — constant folding, CSE, algebraic simplification,
      layout assignment (transpose elimination/sinking), DCE
  O2: beyond-paper — O1 + pattern-matched compounding (fusion)
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


def standard_pipeline(level: str = "O1", fuse: dict = None) -> PassManager:
    """``fuse`` gates the matmul-level compounds individually (keys
    ``swiglu``/``norm_matmul``/``rotary_qkv``, missing = on).

    Gradient compression and graph partitioning (the reference's
    ``CompressAllReduce`` and ``PartitionGraph``) come with the
    tensor-parallel slice of the port."""
    if level == "O0":
        return PassManager([])
    passes = [ConstantFolding(), CSE(), AlgebraicSimplify(), LayoutAssignment(),
              CSE(), DCE()]
    if level == "O2":
        # compounding first: constant folding erases the mask subgraphs the
        # attention pattern keys on
        passes = [FuseCompounds(enable=fuse), ConstantFolding(), CSE(),
                  AlgebraicSimplify(), LayoutAssignment(), CSE(), DCE()]
    return PassManager(passes)


def run_pipeline(fn, level: str = "O1", **kw):
    return standard_pipeline(level, **kw).run(fn)
