"""IR-building model library.

Models here are *frontends*: they build nGraph IR Functions (via
``repro_torch.core.ops``) that any transformer can compile.  Each architecture
family has a graph builder producing train / prefill / decode graphs plus
``ParamInfo`` metadata consumed by the sharding policy.
"""
from .builder import ModelBuilder, ParamSpec  # noqa: F401
from .lm import build_graphs, ModelGraphs  # noqa: F401
