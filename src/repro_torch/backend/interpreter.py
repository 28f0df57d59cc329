"""Interpreter backend: the numpy reference executor behind the Backend API.

Default level is O0 (run exactly the graph it was given): the interpreter
is the semantic oracle the other backends are tested against, and arena
execution (``options.arena``) needs node identity preserved.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from ..core.function import Function
from ..transformers.interpreter import evaluate
from .base import Backend, register_backend
from .options import CompileOptions


@register_backend
class InterpreterBackend(Backend):
    """Pure-numpy reference executor (with optional planned-arena mode).

    Participates in the persistent disk cache like any backend (the
    stored optimized graph + PipelineReport skip the pipeline on a cold
    process) but has no AOT executable format — rehydration re-enters
    :meth:`_codegen`, which is just a closure over ``evaluate``."""

    name = "interpreter"
    default_level = "O0"

    def _partition_pass(self, options: CompileOptions, fn: Function):
        """The oracle runs the global graph under ``mode='pjit'`` (the
        mesh is ignored, as the reference's interpreter ignores it);
        ``mode='shardmap'`` partitions as on any backend."""
        if options.mode == "pjit":
            return None
        return super()._partition_pass(options, fn)

    def _codegen(self, fn: Function, options: CompileOptions
                 ) -> Tuple[Callable, Optional[Callable], Optional[Callable]]:
        arena = options.arena
        if arena is True:
            from ..core.passes import plan_memory
            arena = plan_memory(fn)

        def call(*args):
            return evaluate(fn, list(args), arena=arena)

        return call, None, None
