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

    It has no executable format of its own: :meth:`_codegen` is just a
    closure over ``evaluate``.  The persistent disk cache is a later
    slice of the torch port (``Backend.compile`` refuses ``cache_dir``)."""

    name = "interpreter"
    default_level = "O0"

    def _codegen(self, fn: Function, options: CompileOptions
                 ) -> Tuple[Callable, Optional[Callable], Optional[Callable]]:
        arena = options.arena
        if arena is True:
            from ..core.passes import plan_memory
            arena = plan_memory(fn)

        def call(*args):
            return evaluate(fn, list(args), arena=arena)

        return call, None, None
