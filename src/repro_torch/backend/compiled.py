"""CompiledFunction: the opaque executable a Backend hands back.

The paper's contract (sec. 4): a bridge asks a named backend to compile a
``Function`` and receives something it can only *call* — every optimization,
kernel-selection, and partitioning decision is sealed behind this object.
It carries the compile artifacts as metadata: the :class:`PipelineReport`
from the pass pipeline, a liveness-driven memory plan, and the IR-level
cost estimate (both computed lazily — they are diagnostics, not hot path).
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

import numpy as np

from ..core.function import Function
from ..core.passes.base import PipelineReport
from .options import CompileOptions


class CompiledFunction:
    """A compiled Function: positional/named-callable, with metadata.

    ``__call__`` returns a list of numpy arrays (the stable cross-backend
    convention); ``raw`` exposes the backend-native callable (jax arrays,
    donation honored) for hot loops like the train step.
    """

    def __init__(
        self,
        fn: Function,
        call: Callable[..., List[np.ndarray]],
        *,
        backend: str,
        options: CompileOptions,
        report: PipelineReport,
        signature: str,
        raw: Optional[Callable] = None,
        lower: Optional[Callable] = None,
        memory_plan=None,
        cost=None,
        from_disk: bool = False,
    ):
        self.function = fn
        self.backend = backend
        self.options = options
        self.report = report
        self.signature = signature
        self.from_disk = from_disk  # hydrated from the persistent cache
        self._call = call
        self._raw = raw if raw is not None else call
        self._lower = lower
        # a disk hit arrives with the plan/cost already computed (they were
        # persisted alongside the graph); cold compiles stay lazy
        self._memory_plan = memory_plan
        self._cost = cost
        # NOTE: instances are shared process-wide via the backend compile
        # cache, so timing hooks are additive — setting would let one
        # caller silently unhook another's.
        self._timing_hooks: List[Callable[["CompiledFunction", float], None]] = []
        self.last_seconds: Optional[float] = None
        self.n_calls = 0

    # -- calling -------------------------------------------------------------
    def _bind(self, args, kwargs) -> List[Any]:
        params = self.function.parameters
        if not kwargs:
            bound = list(args)
        else:
            names = [p.name for p in params]
            pos = {n: i for i, n in enumerate(names)}
            bound: List[Any] = [_MISSING] * len(params)
            for i, a in enumerate(args):
                if i >= len(params):
                    break  # length error reported below
                bound[i] = a
            for k, v in kwargs.items():
                if k not in pos:
                    raise TypeError(
                        f"{self.function.name}: unknown parameter {k!r}; "
                        f"parameters are {names}")
                if bound[pos[k]] is not _MISSING:
                    raise TypeError(
                        f"{self.function.name}: parameter {k!r} given both "
                        f"positionally and by name")
                bound[pos[k]] = v
            missing = [n for n, b in zip(names, bound) if b is _MISSING]
            if missing:
                raise TypeError(
                    f"{self.function.name}: missing parameters {missing}")
        if len(bound) != len(params):
            raise TypeError(
                f"{self.function.name} expects {len(params)} args, "
                f"got {len(bound)}")
        return bound

    def __call__(self, *args, **kwargs) -> List[np.ndarray]:
        bound = self._bind(args, kwargs)
        t0 = time.perf_counter()
        out = self._call(*bound)
        dt = time.perf_counter() - t0
        self.last_seconds = dt
        self.n_calls += 1
        for hook in self._timing_hooks:
            hook(self, dt)
        return out

    def add_timing_hook(
            self, hook: Callable[["CompiledFunction", float], None]) -> None:
        """Register a per-call hook ``hook(compiled, seconds)``."""
        self._timing_hooks.append(hook)

    def remove_timing_hook(self, hook: Callable) -> None:
        self._timing_hooks.remove(hook)

    @property
    def raw(self) -> Callable:
        """Backend-native callable (jax arrays on jax; positional only)."""
        return self._raw

    def lower(self, *args):
        """AOT-lower (jax): accepts ShapeDtypeStructs, returns a Lowered."""
        if self._lower is None:
            raise NotImplementedError(
                f"backend {self.backend!r} does not support lower()")
        return self._lower(*args)

    def warmup(self) -> "CompiledFunction":
        """Trigger backend compilation with zero-filled inputs.

        Donation-safe: the zero buffers are freshly allocated here on
        every call — never the caller's arrays — so warming an executable
        compiled with ``donate_argnums`` can only invalidate its own
        temporaries.  The warmup goes through ``__call__`` (numpy
        convention), which device-puts fresh backend buffers per call, so
        a warmed donated executable serves subsequent real calls
        normally; serving engines may warm before entering a
        donation-honoring ``.raw`` hot loop."""
        self(*[np.zeros(t.shape, t.dtype) for t in self.function.in_types])
        return self

    # -- metadata ------------------------------------------------------------
    @property
    def memory_plan(self):
        """Liveness-driven arena plan for the optimized graph (lazy)."""
        if self._memory_plan is None:
            from ..core.passes import plan_memory
            self._memory_plan = plan_memory(self.function)
        return self._memory_plan

    @property
    def cost(self):
        """IR-level FLOPs/bytes estimate for the optimized graph (lazy)."""
        if self._cost is None:
            from ..core.cost import function_cost
            impl = self.options.attn_impl
            self._cost = function_cost(
                self.function,
                attn_impl=impl if impl in ("naive", "chunked") else "chunked")
        return self._cost

    def __repr__(self) -> str:
        return (f"CompiledFunction({self.function.name!r}, "
                f"backend={self.backend!r}, passes={len(self.report.stats)}, "
                f"nodes={self.report.nodes_after})")


_MISSING = object()
