"""Backend: the unified compilation entry point (paper sec. 4).

``Backend.create("jax").compile(fn, CompileOptions(level="O2"))`` is the
only sanctioned way to turn IR into something executable: the backend runs
the pass pipeline itself (at its default level unless the options say
otherwise), performs backend code generation, and memoizes the result in a
per-backend cache keyed on the canonical graph signature plus the options —
the serve/decode hot path compiles once per process, period.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple, Type

from ..core.function import Function
from ..core.passes import run_pipeline
from .compiled import CompiledFunction
from .options import CompileOptions, OptionsError


@dataclasses.dataclass
class CacheStats:
    hits: int
    misses: int
    size: int
    # persistent (on-disk) layer — zero when no cache_dir is configured
    disk_hits: int = 0
    disk_misses: int = 0
    disk_evictions: int = 0
    # autotuner — reused records vs fresh sweeps
    autotune_hits: int = 0
    autotune_sweeps: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class Backend:
    """Base class: one instance per (backend name, backend opts).

    Subclasses implement :meth:`_codegen` — everything else (pipeline,
    cache, metadata attachment) is shared here.
    """

    name = "base"
    default_level = "O1"

    def __init__(self, **backend_opts):
        self.backend_opts = backend_opts
        self._cache: Dict[Tuple, CompiledFunction] = {}
        self._inflight: Dict[Tuple, threading.Event] = {}
        self._lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0
        self.autotune_hits = 0
        self.autotune_sweeps = 0

    # -- registry / construction --------------------------------------------
    _REGISTRY: Dict[str, Type["Backend"]] = {}
    _INSTANCES: Dict[Tuple, "Backend"] = {}

    @classmethod
    def register(cls, backend_cls: Type["Backend"]) -> Type["Backend"]:
        cls._REGISTRY[backend_cls.name] = backend_cls
        return backend_cls

    @classmethod
    def available(cls) -> List[str]:
        return sorted(cls._REGISTRY)

    @classmethod
    def create(cls, name: str, *, fresh: bool = False,
               **backend_opts) -> "Backend":
        """Get the backend named ``name``.

        Instances are memoized per (name, backend_opts) so every caller in
        a process shares one compile cache; ``fresh=True`` bypasses the
        memo (isolated cache + counters, e.g. for benchmarks)."""
        if name not in cls._REGISTRY:
            raise KeyError(
                f"no backend {name!r}; available: {cls.available()}")
        if fresh:
            return cls._REGISTRY[name](**backend_opts)
        key = (name, tuple(sorted(backend_opts.items())))
        inst = cls._INSTANCES.get(key)
        if inst is None:
            inst = cls._INSTANCES[key] = cls._REGISTRY[name](**backend_opts)
        return inst

    # -- the one compile path ------------------------------------------------
    def compile(self, fn: Function,
                options: Optional[CompileOptions] = None) -> CompiledFunction:
        """Optimize + codegen ``fn``; memoized on (graph signature, options).

        The cache key is the canonical structural signature plus the
        parameter names (named-parameter calling must keep working on a
        hit), the *resolved* opt level, and the options.  Concurrent
        compiles of the same key are deduplicated: one thread builds, the
        rest wait and receive the same executable.

        The persistent disk cache, the autotuner, graph partitioning and
        gradient compression (``cache_dir``, ``autotune``, ``partition``/
        ``mesh_shape``, ``compress_grads``) come with later slices of the
        torch port and are rejected here with a clear error."""
        if options is None:
            options = CompileOptions()
        if not isinstance(options, CompileOptions):
            raise TypeError(
                f"options must be CompileOptions, got {type(options).__name__}"
                " — legacy **kwargs go through CompileOptions.from_kwargs()")
        n_params = len(fn.parameters)
        bad = [i for i in options.donate_argnums
               if not 0 <= i < n_params]
        if bad:
            raise OptionsError(
                f"donate_argnums {bad} out of range for {fn.name} "
                f"({n_params} parameters)")
        _reject_later_slices(options)
        level = options.level or self.default_level
        key = (fn.signature(), tuple(p.name for p in fn.parameters),
               level, options.cache_key())
        while True:
            with self._lock:
                hit = self._cache.get(key)
                if hit is not None:
                    self.cache_hits += 1
                    return hit
                waiter = self._inflight.get(key)
                if waiter is None:
                    self._inflight[key] = threading.Event()
                    break  # this thread builds
            waiter.wait()  # another thread is building this key; retry
        try:
            compiled = self._build(fn, options, level, key)
            with self._lock:
                self.cache_misses += 1
                self._cache[key] = compiled
            return compiled
        finally:
            with self._lock:
                self._inflight.pop(key).set()

    def _build(self, fn: Function, options: CompileOptions, level: str,
               key: Tuple) -> CompiledFunction:
        """Build one executable: the full pipeline, then codegen."""
        opt_fn, report = run_pipeline(
            fn, level,
            fuse={"swiglu": options.fuse_swiglu,
                  "norm_matmul": options.fuse_norm_matmul,
                  "rotary_qkv": options.fuse_rotary_qkv})
        call, raw, lower = self._codegen(opt_fn, options)
        return CompiledFunction(
            opt_fn, call, backend=self.name, options=options,
            report=report, signature=key[0], raw=raw, lower=lower)

    def _codegen(self, fn: Function, options: CompileOptions
                 ) -> Tuple[Callable, Optional[Callable], Optional[Callable]]:
        """Backend code generation for an already-optimized graph.

        Returns ``(call, raw, lower)``: ``call`` takes/returns numpy,
        ``raw`` is the backend-native callable (or None to reuse ``call``),
        ``lower`` is the AOT hook (or None if unsupported)."""
        raise NotImplementedError

    # -- cache introspection -------------------------------------------------
    def cache_stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(
                self.cache_hits, self.cache_misses, len(self._cache),
                autotune_hits=self.autotune_hits,
                autotune_sweeps=self.autotune_sweeps)

    def clear_cache(self) -> None:
        """Reset the in-memory cache and counters."""
        with self._lock:
            self._cache.clear()
            self.cache_hits = 0
            self.cache_misses = 0
            self.autotune_hits = 0
            self.autotune_sweeps = 0


def _reject_later_slices(options: CompileOptions) -> None:
    """The options whose machinery the torch port has not ported yet."""
    later = {"cache_dir": options.cache_dir is not None,
             "autotune": options.autotune,
             "partition": options.partition is not None,
             "mesh_shape": options.mesh_shape is not None,
             "compress_grads": options.compress_grads}
    bad = sorted(k for k, v in later.items() if v)
    if bad:
        raise OptionsError(
            f"{bad}: the disk cache, the autotuner, graph partitioning and "
            f"gradient compression come with later slices of the torch port")


def register_backend(backend_cls: Type[Backend]) -> Type[Backend]:
    return Backend.register(backend_cls)


def available_backends() -> List[str]:
    return Backend.available()
