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
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

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
        self._autotune_mem: Dict[Any, Dict] = {}  # tuning records, in-process
        self._disk_caches: Dict[Tuple, Any] = {}  # (dir, budget) -> cache

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

        ``options.autotune=True`` first resolves the attention and fusion
        knobs via :mod:`repro_torch.backend.autotune` (cached tuning
        record, else a sweep), then compiles with the concrete winner.
        When a cache dir is configured (``options.cache_dir`` or
        ``$REPRO_CACHE_DIR``) an in-memory miss consults
        :class:`~repro_torch.backend.diskcache.DiskCompileCache` before
        running the pass pipeline: a disk hit rehydrates the optimized
        graph + PipelineReport + metadata and only re-runs backend
        codegen."""
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
        if options.autotune:
            from . import autotune as _autotune
            options = _autotune.resolve(self, fn, options)
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
        """Build one executable: disk-cache rehydrate, else full pipeline."""
        from . import diskcache
        disk = self._disk_for(options)
        dkey = None
        if disk is not None:
            dkey = diskcache.entry_key(key[0], key[1], level, options,
                                       self.name, self._key_opts())
        if dkey is not None:
            entry = disk.load(dkey)
            if entry is not None:
                hydrated = self._from_entry(entry, options, key[0])
                if hydrated is not None:
                    return hydrated
                # the entry read fine but wouldn't hydrate (e.g. alien
                # graph rejected by codegen) — the full pipeline runs, so
                # reporting a disk hit would let warm-start CI gates pass
                # on a run that re-paid everything
                disk.hits -= 1
                disk.misses += 1
        opt_fn, report = run_pipeline(
            fn, level, compress_grads=options.compress_grads,
            fuse={"swiglu": options.fuse_swiglu,
                  "norm_matmul": options.fuse_norm_matmul,
                  "rotary_qkv": options.fuse_rotary_qkv},
            partition=self._partition_pass(options, fn))
        call, raw, lower = self._codegen(opt_fn, options)
        compiled = CompiledFunction(
            opt_fn, call, backend=self.name, options=options,
            report=report, signature=key[0], raw=raw, lower=lower)
        if dkey is not None:
            disk.store(
                dkey, fn=opt_fn, report=report, level=level,
                backend_name=self.name, options=options,
                memory_plan=compiled.memory_plan, cost=compiled.cost)
        return compiled

    def _partition_pass(self, options: CompileOptions, fn: Function):
        """The configured PartitionGraph pass for these options (None when
        not partitioning).  ``mode='shardmap'`` cuts the graph under
        ``options.partition``'s profile.  ``mode='pjit'`` always cuts it:
        the port has no GSPMD, so the pass runs under the profile
        ("default" when None) over the mesh, seeded with
        ``options.in_shardings`` when given
        (:func:`~repro_torch.backend.sharding.pjit_partition`)."""
        if options.mode == "pjit":
            from .sharding import pjit_partition
            return pjit_partition(options, fn)
        if options.partition is None or options.mode != "shardmap":
            return None
        from ..core.passes import PartitionGraph
        from .sharding import mesh_axis_sizes, partition_profile
        profile = partition_profile(options.partition)
        if options.mesh_shape is not None:
            sizes = profile.axis_sizes(options.mesh_shape)
        else:
            sizes = {a: n for a, n in mesh_axis_sizes(options.mesh).items()
                     if a in profile.axes}
        return PartitionGraph.from_profile_sizes(profile, sizes)

    def _from_entry(self, entry: Dict, options: CompileOptions,
                    signature: str) -> Optional[CompiledFunction]:
        """Rehydrate a disk entry: codegen the stored *optimized* graph
        (the pipeline is skipped — that's the point; the port has no
        executable format, so emission runs again)."""
        opt_fn = entry["function"]
        try:
            call, raw, lower = self._codegen(opt_fn, options)
        except Exception:
            return None  # alien graph; fall back to a full build
        # memory plan stays lazy: the stored totals are introspection-only
        # (cache_tool), and a plan without its buffer assignments would
        # silently disable the interpreter's arena mode — recomputing from
        # the rehydrated graph gives the identical full plan
        cost = None
        if entry.get("cost"):
            from ..core.cost import Cost
            c = entry["cost"]
            cost = Cost(flops=float(c["flops"]), bytes=float(c["bytes"]),
                        by_op=c.get("by_op"))
        return CompiledFunction(
            opt_fn, call, backend=self.name, options=options,
            report=entry["report"], signature=signature, raw=raw,
            lower=lower, cost=cost, from_disk=True)

    # -- persistence hooks ---------------------------------------------------
    def _disk_for(self, options: CompileOptions):
        """The DiskCompileCache for these options, or None (disabled)."""
        from . import diskcache
        root = diskcache.resolve_dir(options)
        if root is None:
            return None
        budget = diskcache.resolve_budget(options)
        with self._lock:
            dc = self._disk_caches.get((root, budget))
            if dc is None:
                dc = diskcache.DiskCompileCache(root, budget)
                self._disk_caches[(root, budget)] = dc
        return dc

    def _key_opts(self) -> Dict:
        """The backend opts that disk entries and tuning records are
        keyed on: ``backend_opts``, plus what a backend adds (the torch
        backend adds its device's name)."""
        return self.backend_opts

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
            disks = list(self._disk_caches.values())
            return CacheStats(
                self.cache_hits, self.cache_misses, len(self._cache),
                disk_hits=sum(d.hits for d in disks),
                disk_misses=sum(d.misses for d in disks),
                disk_evictions=sum(d.evictions for d in disks),
                autotune_hits=self.autotune_hits,
                autotune_sweeps=self.autotune_sweeps)

    def clear_cache(self) -> None:
        """Reset the in-memory cache and counters (disk entries persist —
        that is their job; use DiskCompileCache.clear or
        scripts/torch_cache_tool.py)."""
        with self._lock:
            self._cache.clear()
            self.cache_hits = 0
            self.cache_misses = 0
            self.autotune_hits = 0
            self.autotune_sweeps = 0
            self._disk_caches.clear()


def register_backend(backend_cls: Type[Backend]) -> Type[Backend]:
    return Backend.register(backend_cls)


def available_backends() -> List[str]:
    return Backend.available()
