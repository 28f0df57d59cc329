"""CompileOptions: the one declarative knob set for every backend.

Everything that used to be scattered across legacy ``Transformer.compile``
kwargs and the emitter context lives here as a frozen, validated dataclass.
Options
are part of the compile-cache key (see :meth:`CompileOptions.cache_key`), so
two compiles of the same Function with the same options share an executable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

_LEVELS = ("O0", "O1", "O2")
_MODES = ("jit", "shardmap", "pjit")
_ATTN_IMPLS = ("auto", "naive", "chunked")


class OptionsError(ValueError):
    """Raised for invalid CompileOptions field combinations."""


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Declarative compilation options, uniform across backends.

    ``level=None`` means "use the backend's default level" (O1 for jax,
    O0 for the interpreter).  Fields irrelevant to a backend are ignored by
    it (e.g. ``arena`` on jax, ``mesh`` on the interpreter).
    """

    # pass pipeline
    level: Optional[str] = None          # None | 'O0' | 'O1' | 'O2'
    compress_grads: bool = False         # O2 extra: bf16 AllReduce wires
    # per-compound fusion gates (O2 only; autotune can flip each one so a
    # losing fused kernel never ships)
    fuse_swiglu: bool = True
    fuse_norm_matmul: bool = True
    fuse_rotary_qkv: bool = True

    # jax emission / partitioning
    mode: str = "jit"                    # 'jit' | 'shardmap' | 'pjit'
    mesh: Any = None                     # jax Mesh (pjit mode)
    axis_rules: Any = None               # logical axis -> mesh axes
    # graph partitioning: `partition` names a profile from
    # repro.backend.sharding (e.g. 'tp'); with mode='shardmap' the
    # PartitionGraph pass cuts the graph and inserts explicit collective
    # nodes, with mode='pjit' the profile's policy derives in_shardings/
    # axis_rules so callers never hand-build them.  `mesh_shape` sizes
    # the device mesh (axis names come from the profile) when no `mesh`
    # object is passed — being plain ints, it disk-caches.
    partition: Optional[str] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    use_pallas: bool = False             # compound ops as Pallas kernels
    interpret_pallas: bool = True        # Pallas interpret mode (CPU-safe)
    remat_scan: bool = False             # checkpoint scan bodies
    attn_impl: str = "auto"              # 'auto' | 'naive' | 'chunked'
    attn_chunk: int = 1024
    # matmul-family Pallas tile shapes (matmul / SwiGLU / NormMatmul);
    # autotune sweeps these per (backend, shape-signature)
    mm_bm: int = 256
    mm_bn: int = 256
    mm_bk: int = 512
    static_jit: bool = True              # wrap emission in jax.jit
    in_shardings: Any = None
    out_shardings: Any = None
    donate_argnums: Tuple[int, ...] = ()

    # interpreter
    arena: Any = None                    # MemoryPlan | True (plan one) | None

    # persistence / tuning (NOT part of the executable's identity: they say
    # where artifacts live and how knobs get resolved, never what runs)
    cache_dir: Optional[str] = None      # on-disk compile cache root
    cache_budget_bytes: Optional[int] = None  # LRU eviction budget
    autotune: bool = False               # resolve attn knobs via the tuner

    def __post_init__(self):
        if self.level is not None and self.level not in _LEVELS:
            raise OptionsError(
                f"level must be one of {_LEVELS} or None, got {self.level!r}")
        if self.mode not in _MODES:
            raise OptionsError(
                f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.attn_impl not in _ATTN_IMPLS:
            raise OptionsError(
                f"attn_impl must be one of {_ATTN_IMPLS}, "
                f"got {self.attn_impl!r}")
        if not isinstance(self.attn_chunk, int) or self.attn_chunk <= 0:
            raise OptionsError(
                f"attn_chunk must be a positive int, got {self.attn_chunk!r}")
        for name in ("mm_bm", "mm_bn", "mm_bk"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                raise OptionsError(
                    f"{name} must be a positive int, got {v!r}")
        for name in ("fuse_swiglu", "fuse_norm_matmul", "fuse_rotary_qkv"):
            if not isinstance(getattr(self, name), bool):
                raise OptionsError(
                    f"{name} must be a bool, got {getattr(self, name)!r}")
        if self.mode == "pjit" and self.mesh is None:
            raise OptionsError("mode='pjit' requires a mesh")
        if self.mode == "pjit" and not self.static_jit:
            raise OptionsError("mode='pjit' requires static_jit=True")
        if self.partition is not None:
            raise OptionsError(
                f"partition={self.partition!r}: graph partitioning comes "
                f"with the tensor-parallel slice of the torch port")
        if self.mesh_shape is not None:
            try:
                shape = tuple(int(s) for s in self.mesh_shape)
            except (TypeError, ValueError):
                raise OptionsError(
                    f"mesh_shape must be a tuple of ints, got "
                    f"{self.mesh_shape!r}") from None
            if not shape or any(s < 1 for s in shape):
                raise OptionsError(
                    f"mesh_shape dims must be >= 1, got {self.mesh_shape!r}")
            object.__setattr__(self, "mesh_shape", shape)
            if self.partition is None:
                raise OptionsError("mesh_shape requires a partition profile "
                                   "(it names the mesh axes)")
        try:
            donate = tuple(int(i) for i in self.donate_argnums)
        except TypeError:
            raise OptionsError(
                f"donate_argnums must be a sequence of ints, "
                f"got {self.donate_argnums!r}") from None
        object.__setattr__(self, "donate_argnums", donate)
        if self.cache_dir is not None and not isinstance(self.cache_dir, str):
            raise OptionsError(
                f"cache_dir must be a str or None, got {self.cache_dir!r}")
        if self.cache_budget_bytes is not None and (
                not isinstance(self.cache_budget_bytes, int)
                or self.cache_budget_bytes <= 0):
            raise OptionsError(
                f"cache_budget_bytes must be a positive int or None, "
                f"got {self.cache_budget_bytes!r}")

    # fields that never participate in cache keys: `level` keys by its
    # *resolved* value, and the persistence/tuning knobs affect where
    # artifacts are stored (or how knobs are picked), not what executes.
    _NON_IDENTITY = ("level", "cache_dir", "cache_budget_bytes", "autotune")

    # -- compile-cache keying ------------------------------------------------
    def cache_key(self) -> Tuple:
        """A hashable, collision-safe token for these options.

        Primitive fields key by value; opaque objects (meshes, shardings,
        memory plans) key by identity — a distinct object is a cache miss,
        never a false hit.  ``level`` is excluded: the backend keys on the
        *resolved* level, so ``level=None`` and an explicit
        ``level=<backend default>`` share an executable.  ``cache_dir``/
        ``cache_budget_bytes``/``autotune`` are excluded too (see
        ``_NON_IDENTITY``)."""
        return tuple((f.name, _token(getattr(self, f.name)))
                     for f in dataclasses.fields(self)
                     if f.name not in self._NON_IDENTITY)

    def stable_token(self) -> Optional[Tuple]:
        """Like :meth:`cache_key` but process-stable, for the *disk* cache.

        Opaque objects (shardings, memory plans) key by ``id()``
        in-process, which is meaningless across processes — options
        carrying any return ``None``, meaning "not disk-cacheable".
        Meshes are the exception: a mesh is identified by its axis
        names, shape, and device kind, all process-stable, so
        shardmap/tp compiles hit the disk cache and warm replicas skip
        the pipeline."""
        out = []
        for f in dataclasses.fields(self):
            if f.name in self._NON_IDENTITY:
                continue
            tok = _stable_token(getattr(self, f.name))
            if tok is _UNSTABLE:
                return None
            out.append((f.name, tok))
        return tuple(out)

    def replace(self, **changes) -> "CompileOptions":
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_kwargs(cls, **legacy) -> "CompileOptions":
        """Build options from legacy ``Transformer.compile(**kwargs)`` names.

        Unknown keys are ignored (the legacy API ignored them too)."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in legacy.items() if k in known})


def _token(v: Any):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return (type(v).__name__,) + tuple(_token(x) for x in v)
    return ("obj", type(v).__name__, id(v))


_UNSTABLE = object()


def _stable_token(v: Any):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        toks = tuple(_stable_token(x) for x in v)
        if any(t is _UNSTABLE for t in toks):
            return _UNSTABLE
        return (type(v).__name__,) + toks
    tok = _mesh_token(v)
    if tok is not None:
        return tok
    return _UNSTABLE


def _mesh_token(v: Any):
    """A process-stable token for a jax Mesh (duck-typed so options never
    import jax): (axis names, mesh shape, device kinds)."""
    axis_names = getattr(v, "axis_names", None)
    devices = getattr(v, "devices", None)
    if axis_names is None or devices is None or not hasattr(devices, "shape"):
        return None
    try:
        kinds = tuple(sorted({f"{d.platform}:{d.device_kind}"
                              for d in devices.flat}))
        return ("mesh", tuple(str(a) for a in axis_names),
                tuple(int(s) for s in devices.shape), kinds)
    except Exception:
        return None
