"""Kernel autotuner: sweep attention/fusion knobs, remember.

TVM-style "record the schedule choice" scaled to this repo's knob space:
``Backend.compile(fn, CompileOptions(autotune=True))`` calls
:func:`resolve`, which returns *concrete* options — from a persisted
tuning record when one exists for this (backend, device name,
shape-signature, versions), else by compiling and timing a small
candidate grid and persisting the winner into the disk cache
(``<cache_dir>/autotune/``).  The second process to compile the same
graph performs zero sweep timings.

The grid is *family-gated* so sweeps stay small: attention knobs
(``attn_impl``/``attn_chunk``) are swept only when the graph executes an
Attention node, and per-compound fusion on/off flips
(``fuse_swiglu``/``fuse_norm_matmul``/``fuse_rotary_qkv``) only when the
resolved level is O2 — the only level where :class:`FuseCompounds`
runs, so flipping them anywhere else would time identical executables.

Two of the reference's knobs are the request's here, never swept:
``use_pallas`` (the port never gives way to the plain versions on the
card, so a sweep may not choose them) and the matmul tile shapes
``mm_bm``/``mm_bn``/``mm_bk`` (the Hopper kernels choose their own
tiles, ``kernels.ops.matmul_plan``).  They are part of the record key,
and every candidate and record carries them at the request's values, so
the record schema is the reference's.

Each candidate is called :data:`SWEEP_WARMUP` times before it is timed:
on the card the first call runs eagerly and the second captures the
CUDA graph that later calls replay, so candidate 0 is not charged with
its capture.  After a sweep only the winner's compiled function stays
in the backend's in-memory cache (the losers' go, with their CUDA graphs
and the outputs each graph holds), as only the winner's disk entry stays
on disk.

A sweep always times the statically-resolved default as candidate 0, so
the recorded winner is by construction no slower than the default on the
machine that tuned it.  A candidate is skipped only when its options
refuse the graph's shapes (:data:`REFUSALS`); any other failure, a
kernel that does not build or launch, fails the compile.  Records are
keyed on the port's identity like compile entries: a toolchain or kernel
change re-tunes instead of trusting stale timings.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, FrozenSet, List, Optional

import numpy as np

from ..core.function import Function
from ..kernels.xla_attention import ChunkError
from . import diskcache
from .options import CompileOptions, OptionsError, _stable_token, _UNSTABLE

SCHEMA = "repro-autotune-v2"
SWEEP_WARMUP = 2        # untimed calls per candidate: eager, then capture
SWEEP_REPS = 3          # timed calls per candidate (after the warm-up)
CHUNK_CANDIDATES = (256, 1024)
# the failures that mean "these options refuse these shapes": the only
# ones a sweep skips a candidate for
REFUSALS = (OptionsError, ChunkError)

# the knobs the tuner owns; everything else is identity (part of the key)
TUNED_FIELDS = ("attn_impl", "attn_chunk",
                "fuse_swiglu", "fuse_norm_matmul", "fuse_rotary_qkv")
# every candidate and winner records these: the reference's tuned knobs,
# of which use_pallas and the tiles are held at the request's values
RECORD_FIELDS = TUNED_FIELDS + ("use_pallas", "mm_bm", "mm_bn", "mm_bk")

# record schema, the reference's
RECORD_REQUIRED_KEYS = ("format", "schema", "backend", "signature",
                        "candidates", "winner", "versions")
CANDIDATE_REQUIRED_KEYS = RECORD_FIELDS + ("ms",)


@dataclasses.dataclass
class SweepResult:
    key: Optional[str]            # record key (None: options not stable)
    candidates: List[Dict]        # [{<RECORD_FIELDS>, ms}]
    winner: Dict                  # the fastest candidate's RECORD_FIELDS
    swept: bool                   # False when a record was reused


def tune_key(backend, fn: Function, options: CompileOptions,
             signature: Optional[str] = None) -> Optional[str]:
    """Record key: everything that invalidates a timing, minus the tuned
    knobs themselves (records must be found regardless of the requested
    starting point)."""
    toks = []
    for f in dataclasses.fields(options):
        if f.name in TUNED_FIELDS or f.name in CompileOptions._NON_IDENTITY:
            continue
        t = _stable_token(getattr(options, f.name))
        if t is _UNSTABLE:
            return None
        toks.append((f.name, t))
    opts_tok = _stable_token(tuple(sorted(backend._key_opts().items())))
    if opts_tok is _UNSTABLE:
        return None
    doc = (SCHEMA, backend.name, signature or fn.signature(), tuple(toks),
           opts_tok, tuple(sorted(diskcache._versions().items())),
           options.level or backend.default_level)
    return hashlib.sha256(repr(doc).encode()).hexdigest()


def _collect_ops(fn: Function, acc: set) -> set:
    for n in fn.nodes():
        acc.add(n.op)
        for v in n.attrs.values():
            if isinstance(v, Function):
                _collect_ops(v, acc)
            elif isinstance(v, (tuple, list)):
                for x in v:
                    if isinstance(x, Function):
                        _collect_ops(x, acc)
    return acc


def has_attention(fn: Function) -> bool:
    """True if the graph executes any Attention node — including inside
    nested Functions (Scan bodies carry the per-layer attention)."""
    return "Attention" in _collect_ops(fn, set())


# ops that FuseCompounds can create or leave unfused (fusion flips)
_MM_FAMILY_OPS = frozenset(
    {"DotGeneral", "SwiGLU", "NormMatmul", "RotaryQKV"})


def tunable_families(fn: Function, options: CompileOptions,
                     backend=None) -> FrozenSet[str]:
    """Which knob families a sweep of ``fn`` under ``options`` can
    actually exercise.  Empty = nothing to tune, skip the sweep."""
    ops = _collect_ops(fn, set())
    fams = set()
    if "Attention" in ops:
        fams.add("attention")
    level = options.level or (backend.default_level if backend is not None
                              else "O1")
    if ops & _MM_FAMILY_OPS and level == "O2":
        fams.add("fusion")
    return frozenset(fams)


def candidate_grid(options: CompileOptions,
                   families: FrozenSet[str] = frozenset({"attention"})
                   ) -> List[Dict]:
    """The sweep grid.  Candidate 0 is always the request as-given (the
    static default), so the winner can never regress it.  Each family
    varies its own knobs against the request — no cross products, so the
    grid stays linear in the number of families."""
    seen = set()
    grid: List[Dict] = []
    base = {k: getattr(options, k) for k in RECORD_FIELDS}

    def add(**over):
        cand = dict(base)
        cand.update(over)
        key = tuple(cand[k] for k in RECORD_FIELDS)
        if key not in seen:
            seen.add(key)
            grid.append(cand)

    add()  # candidate 0: the request as-given
    if "attention" in families:
        add(attn_impl="naive")
        for c in sorted({options.attn_chunk, *CHUNK_CANDIDATES}):
            add(attn_impl="chunked", attn_chunk=c)
    if "fusion" in families:
        # flip each compound off one at a time, plus the all-unfused
        # baseline the E14 microbenchmarks compare against
        add(fuse_swiglu=not options.fuse_swiglu)
        add(fuse_norm_matmul=not options.fuse_norm_matmul)
        add(fuse_rotary_qkv=not options.fuse_rotary_qkv)
        add(fuse_swiglu=False, fuse_norm_matmul=False,
            fuse_rotary_qkv=False)
    return grid


def resolve(backend, fn: Function,
            options: CompileOptions) -> CompileOptions:
    """Concrete options for ``fn``: record lookup, else sweep + persist.

    Called by ``Backend.compile`` when ``options.autotune`` is set; the
    returned options always have ``autotune=False`` (they are the
    resolution, not another request)."""
    static = options.replace(autotune=False)
    families = tunable_families(fn, options, backend)
    if not families:
        return static  # nothing to tune
    sig = fn.signature()
    key = tune_key(backend, fn, options, signature=sig)
    # Options carrying opaque objects (mesh/shardings) have key=None and
    # can never persist — but a repeated compile in one process must still
    # not re-pay the sweep, so everything memoizes in-process too.
    mem_key = key if key is not None else (
        "mem", sig, static.cache_key(),
        options.level or backend.default_level)
    rec = _load_record(backend, options, key, mem_key)
    if rec is not None:
        try:
            resolved = static.replace(**_tuned(rec["winner"]))
        except Exception:
            # a schema-valid record can still carry garbage winner
            # values (torn write racing store_tuning, hand edits);
            # evict it and re-sweep instead of failing the compile
            _evict_record(backend, options, key, mem_key)
        else:
            backend.autotune_hits += 1
            return resolved
    result = sweep(backend, fn, static, key=key, families=families)
    backend.autotune_sweeps += 1
    _store_record(backend, fn, options, result, mem_key)
    _drop_loser_entries(backend, fn, static, result, signature=sig)
    return static.replace(**_tuned(result.winner))


def sweep(backend, fn: Function, static: CompileOptions,
          key: Optional[str] = None, reps: int = SWEEP_REPS,
          families: Optional[FrozenSet[str]] = None) -> SweepResult:
    """Compile + time every candidate; fastest mean wall time wins.

    Each candidate runs :data:`SWEEP_WARMUP` untimed calls (the eager
    first call, then the capture on the card) before ``reps`` timed ones.
    A candidate whose options refuse the shapes (:data:`REFUSALS`, e.g. a
    chunk size the KV length does not divide) is skipped; candidate 0 (the
    static default) must run, so the sweep cannot come back empty.  Any
    other failure is raised: a sweep never hides a kernel that fails.
    On a card the zero arguments are made there once: as numpy they
    would cross the bus on every timed call, weights and all."""
    if families is None:
        families = tunable_families(fn, static, backend) or \
            frozenset({"attention"})
    args = _zero_args(fn, getattr(backend, "device", None))
    timed: List[Dict] = []
    for cand in candidate_grid(static, families):
        try:
            cf = backend.compile(fn, static.replace(**cand))
            for _ in range(SWEEP_WARMUP):
                cf(*args)  # eager first call, then the capture
            t0 = time.perf_counter()
            for _ in range(reps):
                cf(*args)  # numpy convention: host round-trip syncs
            ms = (time.perf_counter() - t0) / reps * 1e3
            del cf
        except REFUSALS:
            if not timed:
                raise  # the static default must be runnable
            continue
        timed.append({**cand, "ms": ms})
    winner = min(timed, key=lambda c: c["ms"])
    return SweepResult(key=key, candidates=timed, winner=_knobs(winner),
                       swept=True)


def _zero_args(fn: Function, device) -> list:
    """A sweep's zero inputs: tensors on a CUDA device, else numpy."""
    if device is None or device.type != "cuda":
        return [np.zeros(t.shape, t.dtype) for t in fn.in_types]
    import torch

    from ..devices import torch_dtype
    return [torch.zeros(t.shape, dtype=torch_dtype(t.dtype), device=device)
            for t in fn.in_types]


def _knobs(doc: Dict) -> Dict:
    return {k: doc[k] for k in RECORD_FIELDS}


def _tuned(doc: Dict) -> Dict:
    return {k: doc[k] for k in TUNED_FIELDS}


def record_doc(backend, fn: Function, result: SweepResult) -> Dict:
    return {
        "format": diskcache.ENTRY_FORMAT,
        "schema": SCHEMA,
        "backend": backend.name,
        "signature": fn.signature(),
        "key": result.key,
        "candidates": result.candidates,
        "winner": result.winner,
        "versions": diskcache._versions(),
    }


def validate_record(rec: Dict) -> List[str]:
    """Schema errors for one tuning record ([] = valid)."""
    errors = []
    if not isinstance(rec, dict):
        return [f"record must be an object, got {type(rec).__name__}"]
    for k in RECORD_REQUIRED_KEYS:
        if k not in rec:
            errors.append(f"missing key {k!r}")
    if rec.get("schema", SCHEMA) != SCHEMA:
        errors.append(f"schema {rec['schema']!r} is not {SCHEMA!r}")
    cands = rec.get("candidates")
    if cands is not None:
        if not isinstance(cands, list) or not cands:
            errors.append("candidates must be a non-empty list")
        else:
            for i, c in enumerate(cands):
                if not isinstance(c, dict):
                    errors.append(f"candidates[{i}] must be an object")
                    continue
                for k in CANDIDATE_REQUIRED_KEYS:
                    if k not in c:
                        errors.append(f"candidates[{i}] missing {k!r}")
                ms = c.get("ms")
                if ms is not None and (
                        not isinstance(ms, (int, float)) or ms < 0):
                    errors.append(f"candidates[{i}].ms not a time: {ms!r}")
    win = rec.get("winner")
    if win is not None:
        if not isinstance(win, dict):
            errors.append("winner must be an object")
        else:
            for k in RECORD_FIELDS:
                if k not in win:
                    errors.append(f"winner missing {k!r}")
    return errors


def _drop_loser_entries(backend, fn: Function, static: CompileOptions,
                        result: SweepResult, signature: str) -> None:
    """Remove the losing candidates' compiled functions after a sweep:
    their entries in the backend's in-memory cache (each holds its
    emitted program and, on the card, its CUDA graphs with their static
    outputs) and their disk entries.

    Sweep compiles go through the normal ``Backend.compile`` path, so
    every candidate was cached in memory and persisted a full entry —
    but only the winner's is ever addressed again; the rest would hold
    device memory and squat on LRU budget until evicted."""
    disk = backend._disk_for(static)
    level = static.level or backend.default_level
    params = tuple(p.name for p in fn.parameters)
    for cand in result.candidates:
        knobs = _knobs(cand)
        if knobs == result.winner:
            continue
        opts = static.replace(**knobs)
        with backend._lock:
            backend._cache.pop((signature, params, level, opts.cache_key()),
                               None)
        if disk is None:
            continue
        dkey = diskcache.entry_key(signature, params, level, opts,
                                   backend.name, backend._key_opts())
        if dkey is not None:
            disk._remove(disk._entry_path(dkey))


# -- persistence --------------------------------------------------------------
def _load_record(backend, options: CompileOptions, key: Optional[str],
                 mem_key) -> Optional[Dict]:
    rec = backend._autotune_mem.get(mem_key)
    if rec is not None:
        return rec
    if key is None:
        return None
    disk = backend._disk_for(options)
    if disk is not None:
        rec = disk.load_tuning(key)
        if rec is not None:
            if not validate_record(rec):
                return rec
            # parses as JSON but fails the schema (partial write that
            # still decodes, wrong-version hand edit): evict so it
            # stops shadowing the re-sweep forever
            disk.remove_tuning(key)
    return None


def _evict_record(backend, options: CompileOptions, key: Optional[str],
                  mem_key) -> None:
    """Drop a record that failed to resolve, everywhere it is cached."""
    backend._autotune_mem.pop(mem_key, None)
    if key is not None:
        disk = backend._disk_for(options)
        if disk is not None:
            disk.remove_tuning(key)


def _store_record(backend, fn: Function, options: CompileOptions,
                  result: SweepResult, mem_key) -> None:
    rec = record_doc(backend, fn, result)
    backend._autotune_mem[mem_key] = rec
    if result.key is not None:
        disk = backend._disk_for(options)
        if disk is not None:
            disk.store_tuning(result.key, rec)
