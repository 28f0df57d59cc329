"""ServeEngine on torch: the serving hot loop on one device.

The port of ``repro/launch/engine.py``: four modes, worst to best.

  * ``lockstep``   -- the legacy hot loop: numpy in and out every step
                      (through ``CompiledFunction.__call__``), every
                      request starts together (the baseline).  The one
                      mode that serves every family ``build_graphs``
                      builds (moe, mla_moe, rg_hybrid, xlstm, encdec
                      and vlm too), as in the reference.
  * ``donated``    -- the same lockstep schedule, but the caches stay on
                      the device and the whole greedy loop (argmax and
                      token feedback included) runs inside one fused
                      multi-step graph (``build_dense_chunk``): one
                      dispatch generates the continuation, token for token
                      identical to ``lockstep``.
  * ``continuous`` -- continuous batching on the ``serve`` graph (per-row
                      positions, in-graph greedy sampling) over a
                      :class:`KVCachePool` of fixed per-slot cache rows:
                      finished requests free their slot and queued prompts
                      are admitted mid-flight by prefilling into it.
  * ``paged``      -- continuous batching on the paged chunk graph
                      (``build_dense_chunk(page_size=...)``): KV lives in a
                      :class:`PagedKVPool` of pages allocated lazily as a
                      request's position crosses a page boundary, the
                      scheduler decodes ``chunk_steps`` tokens per dispatch,
                      prompts prefill in-graph in chunks
                      (``build_dense_paged_prefill``) or densely
                      (``prefill_chunk=0``), and prefix pages are shared
                      across requests by content hash with copy-on-write.
                      Sampling (temperature / top-k / key) is in-graph per
                      row; greedy (temperature 0, the default) is the
                      parity baseline against the reference.

The host logic -- scheduler, slot and page accounting, prefix sharing,
cancel, deadlines, fault containment, ``verify()`` -- is the reference's.
What changed is the device side: the pool buffers are torch tensors on
the backend's device, every graph but lockstep's runs through
``CompiledFunction.raw`` on device tensors, and only token ids (and a
prefill's last-row logits) cross to the host.

Ownership: the engine is the only owner of the pool buffers.  After each
dispatch the pool is repointed at the outputs (``update``) and the
inputs are dropped, so the allocator reuses their memory (the torch
spelling of the reference's donation).  Because nothing else holds them,
the host-side cache writes (prefill scatter, copy-on-write) update the
buffers in place.

The multimodal families' prefill reads stubbed frames or images (as the
reference's does) and weights the decode graph does not declare: the
encoder's, the vision projection's.

``EngineConfig(mode="paged", tp=N)`` compiles the paged chunk and
prefill graphs partitioned (``CompileOptions(mode="shardmap",
partition="tp", mesh_shape=(N,))``): each shard holds ``n_kv_heads/N``
heads of every KV page, the page tables stay replicated on the host,
and greedy decode is token-identical to ``tp=1``.  The pool stays one
global tensor per cache on the engine's device; the shard executor
(:mod:`repro_torch.backend.sharded`) splits it per dispatch and writes
the joined outputs back.  ``device="cpu"`` runs the N shards on the CPU;
on the card a mesh needs N cards unless ``options.mesh`` names the
devices (``make_mesh((2,), ("model",), devices=["cuda:0"] * 2)`` puts
both shards on one).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import (Any, Dict, Iterator, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..backend import Backend, CompileOptions
from ..configs.base import ModelConfig, ShapeConfig
from ..devices import as_tensor, to_numpy, torch_dtype
from ..models.lm import ModelGraphs, build_graphs
from .faults import FaultInjector, get_injector

MODES = ("lockstep", "donated", "continuous", "paged")
# request terminal statuses — every request ends in exactly one; each is
# counted in ServeEngine.counters and carried in EngineReport.statuses
TERMINAL_STATUSES = ("completed", "cancelled", "deadline_exceeded", "failed")
# engine health: "ok" -> "degraded" after a contained dispatch failure
# (pool verified/rebuilt, still serving) -> "halted" when containment
# itself failed (submit/step refuse; restart the engine)
HEALTH_STATES = ("ok", "degraded", "halted")
# engine-managed step inputs — everything else on a serve/decode graph is
# a cache/state tensor.  Scoped per graph kind: only the paged graphs
# declare the page table + sampling knobs, so generic names like "key"
# stay available as cache/state names everywhere else.
_STEP_INPUTS = ("token", "pos")
_PAGED_STEP_INPUTS = _STEP_INPUTS + ("page_tbl", "temperature", "top_k",
                                     "key")




@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Validated, immutable construction config for :class:`ServeEngine`.

    ``ServeEngine(cfg, EngineConfig(mode="paged", device="cuda"))``; the
    legacy keyword spelling routes through this class too, so every
    construction path gets the same validation.  Checks that need only
    the config run here in ``__post_init__``; model-dependent checks stay
    in the engine, which holds the ModelConfig.

    ``device`` pins every graph and the KV pool to one device (None =
    the card, ``"cpu"`` = the CPU).  With ``tp > 1`` a bare device type
    (``"cpu"``, ``"cuda"``) names the type the mesh is built over, not a
    pin; an indexed pin (``"cuda:0"``) is refused unless the compile
    options carry an explicit mesh (:meth:`compile_options`).
    ``params`` optionally supplies the weights (name -> numpy array or tensor, e.g. from
    :mod:`repro_torch.models.weights`) instead of the builder's seeded
    numpy init.
    """

    mode: str = "paged"
    slots: int = 4
    max_len: int = 64
    seed: int = 0
    backend: str = "torch"
    # paged-mode knobs (None = paged default; setting any of them in a
    # non-paged mode is an error, never a silent ignore)
    page_size: Optional[int] = None
    chunk_steps: Optional[int] = None
    pages: Optional[int] = None
    prefix_sharing: Optional[bool] = None
    prefill_chunk: Optional[int] = None
    device: Optional[object] = None
    tp: int = 1
    # compile-cache / autotune conveniences folded into every graph's
    # CompileOptions (same effect as passing options=CompileOptions(...))
    cache_dir: Optional[str] = None
    cache_budget_bytes: Optional[int] = None
    autotune: bool = False
    params: Optional[Mapping[str, Any]] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"mode must be one of {MODES}, got {self.mode!r}")
        if int(self.slots) < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if int(self.max_len) < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.mode == "paged":
            if self.page_size is not None and int(self.page_size) < 1:
                raise ValueError(
                    f"page_size must be >= 1, got {self.page_size}")
            if self.chunk_steps is not None and int(self.chunk_steps) < 1:
                raise ValueError(
                    f"chunk_steps must be >= 1, got {self.chunk_steps}")
            if self.prefill_chunk is not None and \
                    int(self.prefill_chunk) < 0:
                raise ValueError(
                    f"prefill_chunk must be >= 0 (0 = dense prefill), "
                    f"got {self.prefill_chunk}")
        else:
            ignored = {k: v for k, v in [
                ("page_size", self.page_size),
                ("chunk_steps", self.chunk_steps),
                ("pages", self.pages),
                ("prefix_sharing", self.prefix_sharing),
                ("prefill_chunk", self.prefill_chunk)] if v is not None}
            if ignored:
                raise ValueError(
                    f"{sorted(ignored)} need mode='paged'; mode "
                    f"{self.mode!r} uses fixed per-slot cache rows")
        if int(self.tp) < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if int(self.tp) > 1:
            if self.mode != "paged":
                raise ValueError(
                    f"tp={self.tp} shards the paged KV pool; it needs "
                    f"mode='paged', got {self.mode!r}")
            if self.backend != "torch":
                raise ValueError(
                    f"tp={self.tp} lowers via shard_map and needs the "
                    f"torch backend, got {self.backend!r}")
        if self.cache_budget_bytes is not None \
                and int(self.cache_budget_bytes) < 1:
            raise ValueError(
                f"cache_budget_bytes must be >= 1, "
                f"got {self.cache_budget_bytes}")

    def compile_options(self, base: Optional[CompileOptions] = None
                        ) -> CompileOptions:
        """The engine-level CompileOptions these knobs imply, layered on
        ``base`` (an explicit ``options=`` object; the config's cache /
        autotune fields override only when actually set)."""
        opts = base if base is not None else CompileOptions()
        if int(self.tp) > 1 and self.device is not None \
                and str(self.device).lower() not in ("cpu", "cuda") \
                and opts.mesh is None:
            raise ValueError(
                "tp shards over a device mesh and is incompatible "
                "with a single-device pin (device=...)")
        kw = {}
        if self.cache_dir is not None:
            kw["cache_dir"] = self.cache_dir
        if self.cache_budget_bytes is not None:
            kw["cache_budget_bytes"] = int(self.cache_budget_bytes)
        if self.autotune:
            kw["autotune"] = True
        return opts.replace(**kw) if kw else opts


@dataclasses.dataclass
class Request:
    """One generation request tracked by the engine."""

    rid: int
    prompt: np.ndarray          # (P,) i32
    max_new: int                # tokens to generate (incl. the prefill one)
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None  # pool slot while active
    pos: int = 0                # next cache write position
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first: Optional[float] = None   # first token emitted (TTFT anchor)
    t_done: Optional[float] = None
    # sampling (paged mode): temperature 0 = greedy, top_k 0 = full vocab
    temperature: float = 0.0
    top_k: int = 0
    key: int = 0
    # lifecycle: queued/active, then one of TERMINAL_STATUSES
    status: str = "queued"
    error: Optional[str] = None          # structured reason for a
                                         # cancelled/deadline/failed end
    deadline: Optional[float] = None     # absolute perf_counter deadline
    cancel_reason: Optional[str] = None  # set by cancel(); honoured at
                                         # the next step/chunk boundary
    # chunked prefill: next prompt position to prefill while the
    # request is admitted but its prompt is not fully cached yet; None
    # once prefill completes (or on the dense-prefill path throughout)
    prefill_pos: Optional[int] = None

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new

    @property
    def finished(self) -> bool:
        return self.status in TERMINAL_STATUSES


def _percentile(samples: Sequence[float], q: float) -> float:
    """``np.percentile`` that treats an empty sample list as 0.0 (a report
    with no latency samples — e.g. every request finished at prefill —
    must still serialize, and 0 reads as "no data" in every consumer)."""
    if not len(samples):
        return 0.0
    return float(np.percentile(np.asarray(samples, np.float64), q))


def _host_uniform(key: int, pos: int) -> float:
    """np.float32 mirror of ``components.prng_uniform_rows`` — the
    engine samples a request's *first* (prefill) token on the host with
    the same (key, pos) hash the graph uses for decode steps, so a
    request's token stream is a pure function of its key regardless of
    batching."""
    x = np.float32(key) * np.float32(12.9898) \
        + np.float32(pos) * np.float32(78.233) + np.float32(0.5)
    s = np.float32(np.sin(x)) * np.float32(43758.5453)
    u = np.float32(s - np.floor(s))
    return float(min(max(u, np.float32(1e-7)), np.float32(1.0 - 1e-7)))


def _host_sample(logits: np.ndarray, temperature: float, top_k: int,
                 key: int, pos: int) -> int:
    """Host mirror of ``components.sample_tokens`` for one row."""
    lg = np.asarray(logits, np.float32).reshape(-1)
    if temperature <= 0.0:
        return int(np.argmax(lg))
    V = lg.size
    if 0 < top_k < V:
        kth = np.sort(lg)[V - top_k]
        lg = np.where(lg >= kth, lg, np.float32(-1e30))
    sc = lg / np.float32(max(temperature, 1e-6))
    sc = sc - sc.max()
    p = np.exp(sc)
    p /= p.sum()
    below = int((np.cumsum(p) < _host_uniform(key, pos)).sum())
    return min(below, V - 1)


@dataclasses.dataclass
class PoolStats:
    slots: int
    active: int
    bytes_per_slot: int
    total_bytes: int
    occupancy: float
    allocs: int
    frees: int
    peak_active: int
    decode_arena_bytes: int  # compiled step's planned intermediate arena


def _zeros(t, device: torch.device) -> torch.Tensor:
    """A zero device tensor of IR type ``t``."""
    return torch.zeros(tuple(t.shape), dtype=torch_dtype(t.dtype),
                       device=device)


def _check_donation(cf, cache_ix: Sequence[int],
                    recycle: Sequence[Optional[int]],
                    donated: Sequence[int]) -> None:
    """The backend writes each donated input back from the output it
    pairs it with (in order, by shape and dtype, as XLA pairs them);
    each donated cache must pair with the output the engine recycles
    into it (output ``1 + j`` for ``recycle[k] == j``), or a captured
    graph would write one cache's update into another."""
    want = {ix: 1 + j for ix, j in zip(cache_ix, recycle)
            if j is not None and ix in donated}
    got = {ix: cf.raw.donation.get(ix) for ix in want}
    if got != want:
        raise RuntimeError(
            f"{cf.function.name}: donated inputs pair with outputs {got}, "
            f"the engine recycles them from {want}")


class KVCachePool:
    """Slot-addressed, device-resident KV cache pool.

    One device tensor per decode cache input, shaped from the compiled
    serve graph's input types; the slot dimension is the input spec's
    ``batch`` axis.  Buffers are allocated once and *reused* across
    requests: admission overwrites a freed slot's prefix rows in place
    instead of re-zeroing the pool (the engine is the buffers' sole
    owner), and the engine repoints the pool at each step's outputs via
    :meth:`update`.
    """

    def __init__(self, names: Sequence[str], types: Sequence,
                 specs: Sequence[Tuple], arena_bytes: int = 0, device=None):
        self.names = list(names)
        self.types = list(types)
        self.device = torch.device(device if device is not None else "cpu")
        self.batch_dims = []
        self.seq_dims = []
        for sp in specs:
            sp = tuple(sp)
            self.batch_dims.append(sp.index("batch") if "batch" in sp else 1)
            self.seq_dims.append(sp.index("kv_seq") if "kv_seq" in sp
                                 else None)
        self.buffers = [_zeros(t, self.device) for t in self.types]
        self.slots = self.types[0].shape[self.batch_dims[0]]
        self._free = list(range(self.slots - 1, -1, -1))
        self.allocs = 0
        self.frees = 0
        self.peak_active = 0
        self.total_bytes = sum(t.nbytes for t in self.types)
        self.bytes_per_slot = self.total_bytes // max(self.slots, 1)
        self.decode_arena_bytes = int(arena_bytes)

    @property
    def active(self) -> int:
        return self.slots - len(self._free)

    @property
    def has_free(self) -> bool:
        return bool(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("KV pool exhausted")
        slot = self._free.pop()
        self.allocs += 1
        self.peak_active = max(self.peak_active, self.active)
        return slot

    def free(self, slot: int) -> None:
        # invalid frees must raise, never silently return -- a slot leak
        # that only shows up as occupancy drift is the worst kind
        if not 0 <= slot < self.slots:
            raise ValueError(
                f"free of out-of-range slot {slot} (pool has "
                f"{self.slots} slots)")
        if slot in self._free:
            raise ValueError(f"double free of slot {slot}")
        self._free.append(slot)
        self.frees += 1

    def write_prefix(self, slot: int, name: str, prefix) -> None:
        """Write a (batch=1) prefill cache into ``slot``'s prefix rows,
        in place (the engine is the buffers' sole owner)."""
        i = self.names.index(name)
        buf = self.buffers[i]
        bd, sd = self.batch_dims[i], self.seq_dims[i]
        upd = as_tensor(prefix, self.device).select(bd, 0)
        idx: List[Any] = [slice(None)] * buf.ndim
        idx[bd] = slot
        if sd is not None:
            # the update's seq axis shifted down one because bd was dropped
            idx[sd] = slice(0, upd.shape[sd - 1 if sd > bd else sd])
        buf[tuple(idx)] = upd.to(buf.dtype)

    def update(self, new_buffers: Sequence) -> None:
        """Repoint the pool at a step's outputs (the inputs are dropped;
        the engine held the only reference)."""
        assert len(new_buffers) == len(self.buffers)
        self.buffers = list(new_buffers)

    def verify(self) -> List[str]:
        """Accounting invariants; [] = consistent.  Run by the engine's
        step-failure containment before deciding whether the pool can be
        kept or must be rebuilt."""
        problems = []
        if len(set(self._free)) != len(self._free):
            problems.append(f"duplicate slots on the free list: "
                            f"{sorted(self._free)}")
        if not all(0 <= s < self.slots for s in self._free):
            problems.append(f"out-of-range slots on the free list: "
                            f"{sorted(self._free)}")
        if self.allocs - self.frees != self.active:
            problems.append(f"allocs({self.allocs}) - frees({self.frees}) "
                            f"!= active({self.active})")
        return problems

    def reset_buffers(self) -> None:
        """Fresh zero buffers: after a dispatch raises mid-flight the old
        ones can never be trusted again, so containment always re-arms
        here."""
        self.buffers = [_zeros(t, self.device) for t in self.types]

    def rebuild(self) -> None:
        """Reset to the empty state, reconciling the counters (frees
        catch up to allocs: every outstanding slot is forcibly returned).
        The containment path's last resort when :meth:`verify` reports
        damage."""
        self._free = list(range(self.slots - 1, -1, -1))
        self.frees = self.allocs
        self.reset_buffers()

    def stats(self) -> PoolStats:
        return PoolStats(
            slots=self.slots, active=self.active,
            bytes_per_slot=self.bytes_per_slot, total_bytes=self.total_bytes,
            occupancy=self.active / max(self.slots, 1),
            allocs=self.allocs, frees=self.frees,
            peak_active=self.peak_active,
            decode_arena_bytes=self.decode_arena_bytes)


@dataclasses.dataclass
class PagedPoolStats:
    slots: int
    active: int
    pages: int               # usable pages (the reserved trash page excluded)
    page_size: int           # token rows per page
    pages_in_use: int
    peak_pages_in_use: int
    bytes_per_page: int      # summed across all cache tensors
    total_bytes: int
    fragmentation: float     # allocated-but-unused token-row fraction,
                             # averaged over decode dispatches (else the
                             # instantaneous value at stats() time)
    allocs: int              # slot (request) allocs
    frees: int
    page_allocs: int
    page_frees: int
    peak_active: int
    decode_arena_bytes: int  # compiled chunk's planned intermediate arena
    # prefix sharing: the *logical* reference ledger.  page_allocs/
    # page_frees above stay strictly physical (a COW copy is one alloc,
    # a page is freed once when its last reference drops) so every
    # pre-existing leak gate holds; the ref ledger counts page-table
    # references — attach/detach of shared pages included.
    ref_allocs: int = 0
    ref_frees: int = 0
    cow_copies: int = 0       # pages copied on first divergent write
    shared_attaches: int = 0  # prefix pages attached to a second+ slot


class PagedKVPool:
    """Page-granular, device-resident KV cache pool.

    Instead of one fixed ``max_len`` row per slot, KV lives in a shared
    pool of ``n_pages`` physical pages of ``page_size`` token rows each
    (one device tensor per cache tensor, shaped ``(L, n_pages, Hkv,
    page_size, D)``), routed through a per-slot page table ``(slots,
    max_pages)``.  Pages are allocated *lazily* — a slot grows a page
    only when its position crosses a page boundary — and return to the
    free list when the request completes, so KV bytes track the tokens
    actually cached, not the worst case.

    Physical page 0 is reserved as the *trash page*: unallocated
    page-table entries (and retired rows that keep stepping until the
    chunk boundary) point at it, so their in-graph writes land somewhere
    harmless instead of corrupting a reused page.  It is never handed
    out and is excluded from ``pages_in_use``.

    Admission is deadlock-free by conservative reservation:
    :meth:`alloc` reserves the request's whole-lifetime page count (its
    prompt + generation length is known at submit), so the lazy
    :meth:`ensure_pages` growth of an admitted request can never fail.
    :meth:`update` repoints the pool at every dispatch's outputs.
    """

    def __init__(self, names: Sequence[str], types: Sequence, *,
                 slots: int, page_size: int, max_pages: int,
                 arena_bytes: int = 0, device=None):
        self.names = list(names)
        self.types = list(types)
        self.device = torch.device(device if device is not None else "cpu")
        self.buffers = [_zeros(t, self.device) for t in self.types]
        self.n_pages = self.types[0].shape[1]     # (L, P, Hkv, ps, D)
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        self.slots = int(slots)
        self._free_slots = list(range(self.slots - 1, -1, -1))
        self._free_pages = list(range(self.n_pages - 1, 0, -1))  # 0 = trash
        self._slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        self._used_tokens = [0] * self.slots
        self._reserved = [0] * self.slots
        self.page_table = np.zeros((self.slots, self.max_pages), np.int32)
        # prefix sharing: per-page logical refcounts, the
        # content-hash index over *full* prefix pages (page j of a prompt
        # keyed by the digest of prompt[:(j+1)*page_size] — chaining the
        # whole prefix into the key, so a hit certifies every earlier row
        # too), and its reverse map.  Full prefix pages are immutable
        # once prefilled (decode writes land at pos >= P), so the
        # publisher never copies; only a *sharer* re-processing its last
        # prompt token into a fully-shared page triggers COW, and that
        # single page is budgeted via _cow_pending.
        self._page_refs: Dict[int, int] = {}
        self._prefix_index: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self._cow_pending = [0] * self.slots
        self.allocs = 0
        self.frees = 0
        self.page_allocs = 0
        self.page_frees = 0
        self.ref_allocs = 0
        self.ref_frees = 0
        self.cow_copies = 0
        self.shared_attaches = 0
        self.peak_active = 0
        self.peak_pages_in_use = 0
        self._frag_sum = 0.0
        self._frag_samples = 0
        self.total_bytes = sum(t.nbytes for t in self.types)
        self.bytes_per_page = self.total_bytes // max(self.n_pages, 1)
        self.decode_arena_bytes = int(arena_bytes)

    @property
    def active(self) -> int:
        return self.slots - len(self._free_slots)

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free_pages)

    def pages_for(self, tokens: int) -> int:
        need = -(-int(tokens) // self.page_size)
        if need > self.max_pages:
            # fail loudly: an under-sized reservation would let in-graph
            # writes clamp onto the request's last page and corrupt its
            # own cached rows (the engine pre-validates via max_len;
            # direct pool users get the error here)
            raise ValueError(
                f"{tokens} tokens need {need} pages but the page table "
                f"holds at most max_pages={self.max_pages} "
                f"({self.max_pages * self.page_size} tokens)")
        return need

    @property
    def _outstanding(self) -> int:
        """Reserved-but-not-yet-allocated pages across active slots,
        plus each slot's pending copy-on-write page (a sharer whose whole
        prompt matched will copy the last shared page on its first
        write — that physical page must stay spoken for)."""
        return sum(max(0, r - len(p) + c)
                   for r, p, c in zip(self._reserved, self._slot_pages,
                                      self._cow_pending))

    @property
    def committed_pages(self) -> int:
        """Pages unavailable to new admissions: allocated plus
        reservation-held — the pool's true committed footprint (what the
        KV-bytes-per-active-token metric must count, or early-lifetime
        requests would flatter it)."""
        return self.pages_in_use + self._outstanding

    def can_admit(self, total_tokens: int, *, held_slots: int = 0,
                  held_pages: int = 0, shared_pages: int = 0) -> bool:
        """Would a ``total_tokens``-long request be admitted right now?

        ``held_slots``/``held_pages`` discount capacity already spoken
        for by requests that are queued but not yet allocated (the
        engine's internal queue, the server's admission probe) — without
        them a front door would over-admit into capacity the queue ahead
        of it is about to consume.  ``shared_pages`` credits prefix pages
        the request would *attach* instead of allocate (see
        :meth:`probe_shared`) — sharing is an admission-capacity win,
        not just a bytes win."""
        need = max(self.pages_for(total_tokens) - int(shared_pages), 0)
        return len(self._free_slots) - held_slots >= 1 and \
            len(self._free_pages) - self._outstanding - held_pages >= need

    def alloc(self, total_tokens: int, *, shared_pages: int = 0) -> int:
        """Claim a slot and reserve pages for a ``total_tokens``-long
        request (prompt + generation).  ``shared_pages`` must match the
        :meth:`probe_shared` credit the admission decision used; the
        reservation itself stays whole-lifetime (attached pages count
        toward it the moment :meth:`share_prefix` links them)."""
        if not self.can_admit(total_tokens, shared_pages=shared_pages):
            raise RuntimeError(
                f"paged KV pool exhausted: active={self.active}/"
                f"{self.slots} slots, {len(self._free_pages)} free pages "
                f"({self._outstanding} already spoken for), "
                f"{self.pages_for(total_tokens)} needed")
        slot = self._free_slots.pop()
        self._reserved[slot] = self.pages_for(total_tokens)
        self._used_tokens[slot] = 0
        self.allocs += 1
        self.peak_active = max(self.peak_active, self.active)
        return slot

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.slots:
            raise ValueError(
                f"free of out-of-range slot {slot} (pool has "
                f"{self.slots} slots)")
        if slot in self._free_slots:
            raise ValueError(f"double free of slot {slot}")
        for pid in self._slot_pages[slot]:
            self._page_refs[pid] -= 1
            self.ref_frees += 1
            if self._page_refs[pid] == 0:
                # last reference: the physical page returns to the free
                # list (and leaves the prefix index — index entries are
                # only valid while some slot keeps the content alive)
                del self._page_refs[pid]
                key = self._page_key.pop(pid, None)
                if key is not None:
                    del self._prefix_index[key]
                self._free_pages.append(pid)
                self.page_frees += 1
        self._slot_pages[slot] = []
        self._reserved[slot] = 0
        self._used_tokens[slot] = 0
        self._cow_pending[slot] = 0
        self.page_table[slot, :] = 0   # back to the trash page
        self._free_slots.append(slot)
        self.frees += 1

    def ensure_pages(self, slot: int, upto_pos: int) -> None:
        """Lazily grow ``slot`` so it can hold token rows 0..upto_pos."""
        need = self.pages_for(upto_pos + 1)
        pages = self._slot_pages[slot]
        while len(pages) < need:
            if not self._free_pages:
                raise RuntimeError(
                    f"paged KV pool out of pages growing slot {slot} "
                    f"(reservation bug: admission must cover the "
                    f"request's whole lifetime)")
            pid = self._free_pages.pop()
            self.page_table[slot, len(pages)] = pid
            pages.append(pid)
            self._page_refs[pid] = 1
            self.page_allocs += 1
            self.ref_allocs += 1
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)

    # -- copy-on-write prefix sharing ---------------------------------
    def _digest(self, prompt: np.ndarray, upto_page: int) -> bytes:
        """Index key for full prefix page ``upto_page`` of ``prompt``:
        the hash runs over *all* tokens up to and including that page, so
        a match certifies the entire chain of earlier pages as well."""
        n = (upto_page + 1) * self.page_size
        return hashlib.sha256(
            np.ascontiguousarray(prompt[:n], np.int32).tobytes()).digest()

    def probe_shared(self, prompt) -> Tuple[int, int]:
        """Non-mutating admission probe: ``(covered_tokens,
        reusable_pages)`` for a prompt against the current prefix index.
        ``reusable_pages`` is the page credit an admission may take: a
        fully-matched prompt re-processes its last token, so the page
        holding it will be COW-copied and earns no credit."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        matched = 0
        for j in range(len(prompt) // self.page_size):
            if self._digest(prompt, j) not in self._prefix_index:
                break
            matched += 1
        covered = matched * self.page_size
        reusable = matched if covered < len(prompt) else max(matched - 1, 0)
        return covered, reusable

    def share_prefix(self, slot: int, prompt) -> int:
        """Attach index-matching full prefix pages to freshly-allocated
        ``slot`` (page table pointed at the shared physical pages,
        refcounts bumped); returns the number of prompt tokens covered.
        The engine prefills the remainder — always re-processing at
        least the last prompt token, whose write COW-copies the final
        shared page when the whole prompt matched."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pages = self._slot_pages[slot]
        if pages:
            raise RuntimeError(
                f"share_prefix on slot {slot} which already holds "
                f"{len(pages)} pages (must run before any growth)")
        matched: List[int] = []
        for j in range(len(prompt) // self.page_size):
            pid = self._prefix_index.get(self._digest(prompt, j))
            if pid is None:
                break
            matched.append(pid)
        for j, pid in enumerate(matched):
            self._page_refs[pid] += 1
            self.page_table[slot, j] = pid
            pages.append(pid)
            self.ref_allocs += 1
            self.shared_attaches += 1
        covered = len(matched) * self.page_size
        if matched and covered >= len(prompt):
            # whole prompt matched: re-processing the last prompt token
            # will write into the final shared page — keep one physical
            # page spoken for until prepare_writes() performs the copy
            self._cow_pending[slot] = 1
        return covered

    def publish_prefix(self, slot: int, prompt) -> int:
        """Index ``slot``'s full prefix pages once its prompt is fully
        cached (they are never written again: decode rows land at
        positions >= len(prompt)).  Pages whose chain digest is already
        indexed are skipped — first publisher wins.  Returns the number
        of pages newly indexed."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pages = self._slot_pages[slot]
        published = 0
        for j in range(len(prompt) // self.page_size):
            key = self._digest(prompt, j)
            if key in self._prefix_index:
                continue
            pid = pages[j]
            if pid in self._page_key:
                continue  # already indexed under a different chain
            self._prefix_index[key] = pid
            self._page_key[pid] = key
            published += 1
        return published

    def prepare_writes(self, slot: int, lo: int, hi: int) -> int:
        """Make token rows ``lo..hi`` (inclusive) of ``slot`` privately
        writable before an in-graph write lands on them: pages shared
        with another slot (ref > 1) are copied onto a fresh physical
        page first (the copy-on-write), and pages this slot holds alone
        but published to the prefix index are de-indexed (their content
        is about to diverge from the indexed digest).  Returns the
        number of pages copied."""
        pages = self._slot_pages[slot]
        ps = self.page_size
        copied = 0
        for j in range(lo // ps, min(hi // ps, len(pages) - 1) + 1):
            pid = pages[j]
            if self._page_refs.get(pid, 0) > 1:
                if not self._free_pages:
                    raise RuntimeError(
                        f"paged KV pool out of pages copying shared page "
                        f"{pid} for slot {slot} (reservation bug: the "
                        f"pending COW page must be spoken for at "
                        f"admission)")
                new = self._free_pages.pop()
                for buf in self.buffers:   # sole owner: copy in place
                    buf[:, new] = buf[:, pid]
                self._page_refs[pid] -= 1
                self._page_refs[new] = 1
                pages[j] = new
                self.page_table[slot, j] = new
                self.page_allocs += 1
                self.cow_copies += 1
                copied += 1
                # the only shared page a slot ever writes is its pending
                # tail page — the copy discharges the reservation
                self._cow_pending[slot] = 0
                self.peak_pages_in_use = max(self.peak_pages_in_use,
                                             self.pages_in_use)
            elif pid in self._page_key:
                # sole holder of an indexed page: privatize in place
                del self._prefix_index[self._page_key.pop(pid)]
                self._cow_pending[slot] = 0
        return copied

    def note_used(self, slot: int, tokens: int) -> None:
        """Record how many token rows ``slot`` actually holds (for the
        fragmentation stat)."""
        self._used_tokens[slot] = int(tokens)

    def sample_fragmentation(self) -> None:
        """Record the allocated-but-unused token-row fraction at a
        dispatch.  Sampled *during* decode (the engine calls this once
        per dispatch) because the instantaneous value after the workload
        drains is vacuously 0 — every page is back on the free list.
        Capacity is *logical* (each slot's attached pages, a shared page
        once per reference) so the fraction stays in [0, 1) under prefix
        sharing; without sharing it equals the physical footprint."""
        cap = sum(len(p) for p in self._slot_pages) * self.page_size
        if cap:
            self._frag_sum += 1.0 - sum(self._used_tokens) / cap
            self._frag_samples += 1

    def write_prefix(self, slot: int, name: str, prefix,
                     start_tok: int = 0) -> None:
        """Scatter a (L, 1, Hkv, Plen, D) prefill cache into ``slot``'s
        pages (``ensure_pages(slot, Plen - 1)`` first).

        One indexed update per cache tensor — the prefix is zero-padded
        to a page multiple and scattered onto all of the slot's pages at
        once, not page by page (each un-jitted ``.at[].set`` copies the
        whole pool buffer, so a per-page loop would cost O(pages_per_
        prompt x pool_bytes) per admission).  The padding rows land
        beyond ``pos`` and stay masked until a later step overwrites
        them.  ``start_tok`` skips the leading rows already attached via
        :meth:`share_prefix` — only pages from ``start_tok // page_size``
        on are written (run :meth:`prepare_writes` over that range
        first), and rows of the first written page below ``start_tok``
        are rewritten with byte-identical values (same prompt, same
        graph), which is harmless."""
        i = self.names.index(name)
        L, _, Hkv, Plen, D = prefix.shape
        ps = self.page_size
        p0 = int(start_tok) // ps
        pids = self._slot_pages[slot][p0:-(-Plen // ps)]
        if not pids:
            return
        x = prefix[:, 0][:, :, p0 * ps:, :]
        rows = Plen - p0 * ps
        pad = len(pids) * ps - rows
        if pad:
            x = torch.cat(
                [x, x.new_zeros((L, Hkv, pad, D))], dim=2)
        x = x.reshape(L, Hkv, len(pids), ps, D).permute(0, 2, 1, 3, 4)
        # the engine is the buffers' sole owner (nothing else references
        # them between dispatches), so the scatter is an in-place copy
        self.buffers[i].index_copy_(
            1, torch.as_tensor(pids, dtype=torch.int64, device=self.device),
            x.to(self.buffers[i].dtype))

    def update(self, new_buffers: Sequence) -> None:
        """Repoint the pool at a dispatch's outputs (the inputs are
        dropped; the engine held the only reference)."""
        assert len(new_buffers) == len(self.buffers)
        self.buffers = list(new_buffers)

    def verify(self) -> List[str]:
        """Accounting invariants; [] = consistent.  The containment path
        runs this after failing the in-flight requests — the exact page
        bookkeeping is what the cancellation contract promises."""
        problems = []
        held: Dict[int, int] = {}
        for p in self._slot_pages:
            for pid in p:
                held[pid] = held.get(pid, 0) + 1
        if len(held) != self.pages_in_use:
            problems.append(f"slot page lists hold {len(held)} distinct "
                            f"pages but pages_in_use says "
                            f"{self.pages_in_use}")
        if self.page_allocs - self.page_frees != self.pages_in_use:
            problems.append(
                f"page_allocs({self.page_allocs}) - "
                f"page_frees({self.page_frees}) != "
                f"pages_in_use({self.pages_in_use})")
        if self.allocs - self.frees != self.active:
            problems.append(f"allocs({self.allocs}) - frees({self.frees}) "
                            f"!= active({self.active})")
        live_refs = sum(held.values())
        if self.ref_allocs - self.ref_frees != live_refs:
            problems.append(
                f"ref_allocs({self.ref_allocs}) - "
                f"ref_frees({self.ref_frees}) != live page "
                f"references({live_refs})")
        if dict(self._page_refs) != held:
            problems.append("per-page refcounts disagree with the slots' "
                            "page-table references")
        if sorted(list(held) + list(self._free_pages)) != \
                list(range(1, self.n_pages)):
            problems.append("free list + slot pages do not partition the "
                            "physical pages (lost or duplicated page)")
        if len(self._page_key) != len(self._prefix_index):
            problems.append("prefix index and its reverse map disagree")
        for key, pid in self._prefix_index.items():
            if self._page_key.get(pid) != key:
                problems.append(f"prefix index entry for page {pid} does "
                                f"not round-trip the reverse map")
            elif pid not in held:
                problems.append(f"prefix index references page {pid} "
                                f"which no slot holds")
        for slot in self._free_slots:
            if 0 <= slot < self.slots and self.page_table[slot].any():
                problems.append(f"free slot {slot} still maps pages in "
                                f"the page table")
        return problems

    def reset_buffers(self) -> None:
        """Fresh zero buffers: a dispatch that raised mid-flight leaves
        the old ones untrustworthy."""
        self.buffers = [_zeros(t, self.device) for t in self.types]

    def rebuild(self) -> None:
        """Reset to the empty state, reconciling counters (frees/
        page_frees catch up so the leak gates still balance) — the
        containment last resort when :meth:`verify` reports damage."""
        self._free_slots = list(range(self.slots - 1, -1, -1))
        self._free_pages = list(range(self.n_pages - 1, 0, -1))
        self._slot_pages = [[] for _ in range(self.slots)]
        self._used_tokens = [0] * self.slots
        self._reserved = [0] * self.slots
        self._page_refs = {}
        self._prefix_index = {}
        self._page_key = {}
        self._cow_pending = [0] * self.slots
        self.page_table = np.zeros((self.slots, self.max_pages), np.int32)
        self.frees = self.allocs
        self.page_frees = self.page_allocs
        self.ref_frees = self.ref_allocs
        self.reset_buffers()

    def stats(self) -> PagedPoolStats:
        used = sum(self._used_tokens)
        cap = self.pages_in_use * self.page_size
        frag = (self._frag_sum / self._frag_samples if self._frag_samples
                else (1.0 - used / cap if cap else 0.0))
        return PagedPoolStats(
            slots=self.slots, active=self.active,
            pages=self.n_pages - 1, page_size=self.page_size,
            pages_in_use=self.pages_in_use,
            peak_pages_in_use=self.peak_pages_in_use,
            bytes_per_page=self.bytes_per_page,
            total_bytes=self.total_bytes,
            fragmentation=frag,
            allocs=self.allocs, frees=self.frees,
            page_allocs=self.page_allocs, page_frees=self.page_frees,
            peak_active=self.peak_active,
            decode_arena_bytes=self.decode_arena_bytes,
            ref_allocs=self.ref_allocs, ref_frees=self.ref_frees,
            cow_copies=self.cow_copies,
            shared_attaches=self.shared_attaches)


@dataclasses.dataclass
class EngineReport:
    mode: str
    results: Dict[int, np.ndarray]  # rid -> generated token ids
    wall_seconds: float
    generated_tokens: int
    tok_s: float          # end-to-end, incl. prefill + first-call compiles
    decode_tok_s: float   # steady-state decode hot loop only
    p50_ms: float
    p95_ms: float
    steps: int
    prefill_seconds: float
    late_admissions: int
    pool: Optional[object]   # PoolStats | PagedPoolStats | None
    # time-to-first-token: submit -> first emitted token, per request —
    # the serving SLO headline (distinct from per-token p50/p95, which
    # sample steady-state decode dispatches)
    ttft_p50_ms: float = 0.0
    ttft_p95_ms: float = 0.0
    # KV bytes the pool had reserved per token actually cached, averaged
    # over decode dispatches — the memory
    # metric the paged pool exists to shrink
    kv_bytes_per_active_token: Optional[float] = None
    # fault tolerance: per-request terminal status + structured
    # error, the engine's health state, and the lifecycle counters —
    # cancellation/deadline/step-failure must each be observable here
    statuses: Dict[int, str] = dataclasses.field(default_factory=dict)
    errors: Dict[int, str] = dataclasses.field(default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    health: str = "ok"
    # tensor parallelism: mesh width and the KV bytes each
    # device actually holds — pool.total_bytes counts the *global* pool,
    # of which every device stores only its n_kv_heads/tp shard
    tp: int = 1
    kv_bytes_per_device: Optional[int] = None



class ServeEngine:
    """Owns compilation, KV memory, and the decode hot loop.

    ``submit()`` queues requests; ``run()`` drives them to completion and
    returns an :class:`EngineReport`; ``stream()`` yields ``(rid, token)``
    pairs as they are produced.
    """

    def __init__(self, cfg: ModelConfig,
                 config: Optional[EngineConfig] = None, *,
                 options: Optional[CompileOptions] = None,
                 faults: Optional[FaultInjector] = None, **legacy_kw):
        """``ServeEngine(cfg, EngineConfig(...))``; the legacy keyword
        spelling (``ServeEngine(cfg, mode="paged", slots=...)``) routes
        through :class:`EngineConfig`.  Every graph the engine compiles
        (the decode step or chunk, the paged prefill chunks, the dense
        prefill) goes through ``options`` -- ``CompileOptions(level="O2",
        use_pallas=True)`` runs the Hopper kernels.  ``config.tp > 1``
        shards the paged chunk + prefill graphs over a ``tp``-shard mesh
        (see the module docstring)."""
        if config is None:
            config = EngineConfig(**legacy_kw)
        elif legacy_kw:
            raise TypeError(
                f"pass either an EngineConfig or legacy keywords, not "
                f"both (got a config plus {sorted(legacy_kw)})")
        if not isinstance(config, EngineConfig):
            raise TypeError(
                f"config must be an EngineConfig, got "
                f"{type(config).__name__}")
        mode = config.mode
        if mode != "lockstep" and cfg.family != "dense":
            raise NotImplementedError(
                f"mode {mode!r} needs the dense-family serve/chunk graphs; "
                f"{cfg.name} ({cfg.family}) serves via mode='lockstep'")
        self.cfg = cfg
        self.config = config
        self.slots = int(config.slots)
        self.max_len = int(config.max_len)
        self.mode = mode
        self.seed = config.seed
        self.tp = int(config.tp)
        # `device` pins every compiled graph and the KV pool to one
        # device (None = the card)
        self.backend = Backend.create(
            config.backend, **({"device": config.device}
                               if config.device is not None else {}))
        self.device = self.backend.device
        self.base_options = config.compile_options(options)
        if self.tp > 1:
            for dim, val in (("n_heads", cfg.n_heads),
                             ("n_kv_heads", cfg.n_kv_heads),
                             ("d_ff", cfg.d_ff)):
                if val % self.tp:
                    raise ValueError(
                        f"tp={self.tp} must divide {dim}={val} "
                        f"({cfg.name})")
            self._check_tp_devices()
            # the chunk + paged-prefill graphs compile partitioned: the
            # PartitionGraph pass cuts them per shard and the backend
            # runs the shards over a (tp,)-"model" mesh.  The dense
            # prefill fallback (prefill_chunk=0) stays on base_options --
            # it computes global caches that the host scatters into the
            # (globally addressed) pool pages.
            self._graph_options = self.base_options.replace(
                mode="shardmap", partition="tp", mesh_shape=(self.tp,))
        else:
            self._graph_options = self.base_options

        if mode == "paged":
            # paged mode always dispatches the fused chunk graph -- one
            # dispatch decodes chunk_steps tokens per row
            self.page_size = int(config.page_size
                                 if config.page_size is not None else 8)
            self.chunk_steps = int(config.chunk_steps
                                   if config.chunk_steps is not None else 4)
            # content-hash prefix sharing across requests (on by default
            # -- greedy parity is preserved by exact-value COW semantics)
            # and in-graph chunked prefill (0 = the dense (1, P) prefill +
            # host scatter).  The default chunk spans four pages per
            # dispatch.
            self.prefix_sharing = (True if config.prefix_sharing is None
                                   else bool(config.prefix_sharing))
            self.prefill_chunk = (4 * self.page_size
                                  if config.prefill_chunk is None
                                  else int(config.prefill_chunk))
            mp = -(-self.max_len // self.page_size)
            # default pool: the worst case (every slot at max_len) plus
            # the trash page -- `pages` shrinks it to create admission
            # pressure
            self.n_pages = int(config.pages) if config.pages is not None \
                else 1 + self.slots * mp
            if self.n_pages < 2:
                raise ValueError(
                    f"pages must be >= 2 (trash page + 1), got "
                    f"{self.n_pages}")
            from ..models.lm import build_dense_chunk
            self.graphs = build_dense_chunk(
                cfg, self.max_len, self.slots, self.chunk_steps,
                page_size=self.page_size, n_pages=self.n_pages)
        else:
            self.prefix_sharing = False
            self.prefill_chunk = 0
            kind = "serve" if mode == "continuous" else "decode"
            self.graphs = build_graphs(
                cfg, ShapeConfig(kind, kind, self.max_len, self.slots),
                self.slots)
        b = self.graphs.builder
        self._step_inputs = (_PAGED_STEP_INPUTS if mode == "paged"
                             else _STEP_INPUTS)
        self.cache_names = [n.name for n in b.inputs
                            if n.name not in self._step_inputs]
        # decode outputs 1..N map to the cache inputs they update, by
        # name (aux["state_out_names"]); inputs absent from the list are
        # step constants carried over unchanged between steps
        out_names = self.graphs.aux.get("state_out_names",
                                        self.cache_names)
        self._recycle = [out_names.index(n) if n in out_names else None
                         for n in self.cache_names]
        cache_ix = [i for i, n in enumerate(b.inputs)
                    if n.name not in self._step_inputs]
        # donate only the inputs an output recycles into, and nothing in
        # lockstep mode, whose caches are the caller's numpy arrays
        donate = tuple(ix for ix, j in zip(cache_ix, self._recycle)
                       if j is not None) if mode != "lockstep" else ()
        self.options = self._graph_options.replace(donate_argnums=donate)
        # donated mode compiles fused multi-step chunk graphs lazily (the
        # step count is a workload property); the decode graph above
        # still provides the cache layout and the parameter registry
        self.cf = (self.backend.compile(self.graphs.fn, self.options)
                   if mode != "donated" else None)
        if self.cf is not None:
            _check_donation(self.cf, cache_ix, self._recycle, donate)
        # weights: the caller's (numpy or tensors), else the builder's
        # seeded numpy init, as device tensors by name.  Every mode keeps
        # them on the device -- lockstep too, where the reference passes
        # numpy weights on every step (27.6 GB a step at deepseek-7b's
        # full width); lockstep's numpy round trip is its token, logits
        # and caches.
        given = config.params
        if given is None:
            given = b.init_params(self.seed)
        # the decode graph's names, then any others given (the encoder's
        # or the vision projection's weights, which only the multimodal
        # families' prefill reads)
        self._param_map: Dict[str, torch.Tensor] = {
            n: as_tensor(given[n], self.device) for n in b.param_names()}
        self._param_map.update((n, as_tensor(v, self.device))
                               for n, v in given.items()
                               if n not in self._param_map)
        self.tparams = [self._param_map[n] for n in b.param_names()]

        self.pool = None  # KVCachePool | PagedKVPool
        if mode in ("continuous", "paged"):
            cache_nodes = [n for n in b.inputs
                           if n.name not in self._step_inputs]
            if mode == "continuous":
                self.pool = KVCachePool(
                    [n.name for n in cache_nodes],
                    [n.out_types[0] for n in cache_nodes],
                    [b.input_specs[n.name] for n in cache_nodes],
                    arena_bytes=self.cf.memory_plan.arena_bytes,
                    device=self.device)
            else:
                self.pool = PagedKVPool(
                    [n.name for n in cache_nodes],
                    [n.out_types[0] for n in cache_nodes],
                    slots=self.slots, page_size=self.page_size,
                    max_pages=self.graphs.aux["max_pages"],
                    arena_bytes=self.cf.memory_plan.arena_bytes,
                    device=self.device)
                self._temp = np.zeros((self.slots,), np.float32)
                self._topk = np.zeros((self.slots,), np.int32)
                self._key = np.zeros((self.slots,), np.int32)
            self._tok = np.zeros((self.slots, 1), np.int32)
            self._pos = np.zeros((self.slots,), np.int32)
            self._slot_req: List[Optional[int]] = [None] * self.slots

        self._requests: Dict[int, Request] = {}
        self._queue: List[int] = []
        self._next_rid = 0
        # fault tolerance: injector (process-global by default,
        # tests pass their own), health state, lifecycle counters, and
        # the terminal-event feed a front door drains after each step
        self.faults = faults if faults is not None else get_injector()
        self.health = "ok"
        self.counters: Dict[str, int] = dict.fromkeys(
            TERMINAL_STATUSES + ("engine_errors",), 0)
        self._events: List[Tuple[int, str, Optional[str]]] = []
        self._steps = 0
        self.step_seconds: List[float] = []   # decode dispatch durations
        self.lat_ms: List[float] = []         # per-token latency samples
        self._decode_tokens = 0
        self.prefill_seconds = 0.0
        self.late_admissions = 0
        # kv-footprint samples: (reserved bytes x tokens cached) summed
        # over decode dispatches — ratio = KV bytes per active token
        self._kv_byte_steps = 0.0
        self._kv_token_steps = 0
        self._t0_work: Optional[float] = None  # first dispatched work
        # steps -> (ModelGraphs, CompiledFunction, ordered device params)
        # of donated mode's fused chunks
        self._chunks: Dict[int, Tuple] = {}
        # (prompt length, batch) -> (ModelGraphs, CompiledFunction,
        # ordered params) of the dense prefill
        self._prefill: Dict[Tuple[int, int], Tuple] = {}
        # chunk-length -> (ModelGraphs, CompiledFunction, ordered device
        # params) for the in-graph paged prefill; one entry per
        # distinct chunk length (full chunks + ragged prompt tails)
        self._pf_chunks: Dict[int, Tuple] = {}

    # -- request intake ------------------------------------------------------
    def check_request(self, prompt_len: int, max_new: int, *,
                      temperature: float = 0.0, top_k: int = 0,
                      key: int = 0,
                      deadline_s: Optional[float] = None) -> None:
        """Validate request parameters without queueing anything; raises
        ``ValueError`` on the first violation.  Factored out of
        :meth:`submit` so a front door can turn a bad request body into
        a 400 before it ever crosses onto the engine thread."""
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if prompt_len < 1:
            raise ValueError("prompt must hold at least one token")
        if prompt_len + max_new > self.max_len:
            raise ValueError(
                f"prompt({prompt_len}) + max_new({max_new}) exceeds "
                f"max_len={self.max_len}")
        if self.mode == "paged":
            # a request that outsizes the whole (possibly user-shrunk)
            # page pool would wait in the queue forever — reject now
            usable = self.pool.n_pages - 1   # page 0 is the trash page
            need = self.pool.pages_for(prompt_len + max_new)
            if need > usable:
                raise ValueError(
                    f"request needs {need} pages ({prompt_len} prompt + "
                    f"{max_new} new tokens at page_size "
                    f"{self.pool.page_size}) but the pool only has "
                    f"{usable} usable pages — it could never be admitted")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0 <= key < 1 << 24:
            # the in-graph PRNG hashes the key through f32, where ints
            # are exact only up to 2^24 — larger keys would silently
            # collide with neighbours instead of drawing distinct streams
            raise ValueError(f"key must be in [0, 2^24), got {key}")
        if self.mode != "paged" and (temperature or top_k or key):
            raise ValueError(
                f"stochastic sampling (temperature/top_k/key) needs "
                f"mode='paged'; mode {self.mode!r} decodes greedily")
        if deadline_s is not None and not deadline_s > 0:
            raise ValueError(
                f"deadline_s must be > 0 seconds, got {deadline_s}")

    @property
    def queue_depth(self) -> int:
        """Requests submitted but not yet admitted to a slot."""
        return len(self._queue)

    def can_admit(self, prompt_len: int, max_new: int,
                  prompt=None) -> bool:
        """Would a new request fit *after* everything already queued?

        Queue-aware: the engine's internal queue holds capacity that the
        scheduler will consume at the next step boundary, so the free
        slots/pages it is about to claim are discounted — this is the
        admission predicate a bounded front-door wait queue maps onto.
        With ``prompt`` given (paged mode, prefix sharing on), prefix
        pages the request would attach instead of allocate are credited:
        a shared-prefix request can be admitted into a pool that could
        not hold it privately."""
        if self.mode not in ("continuous", "paged"):
            raise RuntimeError(
                "can_admit() is only available in continuous/paged modes")
        if self.health == "halted":
            return False
        if self.faults.fire("admit.reject"):
            return False
        queued = [self._requests[r] for r in self._queue]
        if self.mode == "continuous":
            return self.pool.slots - self.pool.active - len(queued) >= 1
        held = sum(self.pool.pages_for(len(r.prompt) + r.max_new)
                   for r in queued)
        shared = 0
        if prompt is not None and self.prefix_sharing:
            shared = self.pool.probe_shared(prompt)[1]
        return self.pool.can_admit(prompt_len + max_new,
                                   held_slots=len(queued), held_pages=held,
                                   shared_pages=shared)

    def live_stats(self) -> Dict[str, object]:
        """Instantaneous gauges for a metrics endpoint (cheap, no
        device sync): queue depth, slot occupancy, and — in paged mode —
        physical pages in use."""
        d: Dict[str, object] = {
            "mode": self.mode,
            "queue_depth": self.queue_depth,
            "slots": self.slots,
            "active_slots": self.pool.active if self.pool is not None
            else 0,
            "steps": self._steps,
            "health": self.health,
            "counters": dict(self.counters),
        }
        if self.mode == "paged":
            d["pages_in_use"] = self.pool.pages_in_use
            d["pages"] = self.pool.n_pages - 1
            d["tp"] = self.tp
            d["cow_copies"] = self.pool.cow_copies
            d["shared_attaches"] = self.pool.shared_attaches
        return d

    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               top_k: int = 0, key: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request.  ``temperature``/``top_k``/``key`` are per-row
        sampling inputs of the paged graph (temperature 0 = greedy, the
        default and the cross-mode parity baseline; top_k 0 = full
        vocabulary; ``key`` seeds the request's PRNG stream — same key,
        same tokens).  ``deadline_s`` bounds the request's total time in
        the engine (queue wait included): past it, the scheduler retires
        the request with status ``deadline_exceeded`` at the next
        step/chunk boundary, keeping any tokens already generated."""
        if self.health == "halted":
            raise RuntimeError(
                "engine is halted after an unrecoverable step failure; "
                "build a fresh engine to serve again")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.check_request(len(prompt), max_new, temperature=temperature,
                           top_k=top_k, key=key, deadline_s=deadline_s)
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        self._requests[rid] = Request(
            rid, prompt, int(max_new), t_submit=now,
            temperature=float(temperature), top_k=int(top_k), key=int(key),
            deadline=(now + float(deadline_s)
                      if deadline_s is not None else None))
        self._queue.append(rid)
        return rid

    # -- request lifecycle --------------------------------------------
    def cancel(self, rid: int, reason: str = "cancelled by caller") -> bool:
        """Retire request ``rid``: immediately while it is still queued,
        else at the next step/chunk boundary (continuous/paged modes --
        the only points where a slot can be returned safely).  Its slot
        and KV pages verifiably go back to the pool and any tokens
        already generated are kept.  Returns False when the request had
        already reached a terminal status (nothing to do); raises
        ``KeyError`` for an unknown rid.

        lockstep/donated admit their whole batch inside :meth:`run`, so
        cancellation there reaches only still-queued requests."""
        req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request id {rid}")
        if req.finished:
            return False
        req.cancel_reason = reason
        if rid in self._queue:      # never admitted: no slot to return
            self._queue.remove(rid)
            self._retire(req, "cancelled", error=reason)
            return True
        if self.mode in ("continuous", "paged"):
            return True             # active: reaped at the next boundary
        return False                # lockstep/donated mid-run: too late

    def drain_events(self) -> List[Tuple[int, str, Optional[str]]]:
        """Terminal events ``(rid, status, error)`` since the last call —
        how a front door learns a request ended (and why) without
        polling every Request object."""
        events, self._events = self._events, []
        return events

    def _retire(self, req: Request, status: str,
                error: Optional[str] = None) -> None:
        """The single terminal transition: set the status, free the
        slot/pages, count it, and emit the terminal event."""
        req.status = status
        req.error = error
        req.t_done = time.perf_counter()
        if req.slot is not None:
            self._slot_req[req.slot] = None
            self.pool.free(req.slot)
            req.slot = None
        self.counters[status] += 1
        self._events.append((req.rid, status, error))

    def _reap(self) -> None:
        """Step/chunk-boundary sweep: honour cancellations and expired
        deadlines for queued and active requests before admitting or
        dispatching anything."""
        now = time.perf_counter()
        for rid in list(self._queue):
            req = self._requests[rid]
            if req.cancel_reason is not None:
                self._queue.remove(rid)
                self._retire(req, "cancelled", error=req.cancel_reason)
            elif req.deadline is not None and now >= req.deadline:
                self._queue.remove(rid)
                self._retire(req, "deadline_exceeded",
                             error="deadline expired before admission")
        for rid in list(self._slot_req):
            if rid is None:
                continue
            req = self._requests[rid]
            if req.cancel_reason is not None:
                self._retire(req, "cancelled", error=req.cancel_reason)
            elif req.deadline is not None and now >= req.deadline:
                self._retire(req, "deadline_exceeded",
                             error=f"deadline expired after "
                                   f"{len(req.tokens)} tokens")

    def _contain_step_failure(self, exc: BaseException) -> None:
        """A dispatch raised: fail every in-flight request with a
        structured error, then verify the pool's accounting — keeping it
        (fresh buffers; donation may have consumed the old ones) when
        consistent, rebuilding it wholesale when not — and drop to
        ``degraded`` health.  If even that fails, ``halted``: submit and
        step refuse until the engine is replaced."""
        self.counters["engine_errors"] += 1
        msg = f"dispatch failed: {type(exc).__name__}: {exc}"
        damage = False
        for slot, rid in enumerate(self._slot_req):
            if rid is None:
                continue
            req = self._requests[rid]
            req.slot = None             # freed below, or swept by rebuild
            self._slot_req[slot] = None
            try:
                self.pool.free(slot)
            except Exception:
                damage = True
            self._retire(req, "failed", error=msg)
        try:
            problems = self.pool.verify()
        except Exception as verr:
            problems = [f"verify raised: {verr}"]
        try:
            if damage or problems:
                self.pool.rebuild()
            else:
                self.pool.reset_buffers()
            self.health = "degraded"
        except Exception:
            self.health = "halted"

    def _check_tp_devices(self) -> None:
        """A tp mesh needs ``tp`` shards: an explicit ``options.mesh`` of
        that size, CPU shards (any number), or one card per shard."""
        mesh = self.base_options.mesh
        if mesh is not None:
            if mesh.devices.size != self.tp:
                raise ValueError(
                    f"tp={self.tp} needs a mesh of {self.tp} shards, got "
                    f"{mesh}")
            return
        if self.device.type == "cpu":
            return
        n_dev = torch.cuda.device_count()
        if n_dev < self.tp:
            from ..backend.sharding import shared_card_recipe
            raise RuntimeError(
                f"tp={self.tp} needs >= {self.tp} devices but torch "
                f"sees {n_dev} cards; for shards that share one card "
                f"pass options=CompileOptions(mesh="
                f"{shared_card_recipe((self.tp,))})")

    # -- prefill -------------------------------------------------------------
    def _params_for(self, g: ModelGraphs) -> List[torch.Tensor]:
        """A graph's weights in its parameter order: shared names from
        the engine's map (decode weights must agree), any others from the
        graph builder's own seeded init."""
        names = g.builder.param_names()
        missing = [n for n in names if n not in self._param_map]
        own = g.builder.init_params(self.seed) if missing else {}
        return [self._param_map[n] if n in self._param_map
                else as_tensor(own[n], self.device) for n in names]

    def _prefill_for(self, P: int, batch: int):
        key = (P, batch)
        if key not in self._prefill:
            g = build_graphs(self.cfg,
                             ShapeConfig("prefill", "prefill", P, batch), batch)
            cf = self.backend.compile(g.fn, self.base_options)
            self._prefill[key] = (g, cf, self._params_for(g))
        return self._prefill[key]

    def _prefill_inputs(self, g: ModelGraphs, prompts: np.ndarray):
        """Non-weight prefill inputs: the token prompt plus stubbed
        frames/images for the multimodal families (as the legacy driver
        did — serving real media is out of scope here)."""
        rng = np.random.default_rng(self.seed)
        pin = []
        for node in g.builder.inputs:
            t = node.out_types[0]
            if node.name == "tokens":
                pin.append(prompts)
            else:
                pin.append((rng.normal(size=t.shape) * 0.02).astype(t.dtype))
        return pin

    # -- dense prefill (continuous; paged with prefill_chunk=0) ---------------
    def _admit(self, req: Request, slot: int) -> int:
        """Prefill ``req`` densely into pool ``slot``; returns its first
        token.

        The first token is host-sampled with the same (key, pos) hash
        the graph uses for decode steps, at pos = last prompt position
        — plain argmax for greedy rows, i.e. every non-paged request.
        Shared by the continuous and paged schedulers (the pools expose
        the same ``write_prefix`` contract); paged slots grow their
        pages before the scatter and record the rows actually cached."""
        t0 = time.perf_counter()
        P = len(req.prompt)
        g, cf, pvals = self._prefill_for(P, 1)
        outs = cf.raw(*self._prefill_inputs(g, req.prompt.reshape(1, P)),
                      *pvals)
        first = _host_sample(to_numpy(outs[0]), req.temperature,
                             req.top_k, req.key, P - 1)
        start = 0
        if self.mode == "paged":
            if self.prefix_sharing:
                # attach matching prefix pages, then scatter only from
                # the first non-shared page (COW-copying the tail page
                # first when the whole prompt matched)
                covered = self.pool.share_prefix(slot, req.prompt)
                start = min(covered, P - 1)
            self.pool.ensure_pages(slot, P - 1)
            self.pool.prepare_writes(slot, start, P - 1)
        for i, name in enumerate(g.aux.get("cache_names", [])):
            if self.mode == "paged":
                self.pool.write_prefix(slot, name, outs[1 + i],
                                       start_tok=start)
            else:
                self.pool.write_prefix(slot, name, outs[1 + i])
        if self.mode == "paged" and self.prefix_sharing:
            self.pool.publish_prefix(slot, req.prompt)
        req.slot = slot
        req.pos = P
        req.status = "active"
        req.tokens = [first]
        # the first token exists the moment prefill returns: admission
        # and first-token are the same instant on this scheduler
        req.t_admit = req.t_first = time.perf_counter()
        self._slot_req[slot] = req.rid
        self._tok[slot, 0] = first
        self._pos[slot] = P
        if self.mode == "paged":
            self.pool.note_used(slot, P)
        self.prefill_seconds += time.perf_counter() - t0
        return first

    def _finish(self, req: Request) -> None:
        self._retire(req, "completed")

    # -- in-graph chunked prefill -------------------------------------
    def _defer_for_publisher(self, req: Request) -> bool:
        """Would waiting a step let ``req`` attach more prefix pages?

        True when some active, still-prefilling request shares a longer
        full-page prefix with ``req`` than the index can offer right now
        — it will publish those pages when its prefill completes, and a
        deferred admission attaches them instead of caching them twice.
        A cancelled publisher simply stops matching, so deferral can
        never stall past the publisher's own lifetime."""
        ps = self.pool.page_size
        best = self.pool.probe_shared(req.prompt)[0] // ps
        for rid in self._slot_req:
            if rid is None:
                continue
            rp = self._requests[rid]
            if rp.finished or rp.prefill_pos is None:
                continue
            m = min(len(rp.prompt), len(req.prompt))
            neq = np.nonzero(rp.prompt[:m] != req.prompt[:m])[0]
            common = m if not len(neq) else int(neq[0])
            if common // ps > best:
                return True
        return False

    def _paged_prefill_for(self, C: int):
        """Compile (once per distinct chunk length) the paged prefill
        graph: a (1, C) prompt slice written straight into the page pool,
        cache buffers donated like the decode chunk."""
        if C not in self._pf_chunks:
            from ..models.lm import build_dense_paged_prefill
            g = build_dense_paged_prefill(
                self.cfg, self.max_len, C, page_size=self.page_size,
                n_pages=self.n_pages)
            step_in = ("token", "pos", "page_tbl")
            cache_ix = tuple(i for i, n in enumerate(g.builder.inputs)
                             if n.name not in step_in)
            cf = self.backend.compile(
                g.fn, self._graph_options.replace(donate_argnums=cache_ix))
            pvals = self._params_for(g)
            out_names = g.aux["state_out_names"]
            recycle = [out_names.index(n) if n in out_names else None
                       for n in self.pool.names]
            _check_donation(cf, cache_ix, recycle, cache_ix)
            self._pf_chunks[C] = (g, cf, pvals, recycle)
        return self._pf_chunks[C]

    def _begin_prefill(self, req: Request, slot: int) -> None:
        """Admit ``req`` into ``slot`` for chunked prefill: attach any
        shared prefix pages, then leave the prompt remainder to be
        prefilled chunk-by-chunk through the step loop (so a long prompt
        interleaves with in-flight decodes instead of stalling them).
        The request holds its slot but emits nothing until the final
        chunk samples its first token."""
        P = len(req.prompt)
        covered = (self.pool.share_prefix(slot, req.prompt)
                   if self.prefix_sharing else 0)
        # always re-process at least the last prompt token: its chunk
        # produces the logits the first token is sampled from
        req.prefill_pos = min(covered, P - 1)
        req.slot = slot
        req.status = "active"
        req.t_admit = time.perf_counter()
        self._slot_req[slot] = req.rid
        self.pool.note_used(slot, req.prefill_pos)

    def _prefill_chunk_step(self, slot: int, req: Request) -> Optional[int]:
        """Advance ``slot``'s prefill by one chunk (one dispatch of at
        most ``prefill_chunk`` prompt tokens).  On the chunk that
        completes the prompt: host-sample the first token from the
        returned last-row logits, publish the prefix pages, and hand the
        row over to decode — returning the first token.  Returns None
        while the prompt is still partially cached (or after a contained
        dispatch failure)."""
        t0 = time.perf_counter()
        P = len(req.prompt)
        lo = req.prefill_pos
        hi = min(lo + self.prefill_chunk, P)
        g, cf, pvals, recycle = self._paged_prefill_for(hi - lo)
        self.pool.ensure_pages(slot, hi - 1)
        self.pool.prepare_writes(slot, lo, hi - 1)
        tok_chunk = np.ascontiguousarray(
            req.prompt[lo:hi].reshape(1, hi - lo))
        ptbl = np.ascontiguousarray(self.pool.page_table[slot:slot + 1])
        try:
            self.faults.delay("dispatch.delay")
            self.faults.check("prefill.raise")
            outs = cf.raw(tok_chunk, np.int32(lo), ptbl,
                          *self.pool.buffers, *pvals)
            logits = to_numpy(outs[0])  # (1, 1, V) -- syncs the chain
            self.pool.update([self.pool.buffers[k] if j is None
                              else outs[1 + j]
                              for k, j in enumerate(recycle)])
        except Exception as exc:
            self._contain_step_failure(exc)
            return None
        req.prefill_pos = hi
        self.pool.note_used(slot, hi)
        self.prefill_seconds += time.perf_counter() - t0
        if hi < P:
            return None
        first = _host_sample(logits, req.temperature, req.top_k, req.key,
                             P - 1)
        if self.prefix_sharing:
            self.pool.publish_prefix(slot, req.prompt)
        req.prefill_pos = None
        req.pos = P
        req.tokens = [first]
        req.t_first = time.perf_counter()
        self._tok[slot, 0] = first
        self._pos[slot] = P
        self.pool.note_used(slot, P)
        return first

    def step(self) -> List[Tuple[int, int]]:
        """One engine step: admit what fits, then one batched decode
        dispatch (one token per row in continuous mode, ``chunk_steps``
        tokens per row in paged mode).  Cancellations and expired
        deadlines are honoured first — the step boundary is the only
        point a slot can be returned safely.

        Returns the ``(rid, token)`` pairs emitted.  Only available in
        continuous/paged modes — lockstep/donated run whole workloads via
        :meth:`run`."""
        if self.health == "halted":
            raise RuntimeError(
                "engine is halted after an unrecoverable step failure; "
                "build a fresh engine to serve again")
        if self.mode == "paged":
            return self._step_paged()
        if self.mode != "continuous":
            raise RuntimeError(
                "step() is only available in continuous/paged modes")
        if self._t0_work is None:
            self._t0_work = time.perf_counter()
        self._reap()
        emitted: List[Tuple[int, int]] = []
        while self._queue and self.pool.has_free:
            req = self._requests[self._queue.pop(0)]
            slot = self.pool.alloc()
            if self._steps > 0:
                self.late_admissions += 1
            emitted.append((req.rid, self._admit(req, slot)))
            if req.done:  # max_new == 1: done straight out of prefill
                self._finish(req)
        active = [(s, self._requests[rid])
                  for s, rid in enumerate(self._slot_req) if rid is not None]
        if not active:
            return emitted
        self._kv_sample(len(active) * self.pool.bytes_per_slot,
                        sum(r.pos for _, r in active))
        t0 = time.perf_counter()
        try:
            self.faults.delay("dispatch.delay")
            self.faults.check("dispatch.raise")
            outs = self.cf.raw(self._tok, self._pos, *self.pool.buffers,
                               *self.tparams)
            sample = to_numpy(outs[0])  # (B, 1) -- syncs the chain
            self.pool.update([self.pool.buffers[k] if j is None
                              else outs[1 + j]
                              for k, j in enumerate(self._recycle)])
        except Exception as exc:
            self._contain_step_failure(exc)
            return emitted
        dt = time.perf_counter() - t0
        self._steps += 1
        self.step_seconds.append(dt)
        self._decode_tokens += len(active)
        self.lat_ms.extend([dt * 1e3] * len(active))
        for slot, req in active:
            tok = int(sample[slot, 0])
            req.tokens.append(tok)
            req.pos += 1
            self._tok[slot, 0] = tok
            self._pos[slot] = req.pos
            emitted.append((req.rid, tok))
            if req.done:
                self._finish(req)
        return emitted

    # -- paged chunked scheduling --------------------------------------------
    def _step_paged(self) -> List[Tuple[int, int]]:
        """One chunk: admit what fits (chunk boundary = the only
        admission/retirement point), grow pages to cover the chunk's
        writes, then one fused ``chunk_steps``-token dispatch."""
        if self._t0_work is None:
            self._t0_work = time.perf_counter()
        self._reap()
        K = self.chunk_steps
        emitted: List[Tuple[int, int]] = []
        while self._queue:
            req = self._requests[self._queue[0]]
            if self.prefix_sharing and self.prefill_chunk and \
                    self._defer_for_publisher(req):
                # prefill dedup: a still-prefilling request is about to
                # publish a longer matching prefix than the index holds
                # now — admitting at the next boundary attaches those
                # pages instead of re-prefilling them (FIFO holds behind
                # the head, like every other admission stall)
                break
            shared = (self.pool.probe_shared(req.prompt)[1]
                      if self.prefix_sharing else 0)
            if not self.pool.can_admit(len(req.prompt) + req.max_new,
                                       shared_pages=shared):
                break
            self._queue.pop(0)
            slot = self.pool.alloc(len(req.prompt) + req.max_new,
                                   shared_pages=shared)
            if self._steps > 0:
                self.late_admissions += 1
            if self.prefill_chunk:
                self._begin_prefill(req, slot)
            else:
                emitted.append((req.rid, self._admit(req, slot)))
                if req.done:  # max_new == 1: done straight out of prefill
                    self._finish(req)
        # advance chunked prefills — one chunk per prefilling slot per
        # step, so long prompts share the step loop with decode rows
        # instead of stalling them behind one dense prefill dispatch
        for slot, rid in enumerate(list(self._slot_req)):
            if rid is None:
                continue
            req = self._requests[rid]
            if req.finished or req.prefill_pos is None:
                continue
            tok = self._prefill_chunk_step(slot, req)
            if tok is not None:
                emitted.append((req.rid, tok))
                if req.done:  # max_new == 1: done at prefill completion
                    self._finish(req)
        prefilling = [s for s, rid in enumerate(self._slot_req)
                      if rid is not None
                      and self._requests[rid].prefill_pos is not None]
        active = [(s, self._requests[rid])
                  for s, rid in enumerate(self._slot_req)
                  if rid is not None and s not in prefilling]
        if not active:
            return emitted
        for slot, req in active:
            # cover this chunk's writes, capped at the request's lifetime
            # (== its admission reservation); a row that finishes
            # mid-chunk keeps stepping until the boundary — overrun
            # writes beyond the cap land on its own tail rows or the
            # trash page (logical page clamped in-graph), both harmless
            # because overrun steps' outputs are discarded
            self.pool.ensure_pages(
                slot, min(req.pos + K, len(req.prompt) + req.max_new) - 1)
            self._pos[slot] = req.pos
            self._tok[slot, 0] = req.tokens[-1]
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._key[slot] = req.key
        for s in range(self.slots):
            if self._slot_req[s] is None or s in prefilling:
                # idle rows decode garbage into the trash page (their
                # page-table row is all zeros) and are ignored below;
                # rows still mid-prefill are masked the same way in the
                # dispatched table copy so their garbage decode writes
                # can't corrupt the pages the prefill chunks own
                self._pos[s] = 0
                self._tok[s, 0] = 0
                self._temp[s] = 0.0
                self._topk[s] = 0
                self._key[s] = 0
        dispatch_tbl = self.pool.page_table
        if prefilling:
            dispatch_tbl = dispatch_tbl.copy()
            dispatch_tbl[prefilling] = 0
        # prefilling rows hold committed pages too (counted in the byte
        # numerator), so credit their already-cached prompt rows in the
        # token denominator — else a decode overlapping a multi-step
        # prefill inflates kv_bytes_per_active_token
        prefill_rows = sum(self._requests[self._slot_req[s]].prefill_pos or 0
                           for s in prefilling)
        self._kv_sample(self.pool.committed_pages * self.pool.bytes_per_page,
                        sum(r.pos for _, r in active) + prefill_rows)
        self.pool.sample_fragmentation()
        t0 = time.perf_counter()
        try:
            self.faults.delay("dispatch.delay")
            self.faults.check("dispatch.raise")
            outs = self.cf.raw(self._tok, self._pos, dispatch_tbl,
                               self._temp, self._topk, self._key,
                               *self.pool.buffers, *self.tparams)
            toks = to_numpy(outs[0])  # (K, B, 1) -- syncs the chain
            self.pool.update([self.pool.buffers[k] if j is None
                              else outs[1 + j]
                              for k, j in enumerate(self._recycle)])
        except Exception as exc:
            self._contain_step_failure(exc)
            return emitted
        dt = time.perf_counter() - t0
        self._steps += 1
        self.step_seconds.append(dt)
        chunk_tokens = 0
        for slot, req in active:
            take = min(req.max_new - len(req.tokens), K)
            for t in toks[:take, slot, 0]:
                req.tokens.append(int(t))
                emitted.append((req.rid, int(t)))
            req.pos += take
            self.pool.note_used(slot, req.pos)
            chunk_tokens += take
            if req.done:
                self._finish(req)
        self._decode_tokens += chunk_tokens
        # like donated mode, a chunk's tokens become visible when the
        # dispatch returns: the honest per-token latency sample is the
        # chunk duration (chunking trades time-to-token for throughput)
        self.lat_ms.extend([dt * 1e3] * chunk_tokens)
        return emitted

    def _kv_sample(self, reserved_bytes: int, active_tokens: int) -> None:
        if active_tokens > 0:
            self._kv_byte_steps += float(reserved_bytes)
            self._kv_token_steps += int(active_tokens)

    def stream(self) -> Iterator[Tuple[int, int]]:
        """Yield ``(rid, token)`` pairs until all submitted work drains
        (continuous/paged modes)."""
        while self._queue or any(r is not None for r in self._slot_req):
            for pair in self.step():
                yield pair

    # -- lockstep / donated (uniform workloads) ------------------------------
    def _chunk_for(self, steps: int):
        """Fused ``steps``-step decode graph (donated caches)."""
        if steps not in self._chunks:
            from ..models.lm import build_dense_chunk
            g = build_dense_chunk(self.cfg, self.max_len, self.slots, steps)
            cache_ix = [i for i, n in enumerate(g.builder.inputs)
                        if n.name not in _STEP_INPUTS]
            cf = self.backend.compile(g.fn, self.base_options.replace(
                donate_argnums=tuple(cache_ix)))
            _check_donation(cf, cache_ix, list(range(len(cache_ix))),
                            cache_ix)
            pvals = [self._param_map[n] for n in g.builder.param_names()]
            self._chunks[steps] = (g, cf, pvals)
        return self._chunks[steps]

    def _run_lockstep(self) -> None:
        reqs = [self._requests[rid] for rid in self._queue]
        self._queue = []
        if not reqs:
            return
        if len(reqs) > self.slots:
            raise ValueError(f"{len(reqs)} requests > {self.slots} slots "
                             f"({self.mode} admits everything up front)")
        P = len(reqs[0].prompt)
        if any(len(r.prompt) != P for r in reqs):
            raise ValueError(f"{self.mode} requires uniform prompt lengths")
        B = self.slots
        prompts = np.zeros((B, P), np.int32)
        for i, r in enumerate(reqs):
            prompts[i] = r.prompt
            r.status = "active"
        try:
            self.faults.delay("dispatch.delay")
            self.faults.check("dispatch.raise")
            g, cf, pvals = self._prefill_for(P, B)
            pin = self._prefill_inputs(g, prompts)
            t0 = time.perf_counter()
            if self.mode == "lockstep":
                outs = cf(*pin, *pvals)
            else:
                outs = cf.raw(*pin, *pvals)
            logits = to_numpy(outs[0]).reshape(B, -1)
            tok = np.argmax(logits, axis=-1).astype(np.int32).reshape(B, 1)
            t_first = time.perf_counter()
            for i, r in enumerate(reqs):
                r.pos = P
                r.tokens = [int(tok[i, 0])]
                r.t_admit = r.t_first = t_first
            # decode caches: zero-filled, prefill prefix copied in by
            # *name* (ModelGraphs.aux["cache_names"] -- prefill output i
            # is the decode input named cache_names[i])
            caches = self._init_caches(g, outs[1:])
            del outs
            self.prefill_seconds += time.perf_counter() - t0
            n_steps = max(r.max_new for r in reqs) - 1
            if n_steps <= 0:
                for r in reqs:
                    self._retire(r, "completed")
                return
            if self.mode == "donated":
                self._decode_donated(reqs, tok, P, caches, n_steps)
            else:
                self._decode_lockstep(reqs, tok, P, caches, n_steps)
        except Exception as exc:
            # same containment contract as step(): the batch fails with a
            # structured error, the engine stays alive (no pool to verify
            # in these modes -- caches are per-run locals)
            self.counters["engine_errors"] += 1
            msg = f"dispatch failed: {type(exc).__name__}: {exc}"
            for r in reqs:
                if not r.finished:
                    self._retire(r, "failed", error=msg)
            self.health = "degraded"

    def _decode_lockstep(self, reqs, tok, P, caches, n_steps) -> None:
        """The legacy hot loop: token, logits and caches make a numpy
        round trip every step (``CompiledFunction.__call__``)."""
        B = self.slots
        for step in range(n_steps):
            pos = np.int32(P + step)
            t0 = time.perf_counter()
            outs = self.cf(tok, pos, *caches, *self.tparams)
            logits = np.asarray(outs[0]).reshape(B, -1)
            caches = [caches[k] if j is None else outs[1 + j]
                      for k, j in enumerate(self._recycle)]
            tok = np.argmax(logits, axis=-1).astype(np.int32).reshape(B, 1)
            dt = time.perf_counter() - t0
            emitted = 0
            for i, r in enumerate(reqs):
                if not r.done:
                    r.tokens.append(int(tok[i, 0]))
                    r.pos += 1
                    emitted += 1
                if r.done and not r.finished:
                    self._retire(r, "completed")
            self._steps += 1
            self.step_seconds.append(dt)
            self._decode_tokens += emitted
            self.lat_ms.extend([dt * 1e3] * emitted)
            if all(r.done for r in reqs):
                break

    def _decode_donated(self, reqs, tok, P, caches, n_steps) -> None:
        """Device-resident hot loop: one dispatch runs all ``n_steps``
        greedy steps inside the graph; the caches never come back to the
        host, only the (steps, B, 1) token ids do."""
        g, cf, pvals = self._chunk_for(n_steps)
        t0 = time.perf_counter()
        outs = cf.raw(tok, np.int32(P), *caches, *pvals)
        toks = to_numpy(outs[0])    # (steps, B, 1) -- syncs the chain
        del outs
        dt = time.perf_counter() - t0
        self._steps += 1
        self.step_seconds.append(dt)
        # every token of the fused chunk becomes visible only when the
        # dispatch returns, so the honest per-token latency sample is the
        # whole chunk duration -- donated mode trades time-to-token for
        # throughput (decode_tok_s is the amortized rate)
        for i, r in enumerate(reqs):
            take = min(r.max_new - 1, n_steps)
            r.tokens.extend(int(t) for t in toks[:take, i, 0])
            r.pos += take
            self._retire(r, "completed")
            self._decode_tokens += take
            self.lat_ms.extend([dt * 1e3] * take)

    def _init_caches(self, prefill_graphs: ModelGraphs, prefill_caches):
        """The decode caches for a lockstep/donated run: zeros on the
        device with each prefill cache copied in by name, along its
        ``kv_seq`` axis, on the device (no host round trip of the
        cache).  A decode input the prefill does not name stays zero, as
        in the reference: rg_hybrid's conv tails and RG-LRU states (its
        prefill exports only the attention caches) and all seven of
        xlstm's states (its prefill exports none).  Lockstep gets numpy
        copies, the caches its numpy loop passes around."""
        name_map = {name: prefill_caches[i] for i, name in
                    enumerate(prefill_graphs.aux.get("cache_names", []))}
        b = self.graphs.builder
        caches = []
        for node in b.inputs:
            if node.name in self._step_inputs:
                continue
            buf = _zeros(node.out_types[0], self.device)
            pc = name_map.get(node.name)
            if pc is not None:  # unmapped inputs stay zero
                pc = as_tensor(pc, self.device)
                sl: List[Any] = [slice(None)] * buf.ndim
                spec = tuple(b.input_specs[node.name])
                if "kv_seq" in spec:
                    sd = spec.index("kv_seq")
                    sl[sd] = slice(0, pc.shape[sd])
                buf[tuple(sl)] = pc.to(buf.dtype)
            caches.append(buf)
        if self.mode == "lockstep":
            return [to_numpy(c) for c in caches]
        return caches

    def cache_stats(self):
        """The engine backend's compile-cache counters (memory + disk +
        autotune) — the serving-smoke CI step asserts on these."""
        return self.backend.cache_stats()

    # -- driving -------------------------------------------------------------
    def run(self) -> EngineReport:
        """Drive all submitted requests to completion.

        Wall time is counted from the engine's first dispatched work, so
        a ``stream()``-then-``run()`` sequence reports the full span."""
        if self._t0_work is None:
            self._t0_work = time.perf_counter()
        if self.health == "halted":
            # nothing can be dispatched; fail what is still queued so the
            # report accounts for every submitted request
            for rid in list(self._queue):
                self._retire(self._requests[rid], "failed",
                             error="engine halted")
            self._queue = []
        elif self.mode in ("continuous", "paged"):
            for _ in self.stream():
                pass
        else:
            self._run_lockstep()
        wall = time.perf_counter() - self._t0_work
        results = {rid: np.asarray(r.tokens, np.int32)
                   for rid, r in self._requests.items()}
        gen = sum(len(v) for v in results.values())
        decode_secs = sum(self.step_seconds)
        ttft = [(r.t_first - r.t_submit) * 1e3
                for r in self._requests.values() if r.t_first is not None]
        return EngineReport(
            mode=self.mode, results=results, wall_seconds=wall,
            generated_tokens=gen, tok_s=gen / max(wall, 1e-9),
            decode_tok_s=self._decode_tokens / max(decode_secs, 1e-9),
            p50_ms=_percentile(self.lat_ms, 50),
            p95_ms=_percentile(self.lat_ms, 95),
            steps=self._steps, prefill_seconds=self.prefill_seconds,
            late_admissions=self.late_admissions,
            pool=self.pool.stats() if self.pool is not None else None,
            ttft_p50_ms=_percentile(ttft, 50),
            ttft_p95_ms=_percentile(ttft, 95),
            kv_bytes_per_active_token=(
                self._kv_byte_steps / self._kv_token_steps
                if self._kv_token_steps else None),
            statuses={rid: r.status for rid, r in self._requests.items()},
            errors={rid: r.error for rid, r in self._requests.items()
                    if r.error is not None},
            counters=dict(self.counters), health=self.health,
            tp=self.tp,
            kv_bytes_per_device=(self.pool.total_bytes // self.tp
                                 if self.pool is not None else None))
