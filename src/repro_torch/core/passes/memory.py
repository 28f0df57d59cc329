"""Memory management: plan a shared arena with buffer reuse from liveness
(paper sec. 4 / abstract: "efficient memory management" is one of nGraph's
headline compiler optimizations).

``plan_memory`` assigns every intermediate tensor an (offset, size) in one
arena using a greedy best-fit free-list over liveness intervals.  The
interpreter can *execute inside the plan* (``MemoryPlan.place``), which
turns any unsound aliasing into visible numerical corruption — that is the
correctness test for this pass.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..function import Function
from ..node import Node
from .liveness import liveness_intervals

ALIGN = 128  # bytes; TPU-friendly alignment


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


@dataclasses.dataclass
class Assignment:
    offset: int
    size: int


class MemoryPlan:
    def __init__(self, fn: Function):
        self.fn = fn
        self.assignments: Dict[Tuple[int, int], Assignment] = {}
        self.arena_bytes = 0
        self.naive_bytes = 0
        self.peak_live_bytes = 0
        self.io_bytes = 0
        self._pool: Optional[bytearray] = None

    @property
    def reuse_fraction(self) -> float:
        if self.naive_bytes == 0:
            return 0.0
        return 1.0 - self.arena_bytes / self.naive_bytes

    # -- arena-backed execution (interpreter hook) --------------------------
    def place(self, node: Node, index: int, arr: np.ndarray) -> np.ndarray:
        key = (id(node), index)
        if key not in self.assignments:  # I/O value: not arena-managed
            return arr
        if self._pool is None:
            self._pool = bytearray(self.arena_bytes)
        a = self.assignments[key]
        t = node.out_types[index]
        view = np.frombuffer(self._pool, dtype=t.dtype, count=t.size,
                             offset=a.offset).reshape(t.shape)
        np.copyto(view, np.asarray(arr, dtype=t.dtype))
        return view

    def summary(self) -> str:
        return (f"arena={self.arena_bytes/1e6:.2f}MB naive={self.naive_bytes/1e6:.2f}MB "
                f"peak_live={self.peak_live_bytes/1e6:.2f}MB "
                f"reuse={self.reuse_fraction*100:.1f}% "
                f"buffers={len(self.assignments)}")


def plan_memory(fn: Function) -> MemoryPlan:
    order, intervals = liveness_intervals(fn)
    plan = MemoryPlan(fn)
    result_keys = {(id(r.node), r.index) for r in fn.results}

    managed = []  # (def, last_use, key, size)
    for n in order:
        for i in range(n.n_outputs):
            key = (id(n), i)
            size = _align(n.out_types[i].nbytes)
            if n.op in ("Parameter", "Constant") or key in result_keys:
                plan.io_bytes += size
                continue
            d, u = intervals[key]
            plan.naive_bytes += size
            managed.append((d, u, key, size))

    # peak live (lower bound on any plan)
    events = []
    for d, u, _, size in managed:
        events.append((d, size))
        events.append((u + 1, -size))
    live = peak = 0
    for _, delta in sorted(events):
        live += delta
        peak = max(peak, live)
    plan.peak_live_bytes = peak

    # greedy best-fit with a free list
    free: List[Tuple[int, int]] = []  # (offset, size)
    top = 0
    by_def = sorted(managed, key=lambda m: (m[0], -m[3]))
    releases: List[Tuple[int, Tuple[int, int]]] = []  # (release_time, key)
    active: Dict[Tuple[int, int], Tuple[int, int]] = {}

    import heapq
    heap: List[Tuple[int, Tuple[int, int]]] = []

    def release_until(t: int):
        nonlocal free
        while heap and heap[0][0] <= t:
            _, key = heapq.heappop(heap)
            off, size = active.pop(key)
            free.append((off, size))
        # coalesce
        if free:
            free.sort()
            merged = [free[0]]
            for off, size in free[1:]:
                lo, ls = merged[-1]
                if lo + ls == off:
                    merged[-1] = (lo, ls + size)
                else:
                    merged.append((off, size))
            free = merged

    for d, u, key, size in by_def:
        release_until(d)
        best = None
        for idx, (off, fsize) in enumerate(free):
            if fsize >= size and (best is None or fsize < free[best][1]):
                best = idx
        if best is not None:
            off, fsize = free.pop(best)
            if fsize > size:
                free.append((off + size, fsize - size))
        else:
            off = top
            top += size
        plan.assignments[key] = Assignment(off, size)
        active[key] = (off, size)
        heapq.heappush(heap, (u + 1, key))

    plan.arena_bytes = top
    return plan
