"""Pass framework."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

from ..function import Function


class Pass:
    name = "pass"

    def run(self, fn: Function) -> Tuple[Function, Dict[str, int]]:
        raise NotImplementedError


class PassStats(list):
    """``report.stats`` — a list of (pass name, stat dict) that also
    supports lookup by pass name: ``report.stats["partition"]``."""

    def __getitem__(self, key):
        if isinstance(key, str):
            for name, st in self:
                if name == key:
                    return st
            raise KeyError(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except (KeyError, IndexError):
            return default

    def __contains__(self, key):
        if isinstance(key, str):
            return any(name == key for name, _ in self)
        return super().__contains__(key)


@dataclasses.dataclass
class PipelineReport:
    stats: List[Tuple[str, Dict[str, int]]]
    nodes_before: int
    nodes_after: int
    seconds: float

    def summary(self) -> str:
        lines = [f"pipeline: {self.nodes_before} -> {self.nodes_after} nodes "
                 f"in {self.seconds * 1e3:.1f} ms"]
        for name, st in self.stats:
            if st:
                lines.append(f"  {name}: " + ", ".join(f"{k}={v}" for k, v in st.items()))
        return "\n".join(lines)


class PassManager:
    def __init__(self, passes: List[Pass]):
        self.passes = passes

    def run(self, fn: Function) -> Tuple[Function, PipelineReport]:
        t0 = time.perf_counter()
        before = len(fn.nodes())
        stats = PassStats()
        for p in self.passes:
            fn, st = p.run(fn)
            stats.append((p.name, st))
        return fn, PipelineReport(stats, before, len(fn.nodes()),
                                  time.perf_counter() - t0)
