"""Data pipeline: deterministic, shardable, resumable.

Batches are a pure function of (seed, step, shard) — the property the
fault-tolerance story depends on: after restart, resuming at step N
reproduces exactly the batches a non-failed run would have seen, with no
state files beyond the step counter already in the checkpoint.

The synthetic source generates LM token streams with enough structure
(Zipfian marginals + an order-2 Markov mixture) that a real model's loss
visibly falls — used by the end-to-end example and integration tests.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


class SyntheticLM:
    """Deterministic synthetic LM token source."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("global_batch must divide by n_shards")
        self.local_batch = cfg.global_batch // cfg.n_shards
        # fixed Zipf-ish unigram table + deterministic bigram shift
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard]))
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        base = rng.choice(v, size=(b, s + 1), p=self._probs)
        # order-2 structure: with p=0.5 the next token = f(prev) (learnable)
        shifted = (base[:, :-1] * 31 + 17) % v
        coin = rng.random(size=(b, s)) < 0.5
        tokens = base[:, :-1].astype(np.int32)
        labels = np.where(coin, shifted, base[:, 1:]).astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded queue (keeps the step loop
    fed while the host builds the next batch)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.source = source
        self.start_step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self.start_step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> Tuple[int, Dict[str, np.ndarray]]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
