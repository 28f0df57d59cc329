"""Fault tolerance scaffolding: retries, heartbeats, straggler detection.

On a real 1000-node cluster the coordinator reschedules failed workers and
this module's pieces run on every host; on one host they degrade to a
watchdog around the step loop.  The contracts that matter at scale:

  * ``retry_step`` — transient failures (preempted chip, flaky link) retry
    with backoff; persistent failures raise so the supervisor restarts
    from the last checkpoint (which ``train.py`` does).
  * ``Heartbeat`` — liveness file per host; a missing heartbeat is how the
    launcher detects a dead node without waiting on a collective timeout.
  * ``StragglerDetector`` — per-step wall-time EMA; steps slower than
    ``threshold``x the EMA are flagged (on a cluster: triggers hot-spare
    swap / re-shard; here: logged + surfaced in metrics).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional


class TransientError(RuntimeError):
    """Raise inside a step for failures that are retry-safe."""


def retry_step(fn: Callable[[], Any], retries: int = 3, backoff: float = 0.5,
               on_retry: Optional[Callable[[int, BaseException], None]] = None):
    attempt = 0
    while True:
        try:
            return fn()
        except TransientError as e:
            attempt += 1
            if attempt > retries:
                raise
            if on_retry:
                on_retry(attempt, e)
            time.sleep(backoff * (2 ** (attempt - 1)))


class Heartbeat:
    def __init__(self, path: str, interval: float = 10.0, host_id: int = 0):
        self.path = path
        self.interval = interval
        self.host_id = host_id
        self._last = 0.0

    def beat(self, step: int, **info) -> None:
        now = time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"host": self.host_id, "step": step, "time": now, **info}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def is_alive(path: str, timeout: float = 60.0) -> bool:
        try:
            with open(path) as f:
                return time.time() - json.load(f)["time"] < timeout
        except (OSError, ValueError, KeyError):
            return False


class StragglerDetector:
    def __init__(self, threshold: float = 2.0, warmup: int = 5, decay: float = 0.9):
        self.threshold = threshold
        self.warmup = warmup
        self.decay = decay
        self.ema: Optional[float] = None
        self.count = 0
        self.stragglers: List[Dict[str, float]] = []

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step was a straggler."""
        self.count += 1
        if self.ema is None:
            self.ema = seconds
            return False
        is_straggler = (self.count > self.warmup
                        and seconds > self.threshold * self.ema)
        if is_straggler:
            self.stragglers.append({"step": step, "seconds": seconds,
                                    "ema": self.ema})
        else:  # stragglers don't poison the EMA
            self.ema = self.decay * self.ema + (1 - self.decay) * seconds
        return is_straggler
