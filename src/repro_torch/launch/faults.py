"""Deterministic fault injection for the serving stack.

A :class:`FaultInjector` owns a set of named *sites* — places in the
engine / server / load client where a failure can be provoked on
purpose — and a seeded rule per site deciding *when* it fires.  The
point is reproducibility: the CI chaos leg (``scripts/chaos_probe.py``)
and the fault-tolerance tests provoke the exact same dispatch failure,
admission rejection, or client disconnect on every run, so the
recovery contract (cancellation, pool reclaim, degraded health) is
gated forever instead of hoped for.

Sites:

  * ``dispatch.raise``            — raise :class:`FaultError` in place of a
                                    decode dispatch (engine containment path)
  * ``dispatch.delay``            — sleep before a dispatch (slow-step /
                                    heartbeat exercise)
  * ``prefill.raise``             — raise :class:`FaultError` in place of a
                                    chunked-prefill dispatch: same
                                    containment path, but the failing
                                    request may hold COW-shared pages
  * ``admit.reject``              — force ``ServeEngine.can_admit`` to say
                                    no (front-door 429 path)
  * ``client.disconnect_after_n`` — ``loadgen`` clients drop the connection
                                    after N streamed tokens

Spec grammar (env ``REPRO_FAULTS`` / CLI ``--faults``), comma-separated
``site=mode:arg[:value]``:

  * ``dispatch.raise=after:3``      — fire exactly once, on the 3rd call
  * ``admit.reject=first:2``        — fire on calls 1..2
  * ``dispatch.delay=every:4:0.05`` — every 4th call, payload 0.05 (s)
  * ``admit.reject=prob:0.3``       — seeded Bernoulli per call
  * ``client.disconnect_after_n=always:2`` — every call, payload 2 (tokens)

The third field is the site's *payload* (:meth:`FaultInjector.value`):
seconds for ``dispatch.delay``, token count for
``client.disconnect_after_n``; for ``after``/``first``/``every``/
``always`` the single argument doubles as the payload when no third
field is given (``always:2`` = always fire, payload 2).

The module-level injector (:func:`get_injector`) is process-global and
configured from the environment at import; engine/server/loadgen all
default to it, and tests pass their own instance for isolation.
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, Optional

SITES = ("dispatch.raise", "dispatch.delay", "admit.reject",
         "client.disconnect_after_n", "prefill.raise")
_MODES = ("after", "first", "every", "prob", "always")

ENV_SPEC = "REPRO_FAULTS"
ENV_SEED = "REPRO_FAULTS_SEED"


class FaultError(RuntimeError):
    """The injected failure (``dispatch.raise``) — a distinct type so
    containment tests can tell a provoked fault from a real bug."""


@dataclasses.dataclass
class _Rule:
    mode: str               # one of _MODES
    arg: float              # N (count modes) or probability (prob)
    payload: Optional[float]  # site-specific value (seconds, tokens, ...)


def _parse(spec: str) -> Dict[str, _Rule]:
    rules: Dict[str, _Rule] = {}
    for part in filter(None, (p.strip() for p in (spec or "").split(","))):
        if "=" not in part:
            raise ValueError(
                f"fault spec {part!r} is not site=mode:arg "
                f"(e.g. dispatch.raise=after:3)")
        site, rule = part.split("=", 1)
        site = site.strip()
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"sites: {', '.join(SITES)}")
        fields = rule.split(":")
        mode = fields[0].strip()
        if mode not in _MODES:
            raise ValueError(f"{site}: unknown mode {mode!r}; "
                             f"modes: {', '.join(_MODES)}")
        try:
            arg = float(fields[1]) if len(fields) > 1 else 1.0
            payload = float(fields[2]) if len(fields) > 2 else None
        except ValueError:
            raise ValueError(f"{site}: arguments must be numbers, "
                             f"got {rule!r}")
        if mode == "prob" and not 0.0 <= arg <= 1.0:
            raise ValueError(f"{site}: prob must be in [0, 1], got {arg}")
        if mode in ("after", "first", "every") and arg < 1:
            raise ValueError(f"{site}: {mode} needs a count >= 1, got {arg}")
        rules[site] = _Rule(mode, arg, payload)
    return rules


class FaultInjector:
    """Seeded, counted fault rules for the named sites.

    Thread-safe (one lock around the counters — ``fire`` is called from
    both the engine thread and asyncio handlers).  ``calls``/``fired``
    per-site counters are exposed via :meth:`stats` so probes can assert
    a scenario actually injected what it claimed to."""

    def __init__(self, spec: str = "", seed: int = 0):
        self._lock = threading.Lock()
        self.configure(spec, seed)

    def configure(self, spec: str = "", seed: int = 0) -> None:
        """(Re)configure from a spec string; resets all counters."""
        rules = _parse(spec)   # validate before touching state
        with self._lock:
            self.spec = spec
            self.seed = int(seed)
            self.rules = rules
            self.calls: Dict[str, int] = {s: 0 for s in self.rules}
            self.fired: Dict[str, int] = {s: 0 for s in self.rules}
            self._rng = {s: random.Random(f"{self.seed}:{s}")
                         for s in self.rules}

    def enabled(self, site: str) -> bool:
        return site in self.rules

    def fire(self, site: str) -> bool:
        """Count one call at ``site``; True when the fault fires."""
        with self._lock:
            rule = self.rules.get(site)
            if rule is None:
                return False
            self.calls[site] += 1
            n = self.calls[site]
            if rule.mode == "after":
                hit = n == int(rule.arg)
            elif rule.mode == "first":
                hit = n <= int(rule.arg)
            elif rule.mode == "every":
                hit = n % int(rule.arg) == 0
            elif rule.mode == "prob":
                hit = self._rng[site].random() < rule.arg
            else:  # always
                hit = True
            if hit:
                self.fired[site] += 1
            return hit

    def check(self, site: str) -> None:
        """Raise :class:`FaultError` when ``site`` fires (the
        ``dispatch.raise`` hook)."""
        if self.fire(site):
            raise FaultError(f"injected fault at {site} "
                             f"(call {self.calls[site]})")

    def delay(self, site: str, default_s: float = 0.05) -> None:
        """Sleep the site's payload seconds when it fires
        (``dispatch.delay``)."""
        if self.fire(site):
            time.sleep(self.value(site, default_s))

    def value(self, site: str, default: float = 0.0) -> float:
        """The site's payload: the explicit third spec field, else the
        rule argument (``always:2`` = payload 2), else ``default``."""
        rule = self.rules.get(site)
        if rule is None:
            return default
        if rule.payload is not None:
            return rule.payload
        if rule.mode in ("always", "first", "after", "every"):
            return rule.arg
        return default

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {s: {"calls": self.calls[s], "fired": self.fired[s]}
                    for s in self.rules}


_GLOBAL = FaultInjector(os.environ.get(ENV_SPEC, ""),
                        int(os.environ.get(ENV_SEED, "0") or 0))


def get_injector() -> FaultInjector:
    """The process-global injector (engine/server/loadgen default)."""
    return _GLOBAL


def configure(spec: str = "", seed: int = 0) -> FaultInjector:
    """Reconfigure the global injector (CLI ``--faults`` path)."""
    _GLOBAL.configure(spec, seed)
    return _GLOBAL
