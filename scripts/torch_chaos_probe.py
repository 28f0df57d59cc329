"""Chaos probe of the torch port: inject faults at every site, gate the
recovery contract (the port of ``scripts/chaos_probe.py``; imports only
``repro_torch``).

``python scripts/torch_chaos_probe.py --device cpu --report-json chaos.json``
runs one scenario per fault-tolerance path against torch engines
(reduced deepseek-7b, paged) on ``--device`` (the card by default) and
the real HTTP front door, each with a deterministic
:class:`repro_torch.launch.faults.FaultInjector` schedule:

  * ``dispatch_failure``  -- ``dispatch.raise`` mid-serve: the in-flight
    request fails with a structured error, the engine degrades (never
    dies), and an uninjected follow-up request still decodes
    token-for-token what a clean engine produces.
  * ``deadline_expiry``   -- the client ``timeout`` knob becomes an
    engine deadline; the stream ends ``deadline_exceeded``.
  * ``disconnect_storm``  -- every loadgen client hangs up mid-stream
    (``client.disconnect_after_n``); the server cancels each request.
  * ``cancel``            -- direct-engine ``cancel(rid)`` at a chunk
    boundary; the survivor keeps exact token parity with a solo run.
  * ``shared_prefix_storm`` -- cancel storm on a copy-on-write
    shared-prefix workload: the prefix publisher dies mid-decode while
    sharers hold references to its pages, a long sharer dies
    mid-prefill-chunk; refcounted pages must be decremented exactly once
    and the surviving sharer keeps solo-run token parity.

Every scenario must end with ``pages_in_use == 0``, zero leaked slots,
a clean drain, and token parity for whatever was not injected.  Exit
code 1 if any check of any scenario fails.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import faults, loadgen  # noqa: E402
from repro_torch.launch.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.launch.faults import FaultInjector  # noqa: E402
from repro_torch.launch.server import running_server  # noqa: E402

CFG = get_config("deepseek-7b").reduced()
P, G = 4, 8


def _engine(device, slots=2, max_len=16, injector=None, **kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("chunk_steps", 1)
    conf = EngineConfig(mode="paged", slots=slots, max_len=max_len,
                        seed=0, device=device, **kw)
    return ServeEngine(CFG, conf, faults=injector)


def _prompts(n: int) -> List[np.ndarray]:
    return loadgen.make_prompts(n, P, CFG.vocab, seed=0)


def _reference(device, prompt, gen) -> List[int]:
    eng = _engine(device)
    rid = eng.submit(prompt, gen)
    return [int(t) for t in eng.run().results[rid]]


def _gate(checks: Dict[str, bool], errors) -> Dict:
    """The scenario's verdict, with the errors its requests ended with
    (printed when a check fails)."""
    return {"ok": all(checks.values()), "checks": checks,
            "errors": [e for e in errors if e]}


def scenario_dispatch_failure(device) -> Dict:
    eng = _engine(device, injector=FaultInjector("dispatch.raise=after:3"))
    ref = _reference(device, _prompts(1)[0], G)
    with running_server(eng, max_wait_queue=4) as srv:
        r1 = asyncio.run(loadgen.stream_generate(
            srv.base_url, {"prompt": [int(t) for t in _prompts(1)[0]],
                           "max_new": G, "tag": "injected"}, timeout=300))
        # the engine degraded but keeps serving: an uninjected request
        # must decode exactly what a clean engine decodes
        r2 = asyncio.run(loadgen.stream_generate(
            srv.base_url, {"prompt": [int(t) for t in _prompts(1)[0]],
                           "max_new": G, "tag": "clean"}, timeout=300))
    rep = srv.engine_report
    return _gate({
        "injected_failed": r1.terminal == "failed"
                           and "FaultError" in (r1.error or ""),
        "clean_parity": r2.terminal == "completed" and r2.tokens == ref,
        "engine_degraded": rep is not None and rep.health == "degraded",
        "engine_errors_counted":
            rep is not None and rep.counters["engine_errors"] >= 1,
        "pages_reclaimed": eng.pool.pages_in_use == 0,
        "slots_reclaimed": eng.pool.active == 0,
        "drain_ok": srv.drain_ok is True,
    }, [r1.error, r2.error]) | {"counters": dict(rep.counters) if rep else {}}


def scenario_deadline_expiry(device) -> Dict:
    eng = _engine(device)
    ref = _reference(device, _prompts(1)[0], G)
    with running_server(eng, max_wait_queue=4) as srv:
        r1 = asyncio.run(loadgen.stream_generate(
            srv.base_url, {"prompt": [int(t) for t in _prompts(1)[0]],
                           "max_new": G, "timeout": 1e-3,
                           "tag": "deadline"}, timeout=300))
        r2 = asyncio.run(loadgen.stream_generate(
            srv.base_url, {"prompt": [int(t) for t in _prompts(1)[0]],
                           "max_new": G, "tag": "clean"}, timeout=300))
    rep = srv.engine_report
    return _gate({
        "deadline_terminal": r1.terminal == "deadline_exceeded",
        "partial_stream": len(r1.tokens) < G,
        "clean_parity": r2.terminal == "completed" and r2.tokens == ref,
        "deadline_counted":
            rep is not None and rep.counters["deadline_exceeded"] >= 1,
        "pages_reclaimed": eng.pool.pages_in_use == 0,
        "slots_reclaimed": eng.pool.active == 0,
        "drain_ok": srv.drain_ok is True,
    }, [r1.error, r2.error]) | {"counters": dict(rep.counters) if rep else {}}


def scenario_disconnect_storm(device) -> Dict:
    n = 3
    eng = _engine(device, slots=2, max_len=40)
    faults.configure("client.disconnect_after_n=always:2")
    try:
        with running_server(eng, max_wait_queue=n) as srv:
            res = loadgen.run_load(srv.base_url, _prompts(n), 32)
            # give the server time to notice every dead socket before
            # the drain freezes the counters
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and \
                    eng.counters["cancelled"] < n:
                time.sleep(0.05)
    finally:
        faults.configure("")
    rep = srv.engine_report
    return _gate({
        "all_disconnected": res.disconnects == n,
        "all_cancelled":
            rep is not None and rep.counters["cancelled"] == n,
        "pages_reclaimed": eng.pool.pages_in_use == 0,
        "slots_reclaimed": eng.pool.active == 0,
        "drain_ok": srv.drain_ok is True,
    }, res.errors + list(rep.errors.values() if rep else [])) | {
        "counters": dict(rep.counters) if rep else {}}


def scenario_cancel(device) -> Dict:
    prompts = _prompts(2)
    ref = _reference(device, prompts[1], G)
    eng = _engine(device)
    ra = eng.submit(prompts[0], G)
    rb = eng.submit(prompts[1], G)
    eng.step()
    cancelled = eng.cancel(ra, "chaos probe")
    t0 = time.perf_counter()
    eng.step()  # the boundary where the cancel lands
    reclaim_ms = (time.perf_counter() - t0) * 1e3
    freed = eng._requests[ra].slot is None
    rep = eng.run()
    return _gate({
        "cancel_accepted": cancelled is True,
        "slot_freed_at_boundary": freed,
        "terminal_status": rep.statuses[ra] == "cancelled",
        "survivor_parity": [int(t) for t in rep.results[rb]] == ref,
        "accounting_exact": eng.pool.verify() == [],
        "pages_reclaimed": eng.pool.pages_in_use == 0,
        "slots_reclaimed": eng.pool.active == 0,
    }, list(rep.errors.values())) | {"counters": dict(rep.counters),
                                     "reclaim_ms": reclaim_ms}


def scenario_shared_prefix_storm(device) -> Dict:
    """Cancel storm on a COW shared-prefix workload: a publisher and two
    sharers (one full-prompt match that copies-on-write, one longer
    prompt attaching the shared pages mid-prefill) are admitted; the
    publisher is cancelled mid-decode while the sharers still hold
    references to its pages, and the long sharer is cancelled mid-chunk.
    Refcounted pages must be decremented exactly once -- no double-free
    when the storm lands, no leak when the last sharer goes -- and the
    surviving sharer keeps exact token parity with a solo run."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, CFG.vocab, size=(8,)).astype(np.int32)
    longp = np.concatenate(
        [base, rng.integers(0, CFG.vocab, size=(8,)).astype(np.int32)])
    ref = _reference(device, base, G)
    eng = _engine(device, slots=3, max_len=24, prefill_chunk=4)
    rid_pub = eng.submit(base, G)
    rid_f1 = eng.submit(base, G)       # full match: attaches + COWs
    rid_f2 = eng.submit(longp, 4)      # partial match: attaches, extends
    # prefill dedup holds the sharers back until the publisher's prefix
    # pages are indexed; three steps later all three rows are live
    for _ in range(3):
        eng.step()
    p = eng.pool.stats()
    attached = p.shared_attaches
    cowed = p.cow_copies
    mid_prefill = eng._requests[rid_f2].prefill_pos is not None
    cancelled_pub = eng.cancel(rid_pub, "shared-prefix storm")
    cancelled_f2 = eng.cancel(rid_f2, "shared-prefix storm")
    eng.step()  # the boundary where both cancels land
    rep = eng.run()
    p = eng.pool.stats()
    return _gate({
        "sharers_attached": attached >= 4,
        "cow_fired": cowed >= 1,
        "long_sharer_mid_prefill": mid_prefill,
        "cancels_accepted": cancelled_pub is True and cancelled_f2 is True,
        "terminal_statuses": rep.statuses[rid_pub] == "cancelled"
                             and rep.statuses[rid_f2] == "cancelled",
        "survivor_parity": [int(t) for t in rep.results[rid_f1]] == ref,
        "refs_balanced": p.ref_allocs == p.ref_frees,
        "pages_freed_exactly_once": p.page_allocs == p.page_frees,
        "accounting_exact": eng.pool.verify() == [],
        "pages_reclaimed": p.pages_in_use == 0,
        "slots_reclaimed": p.active == 0,
    }, list(rep.errors.values())) | {"counters": dict(rep.counters)}


SCENARIOS = {
    "dispatch_failure": scenario_dispatch_failure,
    "deadline_expiry": scenario_deadline_expiry,
    "disconnect_storm": scenario_disconnect_storm,
    "cancel": scenario_cancel,
    "shared_prefix_storm": scenario_shared_prefix_storm,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--report-json", metavar="FILE", default=None,
                    help="write the chaos report")
    ap.add_argument("--scenario", choices=sorted(SCENARIOS), default=None,
                    help="run one scenario (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda', 'cuda:i' or 'cpu' (default: the card)")
    args = ap.parse_args(argv)

    names = [args.scenario] if args.scenario else list(SCENARIOS)
    scenarios: Dict[str, Dict] = {}
    counters = {"cancelled": 0, "deadline_exceeded": 0, "failed": 0,
                "completed": 0, "engine_errors": 0}
    failed = False
    for name in names:
        t0 = time.perf_counter()
        out = SCENARIOS[name](args.device)
        out["seconds"] = round(time.perf_counter() - t0, 3)
        scenarios[name] = out
        for k in counters:
            counters[k] += out.get("counters", {}).get(k, 0)
        status = "ok" if out["ok"] else "FAIL"
        print(f"[chaos:{name}] {status} in {out['seconds']}s "
              + " ".join(f"{k}={'ok' if v else 'FAIL'}"
                         for k, v in out["checks"].items()))
        if not out["ok"]:
            print(f"[chaos:{name}] errors: {out['errors']}")
        failed |= not out["ok"]

    doc = {"mode": "chaos", "device": args.device, "results": {},
           "scenarios": scenarios, "counters": counters}
    if args.report_json:
        with open(args.report_json, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"[chaos] wrote {args.report_json}")
    if failed:
        print("[chaos] FAIL: at least one scenario broke the recovery "
              "contract", file=sys.stderr)
        return 1
    print(f"[chaos] ok: {len(scenarios)} scenarios, counters={counters}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
