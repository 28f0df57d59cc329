"""Request lifecycle of the port's serving engine on the CPU, case by case
after the reference's ``tests/test_faults.py`` (deadlines, lockstep
cancel, containment that halts, the admit-reject fault site),
``tests/test_engine.py`` (max_new 1, streaming, the report's latency
families), ``tests/test_paged.py`` (oversized requests, sampling outside
paged mode) and ``tests/test_prefix.py`` (the page pool under random
share/COW/publish/free sequences, a cancel mid-prefill).

Every engine names its mode: the port's ``EngineConfig`` defaults to
``"paged"``, the reference's to ``"continuous"``.  Where a case compares
tokens, the port's tokens are also held to the JAX package's engine on
the same weights (the JAX engine's numpy parameters, carried across by
``params_from_numpy``).
"""
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.engine import (EngineConfig, PagedKVPool,  # noqa: E402
                                       ServeEngine, _percentile)
from repro_torch.launch.faults import FaultInjector  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

CFG = get_config("deepseek-7b").reduced()
JCFG = j_get_config("deepseek-7b").reduced()


def _prompt(rng, n):
    return rng.integers(0, CFG.vocab, size=(n,)).astype(np.int32)


def _engine(mode, slots=2, max_len=16, faults=None, params=None, **kw):
    if mode == "paged":
        kw.setdefault("page_size", 4)
        kw.setdefault("chunk_steps", 3)
    return ServeEngine(CFG, EngineConfig(
        mode=mode, slots=slots, max_len=max_len, seed=0, device="cpu",
        params=params, **kw), faults=faults)


def _pair(mode, slots=2, max_len=16, **kw):
    """A JAX engine and a port engine of one mode and shape, the port's
    on the JAX engine's weights."""
    if mode == "paged":
        kw.setdefault("page_size", 4)
        kw.setdefault("chunk_steps", 3)
    jeng = JServeEngine(JCFG, slots=slots, max_len=max_len, mode=mode,
                        seed=0, **kw)
    teng = ServeEngine(CFG, EngineConfig(
        mode=mode, slots=slots, max_len=max_len, seed=0, device="cpu",
        params=params_from_numpy(jeng.params, "cpu"), **kw))
    return jeng, teng


def _tokens(rep, rid):
    return [int(t) for t in rep.results[rid]]


# -- deadlines (test_faults.py) ------------------------------------------------
def test_deadline_expires_in_queue():
    rng = np.random.default_rng(4)
    eng = _engine("paged", slots=1)
    rid = eng.submit(_prompt(rng, 4), 6, deadline_s=1e-6)
    time.sleep(0.01)
    rep = eng.run()
    assert rep.statuses[rid] == "deadline_exceeded"
    assert "before admission" in rep.errors[rid]
    assert len(rep.results[rid]) == 0
    assert rep.counters["deadline_exceeded"] == 1
    assert eng.pool.pages_in_use == 0


def test_deadline_expires_mid_flight_keeps_tokens():
    rng = np.random.default_rng(5)
    eng = _engine("paged", slots=1, max_len=40, chunk_steps=1)
    rid = eng.submit(_prompt(rng, 4), 32)
    eng.step()
    got = len(eng._requests[rid].tokens)
    assert got > 0
    eng._requests[rid].deadline = 0.0  # expire it, deterministically
    eng.step()
    req = eng._requests[rid]
    assert req.status == "deadline_exceeded" and req.slot is None
    assert len(req.tokens) >= got
    assert eng.pool.pages_in_use == 0 and eng.pool.verify() == []
    rep = eng.run()
    assert rep.counters["deadline_exceeded"] == 1
    assert "after" in rep.errors[rid]


def test_deadline_validation():
    rng = np.random.default_rng(6)
    eng = _engine("paged")
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(_prompt(rng, 4), 4, deadline_s=0)
    with pytest.raises(ValueError, match="deadline_s"):
        eng.check_request(4, 4, deadline_s=-2)


# -- cancel, containment, admission faults (test_faults.py) --------------------
def test_lockstep_cancel_reaches_only_queued_requests():
    rng = np.random.default_rng(3)
    pa, pb = _prompt(rng, 4), _prompt(rng, 4)
    jeng, eng = _pair("lockstep", max_len=12)
    ra = eng.submit(pa, 4)
    rb = eng.submit(pb, 4)
    assert eng.cancel(rb) is True  # still queued: cancellable
    rep = eng.run()
    assert rep.statuses == {ra: "completed", rb: "cancelled"}
    assert eng.cancel(ra) is False  # already ran to completion
    ja = jeng.submit(pa, 4)
    jeng.cancel(jeng.submit(pb, 4))
    assert _tokens(rep, ra) == _tokens(jeng.run(), ja)


def test_containment_failure_halts_engine(monkeypatch):
    """If even re-arming the pool fails, the engine halts: submit and
    step refuse instead of serving from unknown state."""
    rng = np.random.default_rng(9)
    eng = _engine("paged", faults=FaultInjector("dispatch.raise=after:1"))
    ra = eng.submit(_prompt(rng, 4), 6)

    def boom(*a, **kw):
        raise RuntimeError("no memory")
    monkeypatch.setattr(eng.pool, "reset_buffers", boom)
    monkeypatch.setattr(eng.pool, "rebuild", boom)
    eng.step()
    assert eng.health == "halted"
    assert eng._requests[ra].status == "failed"
    with pytest.raises(RuntimeError, match="halted"):
        eng.submit(_prompt(rng, 4), 4)
    with pytest.raises(RuntimeError, match="halted"):
        eng.step()
    rb_missing = eng.run()  # report still works; queue already empty
    assert rb_missing.health == "halted"


def test_admit_reject_site_gates_can_admit():
    eng = _engine("paged", faults=FaultInjector("admit.reject=first:1"))
    assert eng.can_admit(4, 4) is False   # injected rejection
    assert eng.can_admit(4, 4) is True    # back to normal
    stats = eng.faults.stats()["admit.reject"]
    assert stats == {"calls": 2, "fired": 1}


# -- the engine's reports (test_engine.py) -------------------------------------
def test_max_new_one_finishes_at_prefill():
    rng = np.random.default_rng(2)
    prompt = _prompt(rng, 4)
    jeng, eng = _pair("continuous", slots=1, max_len=8)
    rid = eng.submit(prompt, 1)
    rep = eng.run()
    assert len(rep.results[rid]) == 1
    assert rep.pool.allocs == 1 and rep.pool.frees == 1
    jid = jeng.submit(prompt, 1)
    assert _tokens(rep, rid) == _tokens(jeng.run(), jid)


def test_streaming_and_report_stats():
    slots, P, G = 2, 5, 6
    rng = np.random.default_rng(0)
    prompts = [_prompt(rng, P) for _ in range(3)]
    jeng, eng = _pair("continuous", slots=slots, max_len=P + G)
    rids = [eng.submit(p, G) for p in prompts]
    seen = {rid: [] for rid in rids}
    for rid, tok in eng.stream():
        seen[rid].append(tok)
    rep = eng.run()  # already drained: no-op, report only
    for rid in rids:
        assert seen[rid] == list(rep.results[rid])
        assert len(seen[rid]) == G
    assert rep.generated_tokens == 3 * G
    assert rep.pool.occupancy == 0.0
    assert rep.pool.decode_arena_bytes > 0
    jids = [jeng.submit(p, G) for p in prompts]
    jrep = jeng.run()
    assert [seen[r] for r in rids] == [_tokens(jrep, j) for j in jids]


def test_report_separates_ttft_from_per_token_latency():
    """TTFT anchors at prefill return (one sample per request); per-token
    latency is per decode step -- the report must carry both families."""
    rng = np.random.default_rng(4)
    for mode in ("continuous", "lockstep"):
        eng = _engine(mode, slots=2, max_len=10)
        for _ in range(2):
            eng.submit(_prompt(rng, 4), 6)
        rep = eng.run()
        assert rep.ttft_p50_ms > 0, mode
        assert rep.ttft_p95_ms >= rep.ttft_p50_ms, mode
        assert rep.p95_ms >= rep.p50_ms > 0, mode
    # a request that finishes entirely at prefill still has a TTFT
    eng = _engine("continuous", slots=1, max_len=8)
    eng.submit(_prompt(rng, 4), 1)
    assert eng.run().ttft_p50_ms > 0
    assert _percentile([], 50) == 0.0 and _percentile([7.0], 95) == 7.0


# -- paged admission and sampling (test_paged.py) ------------------------------
def test_oversized_request_rejected_at_submit():
    """A request needing more pages than the (user-shrunk) pool holds
    can never be admitted -- it must be rejected at submit, not spin the
    scheduler forever."""
    jeng, eng = _pair("paged", max_len=32, page_size=8, chunk_steps=2,
                      pages=4)  # 3 usable
    with pytest.raises(ValueError, match="never be admitted"):
        eng.submit(np.zeros(10, np.int32), 22)  # needs 4 pages
    rid = eng.submit(np.zeros(4, np.int32), 4)  # 1 page: fine
    rep = eng.run()
    assert len(rep.results[rid]) == 4
    jid = jeng.submit(np.zeros(4, np.int32), 4)
    assert _tokens(rep, rid) == _tokens(jeng.run(), jid)


def test_sampling_rejected_outside_paged_mode():
    eng = _engine("continuous", slots=1, max_len=8)
    with pytest.raises(ValueError, match="paged"):
        eng.submit(np.zeros(2, np.int32), 2, temperature=0.7)
    # paged-only constructor knobs are never silently ignored either
    with pytest.raises(ValueError, match="mode='paged'"):
        _engine("continuous", slots=1, max_len=8, page_size=4)
    with pytest.raises(ValueError, match="mode='paged'"):
        _engine("donated", slots=1, max_len=8, pages=4)
    peng = _engine("paged", slots=1, max_len=8, chunk_steps=2)
    with pytest.raises(ValueError):
        peng.submit(np.zeros(2, np.int32), 2, temperature=-0.1)
    with pytest.raises(ValueError):
        peng.submit(np.zeros(2, np.int32), 2, top_k=-1)
    # keys hash through f32 (exact to 2^24): out-of-range keys would
    # silently collide, so they are rejected loudly
    with pytest.raises(ValueError, match="2\\^24"):
        peng.submit(np.zeros(2, np.int32), 2, key=1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        peng.submit(np.zeros(2, np.int32), 2, key=-1)


# -- prefix sharing (test_prefix.py) -------------------------------------------
class _T:
    """Stand-in for a compiled input type (shape/dtype/nbytes)."""

    def __init__(self, shape, dtype="float32"):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize


def _refs_match_tables(pool) -> None:
    """Per-page refcounts must equal the live page-table references."""
    held = Counter(pid for pages in pool._slot_pages for pid in pages)
    assert dict(pool._page_refs) == dict(held)
    # and the visible table agrees with the internal page lists
    for slot, pages in enumerate(pool._slot_pages):
        assert list(pool.page_table[slot, :len(pages)]) == pages


def test_prefix_pool_property_random_sequences():
    """Random admit/advance/free sequences over prompts with shared
    prefixes: the exact-accounting invariant (``verify()`` empty) and
    the refcount == live-references identity hold after every single
    pool operation, and the pool drains to zero.  The pool's buffers
    are torch tensors; the copy-on-write copies run on them."""
    rng = np.random.default_rng(42)
    ps = 4
    common = rng.integers(0, CFG.vocab, size=(8,)).astype(np.int32)
    family = [
        common.copy(),                                            # exact
        np.concatenate([common,
                        rng.integers(0, CFG.vocab, size=(3,))]).astype(
                            np.int32),                            # extends
        np.concatenate([common,
                        rng.integers(0, CFG.vocab, size=(6,))]).astype(
                            np.int32),                            # extends
        rng.integers(0, CFG.vocab, size=(7,)).astype(np.int32),   # unrelated
    ]
    pool = PagedKVPool(["k", "v"], [_T((2, 25, 1, ps, 2))] * 2,
                       slots=3, page_size=ps, max_pages=6, device="cpu")
    assert all(isinstance(b, torch.Tensor) for b in pool.buffers)
    live = {}  # slot -> dict(prompt, pos, total, published)

    def _check():
        assert pool.verify() == []
        _refs_match_tables(pool)

    for _ in range(400):
        op = rng.choice(["admit", "advance", "advance", "free"])
        if op == "admit" and len(live) < pool.slots:
            prompt = family[rng.integers(len(family))]
            total = len(prompt) + int(rng.integers(1, 9))
            covered, reusable = pool.probe_shared(prompt)
            if not pool.can_admit(total, shared_pages=reusable):
                continue
            slot = pool.alloc(total, shared_pages=reusable)
            covered = pool.share_prefix(slot, prompt)
            live[slot] = dict(prompt=prompt,
                              pos=min(covered, len(prompt) - 1),
                              total=total, published=False)
            _check()
        elif op == "advance" and live:
            slot = int(rng.choice(sorted(live)))
            st = live[slot]
            hi = min(st["pos"] + int(rng.integers(1, 5)), st["total"])
            if hi <= st["pos"]:
                continue
            pool.ensure_pages(slot, hi - 1)
            _check()
            pool.prepare_writes(slot, st["pos"], hi - 1)
            pool.note_used(slot, hi)
            st["pos"] = hi
            _check()
            if st["pos"] >= len(st["prompt"]) and not st["published"]:
                pool.publish_prefix(slot, st["prompt"])
                st["published"] = True
                _check()
        elif op == "free" and live:
            slot = int(rng.choice(sorted(live)))
            pool.free(slot)
            del live[slot]
            _check()
    for slot in sorted(live):
        pool.free(slot)
        _check()
    p = pool.stats()
    assert p.pages_in_use == 0 and p.active == 0
    assert p.page_allocs == p.page_frees
    assert p.ref_allocs == p.ref_frees
    assert p.shared_attaches > 0 and p.cow_copies > 0, \
        "the prompt family must actually exercise sharing and COW"


def test_cancel_mid_prefill_releases_shared_pages():
    """A sharer cancelled mid-prefill-chunk (holding attached prefix
    pages) must decrement refcounts exactly once; the publisher keeps
    decoding, equal to the request alone here and on the JAX engine, and
    every page returns on drain."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, CFG.vocab, size=(8,)).astype(np.int32)
    longp = np.concatenate(
        [base, rng.integers(0, CFG.vocab, size=(8,)).astype(np.int32)])
    knobs = dict(max_len=24, page_size=4, prefill_chunk=4)
    jsolo, solo = _pair("paged", **knobs)
    rid = solo.submit(base, 8)
    ref = _tokens(solo.run(), rid)
    jid = jsolo.submit(base, 8)
    assert ref == _tokens(jsolo.run(), jid)

    eng = _engine("paged", params=solo._param_map, **knobs)
    rp = eng.submit(base, 8)
    rl = eng.submit(longp, 4)
    for _ in range(3):  # publisher prefills + publishes; sharer attaches
        eng.step()
    req = eng._requests[rl]
    assert req.prefill_pos is not None, "sharer must be mid-prefill"
    assert eng.pool.stats().shared_attaches >= 2
    assert eng.cancel(rl, "test") is True
    eng.step()
    rep = eng.run()
    assert rep.statuses[rl] == "cancelled"
    assert _tokens(rep, rp) == ref
    p = rep.pool
    assert p.pages_in_use == 0 and p.ref_allocs == p.ref_frees
    assert p.page_allocs == p.page_frees
    assert eng.pool.verify() == []
