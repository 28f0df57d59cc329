"""The autotuner on torch: the cases of ``tests/test_autotune.py`` on the
port's ``"torch"`` backend (on the CPU) -- sweep, record persistence and
reuse with zero re-sweeps, winner no slower than the default, and the
record schema, which the JAX package's ``validate_record`` accepts too.
The tile case becomes "no tile sweep, fields recorded": the Hopper
kernels choose their own tiles, so ``mm_bm/bn/bk`` stay at the
request's values in every candidate.  ``use_pallas`` is never swept
either: a sweep may not give way to the plain versions.  The port's own
cases: a sweep keeps only the winner's compiled function in the
backend's memory, each candidate is called twice (on the card: the eager
first call, then the capture) before it is timed, a sweep skips only a
candidate whose options refuse the shapes, and a kernel that fails in
any candidate fails the compile.
"""
import glob
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import autotune as j_autotune  # noqa: E402
from repro.backend import CompileOptions as JOptions  # noqa: E402

from repro_torch.backend import Backend, CompileOptions  # noqa: E402
from repro_torch.backend import autotune  # noqa: E402
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.function import Function  # noqa: E402


def _torch():
    return Backend.create("torch", fresh=True, device="cpu")


def _attn_graph(S=64, D=32):
    q = ops.parameter((1, 2, S, D), "f32", "q")
    k = ops.parameter((1, 2, S, D), "f32", "k")
    v = ops.parameter((1, 2, S, D), "f32", "v")
    return Function([q, k, v],
                    [ops.attention(q.out(), k.out(), v.out(), causal=True)])


def _plain_graph():
    x = ops.parameter((4, 16), "f32", "x")
    return Function([x], [ops.gelu(x.out())])


def _record(tmp_path):
    [rec_path] = glob.glob(os.path.join(str(tmp_path), "autotune",
                                        "*.tune.json"))
    with open(rec_path) as fh:
        return rec_path, json.load(fh)


def test_sweep_records_winner_and_is_reused(tmp_path, monkeypatch):
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True)
    be = _torch()
    cf = be.compile(_attn_graph(), opts)
    st = be.cache_stats()
    assert st.autotune_sweeps == 1 and st.autotune_hits == 0
    assert cf.options.autotune is False  # resolved, not re-requested

    _, rec = _record(tmp_path)
    assert autotune.validate_record(rec) == []
    # the record schema is the reference's
    assert j_autotune.validate_record(rec) == []
    assert rec["backend"] == "torch"
    assert {c["attn_impl"] for c in rec["candidates"]} >= {"naive", "chunked"}
    # candidate 0 is the static default; the winner can't be slower
    static_ms = rec["candidates"][0]["ms"]
    winner_ms = min(c["ms"] for c in rec["candidates"])
    assert winner_ms <= static_ms

    # a cold process re-resolves from the record: zero sweep timings
    be2 = _torch()

    def boom(*a, **k):
        raise AssertionError("sweep re-ran despite a persisted record")

    monkeypatch.setattr(autotune, "sweep", boom)
    cf2 = be2.compile(_attn_graph(), opts)
    st2 = be2.cache_stats()
    assert st2.autotune_hits == 1 and st2.autotune_sweeps == 0
    assert cf2.options.attn_impl == rec["winner"]["attn_impl"]
    assert cf2.options.attn_chunk == rec["winner"]["attn_chunk"]
    assert cf2.options.use_pallas == rec["winner"]["use_pallas"]


def test_no_attention_graph_skips_the_sweep(tmp_path):
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True)
    be = _torch()
    cf = be.compile(_plain_graph(), opts)
    st = be.cache_stats()
    assert st.autotune_sweeps == 0 and st.autotune_hits == 0
    assert cf.options.attn_impl == CompileOptions().attn_impl
    assert not os.path.isdir(os.path.join(str(tmp_path), "autotune"))


def test_has_attention_recurses_into_scan_bodies():
    inner = _attn_graph(S=8, D=4)
    x = ops.parameter((1, 2, 8, 4), "f32", "x")
    host = Function([x], [ops.gelu(x.out())])
    assert autotune.has_attention(inner)
    assert not autotune.has_attention(host)
    # nested-function attr (how Scan carries its body)
    from repro_torch.core.node import Node, Value
    n = Node("Scan", [x.out()], {"body": inner}, x.out_types)
    fn = Function([x], [Value(n, 0)])
    assert autotune.has_attention(fn)


def test_tuner_without_cache_dir_remembers_in_process(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    opts = CompileOptions(autotune=True)
    be = _torch()
    be.compile(_attn_graph(), opts)
    assert be.cache_stats().autotune_sweeps == 1
    be.clear_cache()  # drop the compiled executables, keep tuner memory
    be.compile(_attn_graph(), opts)
    st = be.cache_stats()
    assert st.autotune_sweeps == 0 and st.autotune_hits == 1


def test_corrupt_tuning_record_triggers_retune(tmp_path):
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True)
    _torch().compile(_attn_graph(), opts)
    rec_path, _ = _record(tmp_path)
    with open(rec_path, "w") as fh:
        fh.write("{torn")
    be2 = _torch()
    be2.compile(_attn_graph(), opts)
    st = be2.cache_stats()
    assert st.autotune_sweeps == 1 and st.autotune_hits == 0
    with open(rec_path) as fh:  # re-recorded valid
        assert autotune.validate_record(json.load(fh)) == []


def test_torn_write_schema_record_is_evicted(tmp_path):
    """A torn write can still decode as JSON but fail the schema; it
    must be evicted (counted like a corrupt compile entry) and re-swept,
    not resurface on every resolve."""
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True)
    _torch().compile(_attn_graph(), opts)
    rec_path, rec = _record(tmp_path)
    del rec["winner"]  # a partial record: valid JSON, invalid schema
    with open(rec_path, "w") as fh:
        json.dump(rec, fh)
    be2 = _torch()
    be2.compile(_attn_graph(), opts)
    st = be2.cache_stats()
    assert st.autotune_sweeps == 1 and st.autotune_hits == 0
    assert st.disk_evictions >= 1
    with open(rec_path) as fh:  # re-recorded valid
        assert autotune.validate_record(json.load(fh)) == []


def test_garbage_winner_values_evicted_instead_of_raising(tmp_path):
    """Schema-valid record whose winner values are garbage (hand edit /
    interleaved torn write): resolution must evict and fall back to a
    fresh sweep, not raise out of compile."""
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True)
    _torch().compile(_attn_graph(), opts)
    rec_path, rec = _record(tmp_path)
    rec["winner"]["attn_impl"] = "bogus"  # passes schema, fails replace()
    with open(rec_path, "w") as fh:
        json.dump(rec, fh)
    be2 = _torch()
    cf = be2.compile(_attn_graph(), opts)  # must not raise
    st = be2.cache_stats()
    assert st.autotune_sweeps == 1 and st.autotune_hits == 0
    assert cf.options.attn_impl != "bogus"
    with open(rec_path) as fh:
        assert json.load(fh)["winner"]["attn_impl"] != "bogus"


def _v2_knobs(**over):
    knobs = {"attn_impl": "naive", "attn_chunk": 256, "use_pallas": False,
             "mm_bm": 256, "mm_bn": 256, "mm_bk": 512,
             "fuse_swiglu": True, "fuse_norm_matmul": True,
             "fuse_rotary_qkv": True}
    knobs.update(over)
    return knobs


def test_validate_record_reports_schema_errors():
    assert autotune.validate_record("nope")
    errs = autotune.validate_record({})
    assert any("missing key 'winner'" in e for e in errs)
    cand = _v2_knobs()  # no ms
    win = _v2_knobs()
    del win["use_pallas"]
    rec = {
        "format": 1, "schema": autotune.SCHEMA, "backend": "torch",
        "signature": "s", "versions": {},
        "candidates": [cand],
        "winner": win,
    }
    errs = autotune.validate_record(rec)
    assert any("candidates[0] missing 'ms'" in e for e in errs)
    assert any("winner missing 'use_pallas'" in e for e in errs)
    rec["candidates"][0]["ms"] = 0.5
    rec["winner"]["use_pallas"] = False
    assert autotune.validate_record(rec) == []
    # v2 records must carry the matmul/fusion knobs too
    del rec["winner"]["mm_bk"]
    assert any("winner missing 'mm_bk'" in e
               for e in autotune.validate_record(rec))


def test_validate_record_refuses_another_schema():
    """No port process writes a record of another schema, so one is
    refused (the reference's v1 records never reach the port: the
    record key folds in the port's identity)."""
    rec = {
        "format": 1, "schema": "repro-autotune-v1", "backend": "torch",
        "signature": "s", "versions": {},
        "candidates": [{**_v2_knobs(), "ms": 0.5}],
        "winner": _v2_knobs(),
    }
    assert any("schema 'repro-autotune-v1'" in e
               for e in autotune.validate_record(rec))
    rec["schema"] = autotune.SCHEMA
    assert autotune.validate_record(rec) == []


def _matmul_graph(M=128, K=256, N=128):
    x = ops.parameter((M, K), "f32", "x")
    w = ops.parameter((K, N), "f32", "w")
    return Function([x, w], [ops.matmul(x.out(), w.out())])


def test_no_tile_sweep_fields_recorded_and_reresolved(tmp_path, monkeypatch):
    """A kernel matmul graph sweeps no tile shapes: every candidate
    records the request's ``mm_bm/bn/bk`` (the record schema stays the
    reference's), the grid is the reference's without its tile
    candidates, and the persisted record re-resolves in a cold process
    with zero sweep timings."""
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True,
                          level="O2", use_pallas=True)
    be = _torch()
    fn = _matmul_graph()
    fams = autotune.tunable_families(fn, opts, be)
    assert fams == {"fusion"}  # no attention; nothing of matmul is swept
    cf = be.compile(fn, opts)
    assert be.cache_stats().autotune_sweeps == 1
    _, rec = _record(tmp_path)
    assert autotune.validate_record(rec) == []
    assert rec["schema"] == autotune.SCHEMA
    tiles = (opts.mm_bm, opts.mm_bn, opts.mm_bk)
    assert {(c["mm_bm"], c["mm_bn"], c["mm_bk"])
            for c in rec["candidates"]} == {tiles}
    assert (rec["winner"]["mm_bm"], rec["winner"]["mm_bn"],
            rec["winner"]["mm_bk"]) == tiles
    assert min(c["ms"] for c in rec["candidates"]) \
        <= rec["candidates"][0]["ms"]
    assert cf.options.mm_bm == opts.mm_bm
    # the grid: the reference's for the same request (whose families add
    # "matmul"), minus its tiles and its use_pallas flip
    ref = [c for c in j_autotune.candidate_grid(
        JOptions(level="O2", use_pallas=True),
        frozenset(fams | {"matmul"}))
        if (c["mm_bm"], c["mm_bn"], c["mm_bk"]) == tiles and c["use_pallas"]]
    assert autotune.candidate_grid(opts, fams) == ref

    be2 = _torch()

    def boom(*a, **k):
        raise AssertionError("sweep re-ran despite a persisted record")

    monkeypatch.setattr(autotune, "sweep", boom)
    be2.compile(fn, opts)
    st = be2.cache_stats()
    assert st.autotune_hits == 1 and st.autotune_sweeps == 0


def test_sweep_drops_losing_candidates_disk_entries(tmp_path):
    """Sweep compiles persist through the normal path, but only the
    winner's entry may stay — losers would squat on LRU budget."""
    from repro_torch.backend.diskcache import DiskCompileCache
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True)
    _torch().compile(_attn_graph(), opts)
    assert DiskCompileCache(str(tmp_path)).stats().entries == 1


def test_sweep_keeps_only_the_winners_compiled_function(tmp_path):
    """After a sweep the losers' compiled functions leave the backend's
    in-memory cache too (on the card each holds CUDA graphs and their
    static outputs); the winner's stays and serves the compile."""
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True)
    be = _torch()
    fn = _attn_graph()
    cf = be.compile(fn, opts)
    _, rec = _record(tmp_path)
    assert len(rec["candidates"]) > 1
    st = be.cache_stats()
    assert st.size == 1
    # the sweep compiled every candidate; the resolve's compile hit the
    # winner's function in memory
    assert st.misses == len(rec["candidates"]) and st.hits == 1
    [(key, kept)] = list(be._cache.items())
    assert kept is cf and key[3] == cf.options.cache_key()


def test_sweep_warms_each_candidate_twice_before_timing(monkeypatch):
    """Each candidate is called SWEEP_WARMUP (2) times untimed -- on the
    card the eager first call, then the capture -- and then SWEEP_REPS
    times timed: a candidate whose first two calls are slow is not
    charged for them."""
    assert autotune.SWEEP_WARMUP == 2
    be = _torch()
    real_compile = be.compile
    calls = []

    class Slow:
        def __init__(self, cf):
            self.cf = cf
            self.n = 0
            calls.append(self)

        def __call__(self, *args):
            self.n += 1
            if self.n <= 2:
                time.sleep(0.2)
            return self.cf(*args)

    monkeypatch.setattr(be, "compile",
                        lambda f, options=None: Slow(real_compile(f, options)))
    result = autotune.sweep(be, _attn_graph(S=8, D=4), CompileOptions())
    assert len(calls) == len(result.candidates) > 1
    assert all(c.n == autotune.SWEEP_WARMUP + autotune.SWEEP_REPS
               for c in calls)
    assert all(c["ms"] < 200 for c in result.candidates)


def test_unstable_options_memoize_the_sweep_in_process(tmp_path):
    """Opaque options (key=None) can't persist a record, but a repeated
    compile in one process must not re-pay the sweep."""
    from repro_torch.core.passes import plan_memory
    plan = plan_memory(_plain_graph())  # opaque object: not process-stable
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True, arena=plan)
    assert opts.stable_token() is None
    be = Backend.create("interpreter", fresh=True)
    be.compile(_attn_graph(S=8, D=4), opts)
    assert be.cache_stats().autotune_sweeps == 1
    be.compile(_attn_graph(S=8, D=4), opts)
    st = be.cache_stats()
    assert st.autotune_sweeps == 1 and st.autotune_hits == 1


def test_sweep_skips_uncompilable_candidates(monkeypatch):
    """A candidate whose options the compile refuses is skipped, not
    fatal — only the static default (candidate 0) is load-bearing."""
    from repro_torch.backend.options import OptionsError
    be = _torch()
    fn = _attn_graph()
    real_compile = be.compile

    def picky(f, options=None):
        if options is not None and options.attn_impl == "chunked":
            raise OptionsError("synthetic reject")
        return real_compile(f, options)

    monkeypatch.setattr(be, "compile", picky)
    result = autotune.sweep(be, fn, CompileOptions())
    impls = {c["attn_impl"] for c in result.candidates}
    assert "chunked" not in impls and "auto" in impls
    assert result.winner["attn_impl"] in impls


def test_sweep_skips_a_chunk_the_kv_length_refuses():
    """A real shape refusal: a KV length of 300 is no multiple of the
    256-key chunk, so that candidate is skipped; the 1024-key chunk
    (cut to the whole length) runs."""
    result = autotune.sweep(_torch(), _attn_graph(S=300, D=4),
                            CompileOptions())
    chunks = {c["attn_chunk"] for c in result.candidates
              if c["attn_impl"] == "chunked"}
    assert chunks == {1024}


def _flash_fails_after(monkeypatch, n_calls):
    """The flash wrapper, failing from its ``n_calls + 1``-th call on."""
    from repro_torch.kernels import flash_attention as k_flash
    real, calls = k_flash.flash_attention, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) > n_calls:
            raise RuntimeError("synthetic kernel failure")
        return real(*a, **k)

    monkeypatch.setattr(k_flash, "flash_attention", flaky)


def test_a_kernel_failure_in_any_candidate_fails_the_compile(monkeypatch):
    """The kernel works for candidate 0 (its two warm-up and three timed
    calls) and then fails: the sweep raises instead of skipping the
    candidate, so no plain candidate can win over a broken kernel."""
    _flash_fails_after(monkeypatch,
                       autotune.SWEEP_WARMUP + autotune.SWEEP_REPS)
    opts = CompileOptions(level="O2", use_pallas=True, autotune=True)
    with pytest.raises(RuntimeError, match="synthetic kernel failure"):
        _torch().compile(_attn_graph(S=64, D=128), opts)


def test_sweep_keeps_the_requests_use_pallas(tmp_path):
    """Every candidate and the winner keep the request's ``use_pallas``;
    it is part of the record key, so a record tuned without the kernels
    never resolves a request with them."""
    fn = _attn_graph(S=64, D=128)
    for use_pallas in (False, True):
        opts = CompileOptions(cache_dir=str(tmp_path), autotune=True,
                              level="O2", use_pallas=use_pallas)
        be = _torch()
        cf = be.compile(fn, opts)
        assert be.cache_stats().autotune_sweeps == 1  # no record shared
        assert cf.options.use_pallas is use_pallas
    recs = [json.load(open(p)) for p in glob.glob(
        os.path.join(str(tmp_path), "autotune", "*.tune.json"))]
    assert len(recs) == 2
    for rec in recs:
        flag = rec["candidates"][0]["use_pallas"]
        assert len(rec["candidates"]) > 1
        assert all(c["use_pallas"] is flag for c in rec["candidates"])
        assert rec["winner"]["use_pallas"] is flag


def test_device_name_keys_the_tuning_record(tmp_path, monkeypatch):
    """A record's timings belong to one product: the torch backend's
    device name is part of the record key, so another card re-tunes."""
    from repro_torch.backend import diskcache
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True)
    fn = _attn_graph(S=8, D=4)
    key = autotune.tune_key(_torch(), fn, opts)
    monkeypatch.setattr(diskcache, "device_name",
                        lambda device: "NVIDIA H100 80GB HBM3")
    assert autotune.tune_key(_torch(), fn, opts) != key


@pytest.mark.cuda
def test_card_sweep_captures_and_keeps_the_winner(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.backend.graphed import GraphedProgram
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True)
    be = Backend.create("torch", fresh=True, device="cuda")
    cf = be.compile(_attn_graph(), opts)
    assert be.cache_stats().size == 1
    assert isinstance(cf.raw, GraphedProgram) and cf.raw.captures == 1
    be2 = Backend.create("torch", fresh=True, device="cuda")
    be2.compile(_attn_graph(), opts)
    assert be2.cache_stats().autotune_sweeps == 0
    args = [np.random.default_rng(0).normal(size=(1, 2, 64, 32))
            .astype(np.float32) for _ in range(3)]
    out = cf(*args)[0]
    assert np.isfinite(out).all()


@pytest.mark.cuda
def test_card_sweep_keeps_the_kernels_and_raises_their_failures(
        tmp_path, monkeypatch):
    """On the card the winner keeps ``use_pallas`` and its flash kernel
    launches; a kernel that fails in a later candidate fails the
    compile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import kernels
    opts = CompileOptions(cache_dir=str(tmp_path), autotune=True,
                          level="O2", use_pallas=True)
    fn = _attn_graph(S=64, D=128)
    cf = Backend.create("torch", fresh=True, device="cuda").compile(fn, opts)
    _, rec = _record(tmp_path)
    assert cf.options.use_pallas is True
    assert all(c["use_pallas"] is True for c in rec["candidates"])
    kernels.reset_counters()
    cf(*[np.random.default_rng(0).normal(size=(1, 2, 64, 128))
         .astype(np.float32) for _ in range(3)])
    assert kernels.counters()["flash_attention"]["launches"] >= 1
    _flash_fails_after(monkeypatch,
                       autotune.SWEEP_WARMUP + autotune.SWEEP_REPS)
    with pytest.raises(RuntimeError, match="synthetic kernel failure"):
        Backend.create("torch", fresh=True, device="cuda").compile(
            fn, opts.replace(cache_dir=None))
