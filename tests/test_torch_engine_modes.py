"""The port's lockstep, donated and continuous engine modes (and paged
with a dense prefill) on the CPU, against the JAX package's engine.

The config is reduced deepseek-7b with d_head 128, so that at O2 both
packages take their flash-attention kernel: JAX its Pallas kernel in
interpret mode, the port its kernel's plain version (CPU tensors).
Prompts stay at 128 tokens or fewer and max_len at 128 or below, so the
reference's tiling predicate takes the shapes too.  Weights are the JAX
engine's numpy parameters carried across by name (``params_from_numpy``).

Against JAX: greedy tokens identical in every mode, at O1 and O2, in
f32 and bf16.  In bf16 the two packages' logits differ by about one
bf16 ulp (summation order, ``exp``; ROADMAP queue 3), which flips a
greedy choice only where the top two logits are that close: the bf16
cases hold on the prompts of seed 2 (seeds 0 and 1 each flip one late
lockstep/donated token at O2).

Within the port, bitwise: donated == lockstep, a continuous request
among ragged late admissions == the request alone, and a reused
``KVCachePool`` slot leaks nothing into its next request.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import CompileOptions as JOptions  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402

from repro_torch.backend import CompileOptions  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.engine import (EngineConfig, KVCachePool,  # noqa: E402
                                       ServeEngine)
from repro_torch.models.weights import params_from_numpy  # noqa: E402

WIDTHS = dict(d_model=256, n_heads=2, n_kv_heads=2, d_head=128, d_ff=256)
SLOTS, MAX_LEN, MAX_NEW = 2, 32, 8


def _cfg(get, dtype):
    return dataclasses.replace(get("deepseek-7b").reduced(**WIDTHS),
                               compute_dtype=dtype)


def _prompts(mode, vocab, seed=0):
    rng = np.random.default_rng(seed)
    # lockstep/donated admit one batch of uniform prompts; continuous
    # and paged take ragged ones, more than there are slots
    lengths = (16, 16) if mode in ("lockstep", "donated") else (5, 16, 11)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _options(pkg, level):
    if pkg == "jax":
        return JOptions(level=level, use_pallas=level == "O2",
                        interpret_pallas=True)
    return CompileOptions(level=level, use_pallas=level == "O2")


def _knobs(mode):
    return dict(prefill_chunk=0) if mode == "paged" else {}


def _run(eng, prompts):
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    rep = eng.run()
    assert all(rep.statuses[r] == "completed" for r in rids), rep.statuses
    return [rep.results[r].tolist() for r in rids], rep


CASES = [(m, lvl, dt) for m in ("lockstep", "donated", "continuous")
         for lvl in ("O1", "O2") for dt in ("f32", "bf16")] + \
    [("paged", "O2", "f32"), ("paged", "O2", "bf16")]


@pytest.mark.parametrize("mode,level,dtype", CASES)
def test_mode_matches_jax(mode, level, dtype):
    jcfg, tcfg = _cfg(j_get_config, dtype), _cfg(get_config, dtype)
    prompts = _prompts(mode, jcfg.vocab, seed=2)
    jeng = JServeEngine(jcfg, mode=mode, slots=SLOTS, max_len=MAX_LEN,
                        options=_options("jax", level), **_knobs(mode))
    jtoks, _ = _run(jeng, prompts)
    params = params_from_numpy(jeng.params, "cpu")
    teng = ServeEngine(tcfg, EngineConfig(
        mode=mode, slots=SLOTS, max_len=MAX_LEN, device="cpu",
        params=params, **_knobs(mode)), options=_options("torch", level))
    # the carried-across weights are the engine's, by name, uncopied
    assert teng._param_map.keys() <= params.keys()
    assert all(teng._param_map[n] is params[n] for n in teng._param_map)
    ttoks, trep = _run(teng, prompts)
    assert ttoks == jtoks
    if mode == "continuous":
        assert trep.late_admissions >= 1
        assert teng.pool.verify() == [] and trep.pool.active == 0
    if mode == "paged":
        assert teng.prefill_chunk == 0 and trep.pool.pages_in_use == 0


def _engine(mode, level="O2", dtype="bf16", slots=SLOTS, max_len=MAX_LEN):
    return ServeEngine(_cfg(get_config, dtype), EngineConfig(
        mode=mode, slots=slots, max_len=max_len, device="cpu",
        **_knobs(mode)), options=_options("torch", level))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_donated_equals_lockstep_bitwise(level, dtype):
    prompts = _prompts("donated", 257, seed=3)
    lock, lrep = _run(_engine("lockstep", level, dtype), prompts)
    don, drep = _run(_engine("donated", level, dtype), prompts)
    assert lock == don
    assert all(len(t) == MAX_NEW for t in don)
    # lockstep steps once per token, donated dispatches one fused chunk
    assert lrep.steps == MAX_NEW - 1 and drep.steps == 1
    assert lrep.pool is None and drep.pool is None


def test_continuous_ragged_late_admissions_equal_alone():
    rng = np.random.default_rng(7)
    workload = [(rng.integers(0, 257, p).astype(np.int32), g)
                for p, g in [(4, 6), (6, 9), (8, 5), (5, 12), (7, 7), (9, 4)]]
    eng = _engine("continuous", slots=4, max_len=24)
    rids = [eng.submit(p, g) for p, g in workload]
    rep = eng.run()
    assert rep.late_admissions >= 2
    for rid, (prompt, g) in zip(rids, workload):
        assert len(rep.results[rid]) == g
        alone = _engine("continuous", slots=4, max_len=24)
        arid = alone.submit(prompt, g)
        np.testing.assert_array_equal(alone.run().results[arid],
                                      rep.results[rid])


def test_kv_pool_slot_reuse_leaks_nothing():
    """Two requests through a 1-slot pool: the second reuses the first
    one's cache rows without re-zeroing, and still matches a fresh
    engine; the pool's accounting verifies clean throughout."""
    rng = np.random.default_rng(11)
    pa, pb = (rng.integers(0, 257, n).astype(np.int32) for n in (6, 9))
    eng = _engine("continuous", slots=1, max_len=16)
    assert isinstance(eng.pool, KVCachePool)
    ra, rb = eng.submit(pa, 8), eng.submit(pb, 5)
    rep = eng.run()
    p = rep.pool
    assert (p.allocs, p.frees, p.active, p.peak_active) == (2, 2, 0, 1)
    assert p.total_bytes > 0 and p.bytes_per_slot == p.total_bytes
    assert eng.pool.verify() == []
    for prompt, n, rid in ((pb, 5, rb), (pa, 8, ra)):
        fresh = _engine("continuous", slots=1, max_len=16)
        fid = fresh.submit(prompt, n)
        np.testing.assert_array_equal(fresh.run().results[fid],
                                      rep.results[rid])
    with pytest.raises(ValueError, match="double free"):
        eng.pool.free(0)
    with pytest.raises(ValueError, match="out-of-range"):
        eng.pool.free(1)
    assert eng.pool.verify() == []


def test_mode_specific_surfaces():
    cont = _engine("continuous")
    assert cont.can_admit(4, 4)
    with pytest.raises(ValueError, match="stochastic"):
        cont.submit(np.zeros(4, np.int32), 4, temperature=0.5)
    lock = _engine("lockstep")
    with pytest.raises(RuntimeError, match="continuous/paged"):
        lock.can_admit(4, 4)
    with pytest.raises(RuntimeError, match="continuous/paged"):
        lock.step()
    # lockstep/donated admit one batch of uniform prompts, up to the slots
    lock.submit(np.zeros(4, np.int32), 4)
    lock.submit(np.zeros(5, np.int32), 4)
    with pytest.raises(ValueError, match="uniform prompt lengths"):
        lock.run()
    # a failed dispatch fails the batch and leaves the engine serving
    from repro_torch.launch.faults import FaultInjector
    don = ServeEngine(_cfg(get_config, "bf16"), EngineConfig(
        mode="donated", slots=SLOTS, max_len=MAX_LEN, device="cpu"),
        options=_options("torch", "O2"),
        faults=FaultInjector("dispatch.raise=first:1"))
    prompts = _prompts("donated", 257)
    rids = [don.submit(p, 4) for p in prompts]
    assert don.cancel(rids[1]) and don.cancel(rids[1]) is False
    rep = don.run()
    assert rep.statuses == {rids[0]: "failed", rids[1]: "cancelled"}
    assert rep.health == "degraded" and rep.counters["engine_errors"] == 1
    again = don.submit(prompts[0], 4)
    assert don.run().statuses[again] == "completed"


# -- seeds 0 and 1: a bf16 token may differ from JAX only at a tie ------------
def _ulp(x: float) -> float:
    """One bf16 unit in the last place at the magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(max(abs(float(x)), 2.0 ** -14))) - 7)


def _prefill_logits(cfg, params, level, tokens):
    """The port's next-token logits after ``tokens`` from the dense (1, P)
    prefill graph on the CPU, as f32."""
    from repro_torch.backend import Backend
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.lm import build_graphs
    P = len(tokens)
    g = build_graphs(cfg, ShapeConfig("prefill", "prefill", P, 1), 1)
    cf = Backend.create("torch", device="cpu").compile(
        g.fn, _options("torch", level))
    outs = cf(np.asarray(tokens, np.int32).reshape(1, P),
              *[params[n] for n in g.builder.param_names()])
    return np.asarray(outs[0], np.float32).reshape(-1)


def _divergence_witness(cfg, params, level, prompts, jtoks, ttoks):
    """For each request whose port tokens differ from JAX's: the first
    step that differs, and that step's logits from a dense prefill of
    the prompt plus the tokens both agree on -- the port's top two and
    their gap in bf16 units in the last place (``chip_smoke.py``'s
    witness, with the JAX engine in the place of the card)."""
    found = []
    for r, (jt, tt) in enumerate(zip(jtoks, ttoks)):
        differ = [i for i, (a, b) in enumerate(zip(jt, tt)) if a != b]
        if not differ:
            continue
        j = differ[0]
        seq = np.concatenate([prompts[r], np.asarray(jt[:j], np.int32)])
        lg = _prefill_logits(cfg, params, level, seq)
        a, b = (int(t) for t in np.argsort(-lg, kind="stable")[:2])
        found.append({"request": r, "step": j, "jax_token": jt[j],
                      "port_token": tt[j], "top2": [a, b],
                      "gap_ulps": float(lg[a] - lg[b]) / _ulp(lg[a])})
    return found


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode,level,dtype", CASES)
def test_mode_matches_jax_up_to_bf16_ties(mode, level, dtype, seed):
    """Seeds 0 and 1 (seed 2 is ``test_mode_matches_jax``): f32 tokens
    identical to JAX's; a bf16 token may differ only where a witness
    shows the port's top two logits within one bf16 unit of each other,
    the two packages' picks being those two."""
    jcfg, tcfg = _cfg(j_get_config, dtype), _cfg(get_config, dtype)
    prompts = _prompts(mode, jcfg.vocab, seed=seed)
    jeng = JServeEngine(jcfg, mode=mode, slots=SLOTS, max_len=MAX_LEN,
                        options=_options("jax", level), **_knobs(mode))
    jtoks, _ = _run(jeng, prompts)
    params = params_from_numpy(jeng.params, "cpu")
    teng = ServeEngine(tcfg, EngineConfig(
        mode=mode, slots=SLOTS, max_len=MAX_LEN, device="cpu",
        params=params, **_knobs(mode)), options=_options("torch", level))
    ttoks, _ = _run(teng, prompts)
    if dtype == "f32":
        assert ttoks == jtoks
        return
    for w in _divergence_witness(tcfg, params, level, prompts, jtoks,
                                 ttoks):
        assert w["gap_ulps"] <= 1, w
        assert {w["jax_token"], w["port_token"]} == set(w["top2"]), w
