"""The North-star contract paged == continuous, bitwise, within the torch
port (the port of
``tests/test_paged.py::test_paged_greedy_matches_continuous``), and the
same tokens with the dispatch captured as CUDA graphs.

On the CPU: paged greedy output is token-for-token identical to
continuous mode on one ragged workload with late admissions, at two page
sizes and chunk lengths, at O1 and at O2 with the kernel-selection
points on (reduced deepseek-7b, d_head 16).  At d_head 128 with
``prefill_chunk=0``, both modes prefill densely through flash
attention's plain version and must still agree.

On the card (``cuda``-marked, skipped here): the same kind of workload
in lockstep, donated, continuous and paged mode, eager
(``static_jit=False``) and captured (the default; each graph runs eagerly
on its first call, is captured for the tensors of its second and
replayed after), gives bitwise-identical tokens on every run.  Two
engines with different weights in one process each keep theirs, and a
paged pool keeps its tensors through every prefill-chunk length.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backend import CompileOptions  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.engine import EngineConfig, ServeEngine  # noqa: E402

CFG = get_config("deepseek-7b").reduced()
DH128 = dict(d_model=256, n_heads=2, n_kv_heads=2, d_head=128, d_ff=256)
# ragged mixed-length workload on 2 slots: late admissions + slot reuse
WORKLOAD = [(4, 6), (6, 9), (5, 7), (8, 4)]
SLOTS, MAX_LEN = 2, 16


def _prompts(vocab, workload=WORKLOAD, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=(p,)).astype(np.int32), g)
            for p, g in workload]


def _dh128(dtype):
    return dataclasses.replace(get_config("deepseek-7b").reduced(**DH128),
                               compute_dtype=dtype)


def _options(level, **kw):
    return CompileOptions(level=level, use_pallas=level == "O2", **kw)


def _serve(cfg, mode, level, workload, max_len=MAX_LEN, device="cpu",
           options=None, **knobs):
    eng = ServeEngine(cfg, EngineConfig(mode=mode, slots=SLOTS,
                                        max_len=max_len, device=device,
                                        **knobs),
                      options=options or _options(level))
    rids = [eng.submit(p, g) for p, g in workload]
    rep = eng.run()
    assert all(rep.statuses[r] == "completed" for r in rids), rep.errors
    return [rep.results[r].tolist() for r in rids], rep


_CONTINUOUS = {}


def _continuous(level):
    if level not in _CONTINUOUS:
        _CONTINUOUS[level] = _serve(CFG, "continuous", level,
                                    _prompts(CFG.vocab))[0]
    return _CONTINUOUS[level]


@pytest.mark.parametrize("page_size, chunk_steps", [(4, 3), (8, 2)])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_paged_greedy_matches_continuous(level, page_size, chunk_steps):
    """Two page sizes, two chunk lengths: paged greedy output must be
    token-for-token identical to continuous mode on the same ragged
    workload (the pool layout and dispatch granularity are invisible)."""
    got, rep = _serve(CFG, "paged", level, _prompts(CFG.vocab),
                      page_size=page_size, chunk_steps=chunk_steps)
    assert rep.late_admissions >= 1  # 4 requests on 2 slots
    assert rep.pool.pages_in_use == 0
    assert got == _continuous(level)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_dense_prefill_matches_continuous_at_dh128(dtype):
    """d_head 128 at O2: both modes prefill each request densely through
    flash attention (its plain version on the CPU) and decode through
    the composition; the tokens agree bitwise."""
    cfg = _dh128(dtype)
    work = _prompts(cfg.vocab, [(9, 6), (14, 8), (5, 7), (11, 5)], seed=3)
    cont, _ = _serve(cfg, "continuous", "O2", work, max_len=32)
    paged, rep = _serve(cfg, "paged", "O2", work, max_len=32, page_size=8,
                        chunk_steps=3, prefill_chunk=0)
    assert rep.late_admissions >= 1
    assert paged == cont


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA-graph capture and the Hopper "
                    "kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lockstep", "donated", "continuous",
                                  "paged"])
def test_capture_keeps_the_tokens_in_every_mode(cuda_device, mode):
    cfg = _dh128("bf16")
    if mode in ("lockstep", "donated"):   # one batch of uniform prompts
        work = _prompts(cfg.vocab, [(12, 7), (12, 7)], seed=5)
    else:
        work = _prompts(cfg.vocab, [(9, 6), (14, 8), (5, 7), (11, 5)],
                        seed=5)
    knobs = dict(page_size=8, chunk_steps=3) if mode == "paged" else {}
    eager, _ = _serve(cfg, mode, "O2", work, max_len=32, device="cuda",
                      options=_options("O2", static_jit=False), **knobs)
    # run 1 runs each graph eagerly, run 2 captures, run 3 replays
    for run in range(3):
        got, _ = _serve(cfg, mode, "O2", work, max_len=32, device="cuda",
                        **knobs)
        assert got == eager, f"{mode}: captured run {run}"


def _engine(cfg, seed=0, static_jit=True, **knobs):
    return ServeEngine(cfg, EngineConfig(mode="paged", slots=SLOTS,
                                         max_len=32, device="cuda",
                                         seed=seed, page_size=8,
                                         chunk_steps=3,
                                         prefix_sharing=False, **knobs),
                       options=_options("O2", static_jit=static_jit))


def _run(eng, work):
    rids = [eng.submit(p, g) for p, g in work]
    rep = eng.run()
    assert all(rep.statuses[r] == "completed" for r in rids), rep.errors
    return [rep.results[r].tolist() for r in rids]


def _programs(eng):
    """The engine's compiled functions that capture on the card."""
    cfs = [eng.cf] + [v[1] for v in eng._pf_chunks.values()] + \
        [v[1] for v in eng._prefill.values()]
    return [cf.raw for cf in cfs if hasattr(cf.raw, "captures")]


@pytest.mark.cuda
def test_two_engines_keep_their_own_weights(cuda_device):
    """Two engines in one process share the backend's compiled functions
    but not their weights: serving the second leaves the first one's
    weights and tokens as they were."""
    cfg = _dh128("bf16")
    work = _prompts(cfg.vocab, [(9, 6), (14, 8), (5, 7)], seed=5)
    want = {s: _run(_engine(cfg, s, static_jit=False), work) for s in (0, 1)}
    assert want[0] != want[1]
    first = _engine(cfg, 0)
    kept = [t.clone() for t in first.tparams]
    for _ in range(2):
        assert _run(first, work) == want[0]
    second = _engine(cfg, 1)
    for _ in range(2):
        assert _run(second, work) == want[1]
    assert _run(first, work) == want[0]
    for t, k in zip(first.tparams, kept):
        assert torch.equal(t.view(torch.uint8), k.view(torch.uint8))


@pytest.mark.cuda
def test_pool_keeps_its_tensors_across_prefill_lengths(cuda_device):
    """Prompts whose last prefill chunks take every length from 1 to 4
    (no prefix is shared, so every run cuts them the same way):
    each length's graph binds the pool's own tensors (the eager first
    call writes back in place too), so the pool keeps its addresses and,
    once each graph is captured, no call captures again."""
    cfg = _dh128("bf16")
    work = _prompts(cfg.vocab, [(n, 3) for n in range(5, 13)], seed=6)
    want = _run(_engine(cfg, static_jit=False, prefill_chunk=4), work)
    eng = _engine(cfg, prefill_chunk=4)
    ptrs = [b.data_ptr() for b in eng.pool.buffers]
    for run in range(3):
        before = {id(p): p.captures for p in _programs(eng)}
        assert _run(eng, work) == want, f"run {run}"
        assert [b.data_ptr() for b in eng.pool.buffers] == ptrs
        if run:
            assert {id(p): p.captures for p in _programs(eng)} == before
    assert len(eng._pf_chunks) == 4
    assert all(p.captured for p in _programs(eng))
