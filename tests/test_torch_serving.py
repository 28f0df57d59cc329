"""The port's paged serving engine on the CPU, at reduced deepseek-7b.

Against the JAX package: ``repro_torch`` ``ServeEngine(mode="paged")``
at O1 and at O2 with the kernel-selection points on gives the same
greedy tokens as ``repro.launch.engine.ServeEngine(mode="paged")`` on
the same (carried-across) weights, in f32 and bf16 compute.  Within the
port, bitwise: prefix sharing on == off, chunked prefill == dense
prefill, a request alone == the same request batched.  And the page pool
drains clean after a run and after a storm of cancellations.
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
from repro_torch.launch.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.models.weights import params_from_numpy  # noqa: E402

ENGINE = dict(mode="paged", slots=2, max_len=48, page_size=4, chunk_steps=3)
MAX_NEW = 7


def _cfg(get, dtype="bf16"):
    return dataclasses.replace(get("deepseek-7b").reduced(),
                               compute_dtype=dtype)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ps = [rng.integers(0, vocab, n).astype(np.int32)
          for n in (5, 11, 17, 9, 14)]
    ps[3][:8] = ps[2][:8]          # two full shared pages (page_size 4)
    ps[4][:12] = ps[1][:11].tolist() + [3]
    return ps


def _options(level):
    return CompileOptions(level=level, use_pallas=level == "O2")


def _serve(engine, prompts, max_new=MAX_NEW):
    rids = [engine.submit(p, max_new) for p in prompts]
    rep = engine.run()
    assert all(rep.statuses[r] == "completed" for r in rids), rep.statuses
    assert rep.pool.pages_in_use == 0
    assert engine.pool.verify() == []
    return [rep.results[r].tolist() for r in rids], rep


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_paged_engine_matches_jax(level, dtype):
    jcfg, tcfg = _cfg(j_get_config, dtype), _cfg(get_config, dtype)
    prompts = _prompts(jcfg.vocab)
    jeng = JServeEngine(jcfg, **ENGINE, options=JOptions(
        level=level, use_pallas=level == "O2", interpret_pallas=True))
    jtoks = [jeng.submit(p, MAX_NEW) for p in prompts]
    jrep = jeng.run()
    jtoks = [jrep.results[r].tolist() for r in jtoks]
    teng = ServeEngine(tcfg, EngineConfig(
        device="cpu", params=params_from_numpy(jeng.params, "cpu"), **ENGINE),
        options=_options(level))
    ttoks, trep = _serve(teng, prompts)
    assert ttoks == jtoks
    assert trep.pool.shared_attaches == jrep.pool.shared_attaches > 0
    assert trep.pool.cow_copies == jrep.pool.cow_copies


def _engine(level="O2", **over):
    kw = dict(ENGINE, device="cpu")
    kw.update(over)
    return ServeEngine(_cfg(get_config), EngineConfig(**kw),
                       options=_options(level))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_prefix_sharing_on_equals_off(level):
    prompts = _prompts(257)
    on, rep_on = _serve(_engine(level, prefix_sharing=True), prompts)
    off, rep_off = _serve(_engine(level, prefix_sharing=False), prompts)
    assert on == off
    assert rep_on.pool.shared_attaches > 0 == rep_off.pool.shared_attaches


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_chunked_prefill_equals_dense_prefill(level):
    prompts = _prompts(257, seed=1)
    runs = {c: _serve(_engine(level, prefill_chunk=c), prompts)[0]
            for c in (0, 8, 16)}
    assert runs[0] == runs[8] == runs[16]


def test_request_alone_equals_batched():
    prompts = _prompts(257, seed=2)
    batched, _ = _serve(_engine(slots=3), prompts)
    for p, toks in zip(prompts, batched):
        alone, _ = _serve(_engine(slots=3), [p])
        assert alone[0] == toks


def test_pool_drains_after_a_cancel_storm():
    eng = _engine(slots=2, pages=13)
    prompts = _prompts(257, seed=3) * 2
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    eng.step()
    eng.step()
    for r in rids[::2]:
        eng.cancel(r, "storm")
    rep = eng.run()
    statuses = set(rep.statuses.values())
    assert statuses <= {"completed", "cancelled"} and "cancelled" in statuses
    assert rep.counters["cancelled"] == sum(
        s == "cancelled" for s in rep.statuses.values())
    assert rep.pool.pages_in_use == 0
    assert eng.pool.verify() == []
    # the pool still serves after the storm, token-identical to a fresh one
    again, _ = _serve(eng, prompts[:2])
    fresh, _ = _serve(_engine(slots=2, pages=13), prompts[:2])
    assert again == fresh


def test_engine_config_refuses_later_slices():
    """Every serving mode is ported, and tensor-parallel serving with
    them: tp > 1 is accepted in paged mode and refused in the others
    with the reference's message (``tests/test_torch_tp.py`` serves it)."""
    for mode in ("lockstep", "donated", "continuous", "paged"):
        assert EngineConfig(mode=mode).mode == mode
        if mode == "paged":
            assert EngineConfig(mode=mode, tp=2).tp == 2
            continue
        with pytest.raises(ValueError, match="it needs mode='paged'"):
            EngineConfig(mode=mode, tp=2)
    with pytest.raises(ValueError, match="need mode='paged'"):
        EngineConfig(mode="continuous", prefill_chunk=0)
    with pytest.raises(ValueError, match="mode must be one of"):
        EngineConfig(mode="warp")
    assert EngineConfig().backend == "torch"
    assert EngineConfig().mode == "paged"


def test_device_init_uses_the_builders_distributions():
    from repro_torch.models.lm import build_dense_chunk
    from repro_torch.models.weights import init_params_on_device
    cfg = _cfg(get_config)
    b = build_dense_chunk(cfg, 48, 2, 3, page_size=4).builder
    ref = b.init_params(0)
    got = init_params_on_device(b, 0, "cpu")
    assert set(got) == set(ref)
    for name, arr in ref.items():
        t = got[name]
        assert tuple(t.shape) == arr.shape and str(t.dtype) == "torch.float32"
        if arr.std() == 0:          # ones / zeros initializers
            assert np.array_equal(t.numpy(), arr), name
        else:                       # normal / fan-in: same spread
            assert abs(float(t.std()) / float(arr.std()) - 1) < 0.2, name
    again = init_params_on_device(b, 0, "cpu")
    assert all(torch.equal(got[n], again[n]) for n in got)


def test_serve_cli_runs_the_paged_engine_on_cpu(tmp_path, capsys):
    import json
    from repro_torch.launch import serve
    out = tmp_path / "report.json"
    assert serve.main(["--reduced", "--device", "cpu", "--mode", "paged",
                       "--level", "O2",
                       "--kernels", "--requests", "3", "--prompt-len", "9",
                       "--gen", "12", "--shared-prefix-len", "8", "--smoke",
                       "--report-json", str(out)]) == 0
    assert "[smoke] ok" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert doc["pool_verify"] == [] and len(doc["results"]) == 3
    assert doc["pool"]["shared_attaches"] > 0


def test_stochastic_rows_are_reproducible_and_keyed():
    """Sampled rows need not match JAX token for token (the key hash runs
    through sin), but within the port the same key gives the same
    stream, whatever else is batched beside it."""
    prompts = _prompts(257, seed=4)[:3]

    def run(keys, batch):
        eng = _engine()
        rids = [eng.submit(p, MAX_NEW, temperature=0.8, top_k=20, key=k)
                for p, k in zip(prompts[:batch], keys)]
        rep = eng.run()
        return [rep.results[r].tolist() for r in rids]

    first = run([5, 6, 7], 3)
    assert first == run([5, 6, 7], 3)
    assert run([5], 1)[0] == first[0]
    assert run([9, 6, 7], 3)[0] != first[0]


def test_a_failed_dispatch_is_contained():
    from repro_torch.launch.faults import FaultInjector
    eng = ServeEngine(_cfg(get_config), EngineConfig(device="cpu", **ENGINE),
                      options=_options("O2"),
                      faults=FaultInjector("dispatch.raise=first:1"))
    rids = [eng.submit(p, MAX_NEW) for p in _prompts(257, seed=5)[:3]]
    rep = eng.run()
    assert rep.health == "degraded" and rep.counters["engine_errors"] == 1
    assert "failed" in rep.statuses.values()
    assert set(rep.statuses.values()) <= {"failed", "completed"}
    assert all(rep.statuses[r] in ("failed", "completed") for r in rids)
    assert rep.pool.pages_in_use == 0 and eng.pool.verify() == []
