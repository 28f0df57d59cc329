"""Tensor-parallel paged serving on torch: ``EngineConfig(tp=2)`` shards
the paged chunk and prefill graphs and the KV pool's kv_heads dim over
two shards that one process drives (``repro_torch.backend.sharded``).

The contracts of ``tests/test_tp_serving.py`` on reduced deepseek-7b,
here with both shards on the CPU (no subprocess: the port's mesh names
its devices):

  * greedy decode at tp=2 is token-for-token the port's tp=1, in bf16,
    at O1 and at O2 with the kernel-selection points on, and the JAX
    engine's tp=1 in f32;
  * ``kv_bytes_per_device * 2 == pool.total_bytes``; the partition
    stats show AllGathers and no AllReduce; ``live_stats()["tp"] == 2``;
  * prefix sharing, copy-on-write and cancel accounting move at tp=2 as
    at tp=1 and drain to zero.

Besides: the ``EngineConfig`` and engine messages (the reference's, with
``"torch"`` where it names ``"jax"``, and a bare device type naming the
mesh's devices rather than pinning one), the CLI's ``--tp`` and
``[kv-pool:tp]`` line, and the kernels a full-width tp=2 dispatch runs,
walked on the meta device.  On the card (``cuda``-marked, skipped
here): two shards on one card give tp=1's tokens, eagerly and captured.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402

from repro_torch.backend import CompileOptions  # noqa: E402
from repro_torch.backend.sharding import make_mesh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.engine import EngineConfig, ServeEngine  # noqa: E402

CFG = get_config("deepseek-7b").reduced()


def _options(level, **kw):
    return CompileOptions(level=level, use_pallas=level == "O2", **kw)


def _eng(tp, level="O1", cfg=CFG, options=None, **kw):
    base = dict(mode="paged", slots=3, max_len=16, seed=0, page_size=4,
                chunk_steps=2, device="cpu")
    base.update(kw)
    return ServeEngine(cfg, EngineConfig(tp=tp, **base),
                       options=options or _options(level))


def _prompts(vocab, lengths=(4, 7, 9), seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32)
            for n in lengths]


def _serve(e, prompts, new=6):
    rids = [e.submit(p, new) for p in prompts]
    rep = e.run()
    assert all(rep.statuses[r] == "completed" for r in rids), rep.errors
    assert e.pool.pages_in_use == 0 and e.pool.verify() == []
    return [rep.results[r].tolist() for r in rids], rep


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_tp2_greedy_parity_and_kv_accounting(level):
    """bf16: tp=2 gives tp=1's tokens bit for bit; each shard holds half
    the pool; the exact profile gathers and never sums."""
    prompts = _prompts(CFG.vocab)
    e1 = _eng(1, level, slots=4, max_len=24)
    toks1, rep1 = _serve(e1, prompts)
    e2 = _eng(2, level, slots=4, max_len=24)
    toks2, rep2 = _serve(e2, prompts)
    assert toks2 == toks1
    assert (rep1.tp, rep2.tp) == (1, 2)
    assert rep1.kv_bytes_per_device == e1.pool.total_bytes
    assert rep2.kv_bytes_per_device * 2 == e2.pool.total_bytes
    st = e2.cf.report.stats.get("partition")
    assert st is not None and st.get("params_sharded", 0) >= 1
    assert st.get("all_gather", 0) >= 1 and st.get("all_reduce", 0) == 0
    assert e1.cf.report.stats.get("partition") is None
    assert e2.live_stats().get("tp") == 2
    # the pool stays one global tensor per cache on the engine's device
    assert [tuple(b.shape) for b in e2.pool.buffers] == \
        [tuple(b.shape) for b in e1.pool.buffers]


def test_tp2_equals_the_reference_in_f32():
    """f32: the port at tp=2 gives the JAX engine's tp=1 tokens (the same
    seeded builder weights)."""
    cfg = get_config("deepseek-7b").reduced(compute_dtype="f32")
    jcfg = j_get_config("deepseek-7b").reduced(compute_dtype="f32")
    prompts = _prompts(cfg.vocab, (5, 8, 3), seed=4)
    knobs = dict(mode="paged", slots=3, max_len=16, seed=0, page_size=4,
                 chunk_steps=2)
    jeng = JServeEngine(jcfg, JEngineConfig(**knobs))
    want, _ = _serve(jeng, prompts)
    got, _ = _serve(_eng(2, cfg=cfg), prompts)
    assert got == want


def test_tp2_prefix_sharing_and_cow_accounting():
    """Host accounting is oblivious to tp: three requests of one prompt
    share its pages and copy on write at tp=2 exactly as at tp=1."""
    prompt = _prompts(CFG.vocab, (8,), seed=12)[0]
    ref, _ = _serve(_eng(2), [prompt], 8)

    def shared_run(tp):
        e = _eng(tp)
        toks, rep = _serve(e, [prompt] * 3, 8)
        assert toks == ref * 3
        p = rep.pool
        assert p.pages_in_use == 0 and p.active == 0
        assert p.ref_allocs == p.ref_frees
        return p

    p2, p1 = shared_run(2), shared_run(1)
    assert p2.shared_attaches >= 4 and p2.cow_copies >= 2
    assert (p2.shared_attaches, p2.cow_copies, p2.page_allocs,
            p2.page_frees) == (p1.shared_attaches, p1.cow_copies,
                               p1.page_allocs, p1.page_frees)


def test_tp2_cancel_mid_prefill_releases_shared_pages():
    rng = np.random.default_rng(13)
    base = rng.integers(0, CFG.vocab, size=(8,)).astype(np.int32)
    longp = np.concatenate(
        [base, rng.integers(0, CFG.vocab, size=(8,)).astype(np.int32)])
    kw = dict(slots=2, max_len=24, chunk_steps=4, prefill_chunk=4)
    ref, _ = _serve(_eng(2, **kw), [base], 8)
    e = _eng(2, **kw)
    rp = e.submit(base, 8)
    rl = e.submit(longp, 4)
    for _ in range(3):   # the publisher prefills and publishes; the sharer
        e.step()         # attaches
    assert e._requests[rl].prefill_pos is not None
    assert e.pool.stats().shared_attaches >= 2
    assert e.cancel(rl, "tp test") is True
    e.step()
    rep = e.run()
    assert rep.statuses[rl] == "cancelled"
    assert rep.results[rp].tolist() == ref[0]
    p = rep.pool
    assert p.pages_in_use == 0 and p.ref_allocs == p.ref_frees
    assert p.page_allocs == p.page_frees and e.pool.verify() == []


def test_tp2_disk_cache_keeps_tp_apart(tmp_path):
    """The disk cache keys tp: a tp=1 engine after a tp=2 one misses on
    every graph, a second tp=2 engine takes every graph from disk (the
    pipeline skipped, the shards emitted again), and all serve the same
    tokens."""
    from repro_torch.backend import Backend
    prompts = _prompts(CFG.vocab, (4, 7), seed=1)
    stats, toks = [], []
    for tp in (2, 1, 2):
        Backend.create("torch", device="cpu").clear_cache()
        e = _eng(tp, slots=2, cache_dir=str(tmp_path))
        toks.append(_serve(e, prompts, 5)[0])
        stats.append(e.backend.cache_stats())
    assert [(s.disk_hits, s.disk_misses) for s in stats] == \
        [(0, 3), (0, 3), (3, 0)]
    assert toks[0] == toks[1] == toks[2]


# -- the API ------------------------------------------------------------------
def test_engine_config_tp_checks():
    """The reference's messages: tp needs paged mode and the torch
    backend; an indexed pin is refused (a bare device type names the
    mesh's devices), unless the options carry an explicit mesh."""
    with pytest.raises(ValueError, match="mode='paged'"):
        EngineConfig(mode="continuous", tp=2)
    with pytest.raises(ValueError, match="torch backend"):
        EngineConfig(mode="paged", tp=2, backend="interpreter")
    with pytest.raises(ValueError, match="tp must be >= 1"):
        EngineConfig(mode="paged", tp=0)
    for dev in ("cpu", "cuda", None):
        assert EngineConfig(mode="paged", tp=2, device=dev).compile_options()
    pinned = EngineConfig(mode="paged", tp=2, device="cuda:0")
    with pytest.raises(ValueError, match="single-device pin"):
        pinned.compile_options()
    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    assert pinned.compile_options(CompileOptions(mesh=mesh)).mesh is mesh
    with pytest.raises(ValueError, match="single-device pin"):
        ServeEngine(CFG, EngineConfig(mode="paged", tp=2, device="cpu:0"))


def test_engine_tp_divisibility_and_mesh_checks():
    with pytest.raises(ValueError, match=r"tp=3 must divide n_heads=4"):
        _eng(3)
    with pytest.raises(ValueError, match="mesh of 2 shards"):
        _eng(2, options=CompileOptions(mesh=make_mesh(
            (4,), ("model",), devices=["cpu"] * 4)))
    # an explicit mesh of CPU shards serves as the built one does
    prompts = _prompts(CFG.vocab, (5, 6))
    want, _ = _serve(_eng(2), prompts, 4)
    got, _ = _serve(_eng(2, options=CompileOptions(mesh=make_mesh(
        (2,), ("model",), devices=["cpu"] * 2))), prompts, 4)
    assert got == want


def test_serve_cli_tp(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", "deepseek-7b", "--reduced", "--mode", "paged",
                     "--tp", "2", "--device", "cpu", "--gen", "4",
                     "--prompt-len", "6", "--batch", "2"])
    out = capsys.readouterr().out
    assert rc in (0, None)
    line = [ln for ln in out.splitlines() if ln.startswith("[kv-pool:tp]")]
    assert line and line[0].startswith("[kv-pool:tp] tp=2 ")
    with pytest.raises(SystemExit, match="mode='paged'"):
        serve.main(["--reduced", "--mode", "continuous", "--tp", "2",
                    "--device", "cpu"])


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_full_width_tp2_launches(level):
    """One full-width deepseek-7b decode chunk (two layers), partitioned
    over two shards and walked on the meta device: each shard runs the
    kernels tp=1 runs -- at O1 the products at local widths, at O2 the
    fused kernels on gathered operands -- so every count doubles and
    nothing is refused."""
    from test_torch_recurrent import _meta_kernels

    from repro_torch.backend.sharded import ShardedProgram
    from repro_torch.backend.sharding import partition_profile
    from repro_torch.core.passes import PartitionGraph, run_pipeline
    from repro_torch.devices import torch_dtype
    from repro_torch.models.lm import build_dense_chunk
    from repro_torch.transformers.torch_emit import EmitCtx, emit_callable

    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=2)
    fn = build_dense_chunk(cfg, 256, 4, 4, page_size=16).fn
    meta = torch.device("meta")
    fuse = {"swiglu": True, "norm_matmul": True, "rotary_qkv": True}
    counts = {}
    for tp in (1, 2):
        pg = PartitionGraph.from_profile(partition_profile("tp"), (tp,)) \
            if tp > 1 else None
        opt, _ = run_pipeline(fn, level, fuse=fuse, partition=pg)
        if tp > 1:
            run = ShardedProgram(
                opt, make_mesh((2,), ("model",), devices=["meta"] * 2),
                lambda d: EmitCtx(d, use_pallas=True, mode="shardmap"),
                home=meta)
            types = run.in_types
        else:
            run = emit_callable(opt, EmitCtx(meta, use_pallas=True))
            types = opt.in_types
        args = [torch.empty(t.shape, dtype=torch_dtype(t.dtype), device=meta)
                for t in types]
        launched, refused = collections.Counter(), collections.Counter()
        with _meta_kernels(launched, refused):
            run(*args)
        assert not refused, (tp, refused)
        counts[tp] = dict(launched)
    want = {"O1": {"matmul", "rmsnorm", "batched_matmul"},
            "O2": {"matmul", "rmsnorm", "norm_matmul", "swiglu",
                   "batched_matmul"}}[level]
    assert set(counts[1]) == want
    assert counts[2] == {k: 2 * v for k, v in counts[1].items()}


# -- the card -----------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA-graph capture and the Hopper "
                    "kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_tp2_on_one_card(cuda_device, level):
    """Two shards on one card (an explicit mesh) give tp=1's tokens bit
    for bit in bf16, eagerly and captured, and the captured dispatch
    writes the pool back into its own tensors."""
    cfg = dataclasses.replace(get_config("deepseek-7b").reduced(
        d_model=256, n_heads=2, n_kv_heads=2, d_head=128, d_ff=256))
    mesh = make_mesh((2,), ("model",), devices=["cuda:0"] * 2)
    prompts = _prompts(cfg.vocab, (9, 14, 5))
    kw = dict(device="cuda", slots=3, max_len=32)
    want, _ = _serve(_eng(1, level, cfg=cfg, **kw), prompts)
    eager, _ = _serve(_eng(2, cfg=cfg, options=_options(
        level, mesh=mesh, static_jit=False), **kw), prompts)
    assert eager == want
    e = _eng(2, cfg=cfg, options=_options(level, mesh=mesh), **kw)
    ptrs = [b.data_ptr() for b in e.pool.buffers]
    for run in range(3):   # eager first call, capture, replay
        got, _ = _serve(e, prompts)
        assert got == want, run
        assert [b.data_ptr() for b in e.pool.buffers] == ptrs
