"""The compiled dispatch of the torch port: CumSum and ScatterAdd against
the JAX emitter, the fixed-order guard they run under on the card, the
Scan's loop-invariant prologue, and ``static_jit`` -- eager on the CPU,
CUDA-graph capture on the card.

On the CPU: CumSum (inclusive, exclusive; f32 and bf16) and ScatterAdd
(duplicate, negative and out-of-range indices) agree with JAX's
emission (bitwise where every order of the sums is exact, else within
1e-4 of scale in f32 and 3e-2 in bf16); the guard gives the caller's
deterministic setting back; a Scan converts a constant once per
execution, not once per step, and its outputs are bitwise those of the
body stepped by hand; ``static_jit`` changes nothing on the CPU, and a
donated input pairs with its output in order, by shape and dtype.

On the card (``cuda``-marked, skipped here): capture == eager bitwise
for a reduced paged chunk, the launch counters advance per replay, a
returned output survives later replays, a donated input is written back
in place, a capture that fails raises, and the card's cumsum and
scatter-add keep one order (4 x 102400, 20 runs; 10^5 updates onto one
row, twice).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import Backend as JBackend  # noqa: E402
from repro.backend import CompileOptions as JOptions  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.backend import Backend as TBackend  # noqa: E402
from repro_torch.backend import CompileOptions as TOptions  # noqa: E402
from repro_torch.backend.graphed import (GraphCaptureError,  # noqa: E402
                                         GraphedProgram, pair_donations)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ops as t_ops  # noqa: E402
from repro_torch.core.function import Function as TFunction  # noqa: E402
from repro_torch.core.types import TensorType, bfloat16  # noqa: E402
from repro_torch.devices import as_tensor  # noqa: E402
from repro_torch.launch.engine import (EngineConfig, ServeEngine,  # noqa: E402
                                       _check_donation)
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.transformers import torch_emit  # noqa: E402
from repro_torch.transformers.torch_emit import (  # noqa: E402
    EmitCtx, deterministic_algorithms, emit_callable)


def _both(build, args, level="O0"):
    """The same graph built with both packages' ops at O0 (no rewriting),
    run on ``args``: (jax outputs, torch-CPU outputs)."""
    jps, jres = build(j_ops)
    tps, tres = build(t_ops)
    jcf = JBackend.create("jax").compile(JFunction(jps, jres, "edge"),
                                         JOptions(level=level))
    tcf = TBackend.create("torch", device="cpu").compile(
        TFunction(tps, tres, "edge"), TOptions(level=level))
    return jcf(*args), tcf(*args)


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(a).max()), 1.0)
    assert float(np.abs(a - b).max()) <= tol * scale


# -- CumSum and ScatterAdd against JAX ----------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_cumsum_matches_jax(axis, exclusive, dtype):
    rng = np.random.default_rng(axis * 2 + exclusive)
    x = rng.normal(size=(6, 37)).astype(np.float32)

    def build(ops):
        p = ops.parameter((6, 37), "f32", "x")
        v = p.out() if dtype == "f32" else ops.convert(p.out(), "bf16")
        return [p], [ops.cumsum(v, axis, exclusive=exclusive)]

    (j,), (t,) = _both(build, [x])
    assert j.dtype == t.dtype and j.shape == t.shape
    _close(j, t, 1e-4 if dtype == "f32" else 3e-2)
    # exact in every order: sums of multiples of 1/8 below 2^21
    q = np.round(x * 8) / 8
    (j,), (t,) = _both(build, [q])
    if dtype == "f32":
        np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("case", ["duplicates", "negative", "out_of_range",
                                  "mixed"])
def test_scatter_add_matches_jax(case):
    rng = np.random.default_rng(len(case))
    n, k = 9, 64
    idx = {"duplicates": rng.integers(0, 3, k),
           "negative": rng.integers(-n, 0, k),
           "out_of_range": np.concatenate([rng.integers(n, 3 * n, k // 2),
                                           rng.integers(-3 * n, -n, k // 2)]),
           "mixed": rng.integers(-2 * n, 2 * n, k)}[case].astype(np.int32)
    op = (np.round(rng.normal(size=(n, 5)) * 8) / 8).astype(np.float32)
    upd = (np.round(rng.normal(size=(k, 5)) * 8) / 8).astype(np.float32)

    def build(ops):
        ps = [ops.parameter((n, 5), "f32", "op"),
              ops.parameter((k,), "i32", "idx"),
              ops.parameter((k, 5), "f32", "upd")]
        return ps, [ops.scatter_add(ps[0].out(), ps[1].out(), ps[2].out())]

    (j,), (t,) = _both(build, [op, idx, upd])
    # multiples of 1/8: every order of the sums is exact, so bitwise
    np.testing.assert_array_equal(j, t)
    if case == "out_of_range":
        np.testing.assert_array_equal(t, op)   # every update dropped
    noisy = rng.normal(size=(k, 5)).astype(np.float32)
    (j,), (t,) = _both(build, [op, idx, noisy])
    _close(j, t, 1e-4)


@pytest.mark.parametrize("mode", [(False, False), (True, False),
                                  (True, True)])
def test_deterministic_guard_restores_the_callers_setting(mode):
    on, warn_only = mode
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(on, warn_only=warn_only)
    try:
        with deterministic_algorithms():
            assert torch.are_deterministic_algorithms_enabled()
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.are_deterministic_algorithms_enabled() == on
        assert torch.is_deterministic_algorithms_warn_only_enabled() == \
            warn_only
        with pytest.raises(ZeroDivisionError):
            with deterministic_algorithms():
                raise ZeroDivisionError
        assert torch.are_deterministic_algorithms_enabled() == on
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def test_cpu_cumsum_and_scatter_leave_the_setting_alone(monkeypatch):
    """On the CPU the emitters take no guard: the flag is never set."""
    seen = []
    monkeypatch.setattr(torch, "use_deterministic_algorithms",
                        lambda *a, **k: seen.append(a))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    node = t_ops.cumsum(t_ops.parameter((2, 3), "f32", "x").out(), 1).node
    out = torch_emit.EMIT["CumSum"](node, [x], EmitCtx("cpu"))[0]
    assert torch.equal(out, torch.cumsum(x, 1))
    assert seen == []


# -- the Scan's loop-invariant prologue ---------------------------------------
def _scan_fn(length, reverse=False):
    """A Scan whose body converts its f32 const to bf16 and uses it with
    the carry and the xs: h' = bf16(h * cast(w) + x), y = h' * cast(w)."""
    h = t_ops.parameter((4, 8), "bf16", "h")
    x = t_ops.parameter((4, 8), "bf16", "x")
    w = t_ops.parameter((4, 8), "f32", "w")
    wc = t_ops.convert(w.out(), "bf16")
    hn = h.out() * wc + x.out()
    body = TFunction([h, x, w], [hn, hn * wc], name="body")
    h0 = t_ops.parameter((4, 8), "bf16", "h0")
    xs = t_ops.parameter((length, 4, 8), "bf16", "xs")
    w0 = t_ops.parameter((4, 8), "f32", "w0")
    outs = t_ops.scan(body, [h0.out()], xs=[xs.out()], consts=[w0.out()],
                      length=length, reverse=reverse)
    return TFunction([h0, xs, w0], outs, name="scan"), body


def _scan_args(length, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dt)
            for s, dt in (((4, 8), torch.bfloat16),
                          ((length, 4, 8), torch.bfloat16),
                          ((4, 8), torch.float32))]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("length", [0, 1, 5])
def test_scan_converts_a_const_once_and_matches_stepping(monkeypatch,
                                                         length, reverse):
    calls = []
    convert = torch_emit.EMIT["Convert"]

    def counted(node, args, ctx):
        calls.append(tuple(args[0].shape))
        return convert(node, args, ctx)

    monkeypatch.setitem(torch_emit.EMIT, "Convert", counted)
    fn, body = _scan_fn(length, reverse)
    ctx = EmitCtx("cpu")
    run = emit_callable(fn, ctx)
    h0, xs, w0 = _scan_args(length)
    h, ys = run(h0, xs, w0)
    assert calls == ([(4, 8)] if length else [])
    # the same body stepped by hand, converting every step
    calls.clear()
    step = emit_callable(body, ctx)
    hh, ref_ys = h0, [None] * length
    for t in (range(length - 1, -1, -1) if reverse else range(length)):
        hh, ref_ys[t] = step(hh, xs[t], w0)
    assert len(calls) == length
    assert torch.equal(h, hh)
    if length:
        assert torch.equal(ys, torch.stack(ref_ys))
    else:
        assert tuple(ys.shape) == (0, 4, 8)


def test_paged_chunk_converts_the_embedding_once_per_dispatch(monkeypatch):
    """The reduced paged chunk (3 steps): the embedding table's and the
    unembedding's f32 -> bf16 converts sit inside the step Scan and run
    once per dispatch; the tokens are those of the unhoisted walk."""
    import dataclasses
    cfg = dataclasses.replace(get_config("deepseek-7b").reduced(),
                              compute_dtype="bf16")
    g = t_lm.build_dense_chunk(cfg, 32, 2, 3, page_size=8, n_pages=9)
    calls = []
    convert = torch_emit.EMIT["Convert"]

    def counted(node, args, ctx):
        calls.append(tuple(args[0].shape))
        return convert(node, args, ctx)

    monkeypatch.setitem(torch_emit.EMIT, "Convert", counted)
    cf = TBackend.create("torch", device="cpu", fresh=True).compile(
        g.fn, TOptions(level="O2", use_pallas=True))
    params = g.builder.init_params(0)
    rng = np.random.default_rng(0)
    args = []
    for node in g.fn.parameters:
        t = node.out_types[0]
        if node.name in params:
            args.append(params[node.name])
        elif node.name in ("token", "page_tbl"):
            args.append(rng.integers(1, 9, t.shape).astype(np.int32))
        elif node.name == "pos":
            args.append(rng.integers(1, 20, t.shape).astype(np.int32))
        elif node.name in ("temperature", "top_k", "key"):
            args.append(np.zeros(t.shape, t.dtype))
        else:
            args.append((rng.normal(size=t.shape) * 0.5).astype(t.dtype))
    toks = cf(*args)[0]
    table = (cfg.vocab, cfg.d_model)
    assert calls.count(table) == 1
    assert calls.count(table[::-1]) == (0 if cfg.tie_embeddings else 1)
    # the walk without the prologue: every body node every step
    monkeypatch.setattr(torch_emit.ScanBody, "__init__", _no_hoist_init)
    cold = TBackend.create("torch", device="cpu", fresh=True).compile(
        g.fn, TOptions(level="O2", use_pallas=True))
    calls.clear()
    np.testing.assert_array_equal(cold(*args)[0], toks)
    assert calls.count(table) == 3


def _no_hoist_init(self, fn, ctx, n_variant):
    """``ScanBody`` with nothing hoisted: every node runs every step."""
    self.ctx, self.name = ctx, fn.name
    sl = self.slots = torch_emit._Slots(fn, ctx)
    self.const_slots = sl.params[n_variant:]
    self.variant_slots = sl.params[:n_variant]
    self.pro_plan = []
    self.step_plan = sl.plan(
        [n for n in sl.nodes
         if n.op != "Parameter" and n.op not in torch_emit._LEAVES],
        set(sl.results) | set(self.const_slots))


# -- static_jit on the CPU, and the donation pairing --------------------------
def test_static_jit_is_ignored_on_the_cpu():
    fn, _ = _scan_fn(3)
    args = _scan_args(3, seed=4)
    be = TBackend.create("torch", device="cpu", fresh=True)
    outs = {}
    for sj in (True, False):
        cf = be.compile(fn, TOptions(level="O1", static_jit=sj,
                                     donate_argnums=(0,)))
        assert not isinstance(cf.raw, GraphedProgram)
        assert cf.raw.donation == {0: 0}
        outs[sj] = [cf.raw(*args) for _ in range(3)]
    for a, b in zip(outs[True], outs[False]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert be.cache_stats().misses == 2   # static_jit is in the key


def test_pair_donations_in_order_by_shape_and_dtype():
    f32 = np.dtype(np.float32)
    ins = [TensorType((2, 3), f32), TensorType((4,), f32),
           TensorType((2, 3), f32), TensorType((2, 3), bfloat16)]
    outs = [TensorType((2, 3), bfloat16), TensorType((2, 3), f32),
            TensorType((2, 3), f32), TensorType((4,), np.dtype(np.int32))]
    assert pair_donations(ins, outs, (0, 2, 3)) == {0: 1, 2: 2, 3: 0}
    assert pair_donations(ins, outs, (2, 0)) == {0: 1, 2: 2}
    # no output of its shape and dtype: not written back
    assert pair_donations(ins, outs, (1,)) == {}


@pytest.mark.parametrize("mode", ["paged", "continuous", "donated"])
def test_engine_recycle_maps_agree_with_the_pairing(mode):
    cfg = get_config("deepseek-7b").reduced()
    knobs = dict(page_size=4, chunk_steps=2) if mode == "paged" else {}
    eng = ServeEngine(cfg, EngineConfig(mode=mode, slots=2, max_len=16,
                                        device="cpu", **knobs))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 6).astype(np.int32)
               for _ in range(2)]
    rids = [eng.submit(p, 4) for p in prompts]
    rep = eng.run()   # compiles (and checks) every graph of the mode
    assert all(rep.statuses[r] == "completed" for r in rids)
    if mode == "donated":
        (_, cf, _), = eng._chunks.values()
        cache_ix = [i for i, p in enumerate(cf.function.parameters)
                    if p.name in ("cache_k", "cache_v")]
        recycle = list(range(len(cache_ix)))
    else:
        cf, recycle = eng.cf, eng._recycle
        cache_ix = [i for i, p in enumerate(cf.function.parameters)
                    if p.name in eng.cache_names]
    assert set(cf.raw.donation) == set(cache_ix)
    _check_donation(cf, cache_ix, recycle, cache_ix)
    # a map that crosses two caches is refused
    with pytest.raises(RuntimeError, match="recycles"):
        _check_donation(cf, cache_ix, recycle[::-1], cache_ix)


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA-graph capture and the Hopper "
                    "kernels have no CPU mode")
    return torch.device("cuda")


def _chunk(dtype="bf16"):
    """A reduced paged chunk whose widths the kernels take (d_head 128)."""
    import dataclasses
    cfg = dataclasses.replace(
        get_config("deepseek-7b").reduced(d_model=256, n_heads=2,
                                          n_kv_heads=2, d_head=128,
                                          d_ff=256),
        compute_dtype=dtype)
    return cfg, t_lm.build_dense_chunk(cfg, 32, 2, 3, page_size=8,
                                       n_pages=9)


def _chunk_args(g, cfg, device, seed):
    rng = np.random.default_rng(seed)
    params = g.builder.init_params(0)
    args = []
    for node in g.fn.parameters:
        t = node.out_types[0]
        if node.name in params:
            args.append(as_tensor(params[node.name], device))
        elif node.name == "token":
            args.append(rng.integers(0, cfg.vocab, t.shape).astype(np.int32))
        elif node.name == "page_tbl":
            args.append(rng.integers(1, 9, t.shape).astype(np.int32))
        elif node.name == "pos":
            args.append(rng.integers(1, 20, t.shape).astype(np.int32))
        elif node.name in ("temperature", "top_k", "key"):
            args.append(np.zeros(t.shape, t.dtype))
        else:   # the KV pool, on the card
            args.append(as_tensor((rng.normal(size=t.shape) * 0.5)
                                  .astype(t.dtype), device))
    return args


def _cache_ix(g):
    return tuple(i for i, p in enumerate(g.fn.parameters)
                 if p.name in ("cache_k", "cache_v"))


def _bits_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _with_device_args(args, device_args):
    """``args`` with its device tensors taken from ``device_args``."""
    return [d if isinstance(a, torch.Tensor) else a
            for a, d in zip(args, device_args)]


@pytest.mark.cuda
def test_capture_equals_eager_and_counts_per_replay(cuda_device):
    cfg, g = _chunk()
    opts = TOptions(level="O2", use_pallas=True, donate_argnums=_cache_ix(g))
    be = TBackend.create("torch", device=cuda_device, fresh=True)
    eager = be.compile(g.fn, opts.replace(static_jit=False))
    graphed = be.compile(g.fn, opts)
    assert isinstance(graphed.raw, GraphedProgram)
    # the graphed calls take the same device tensors every time (as an
    # engine's weights and pool), refilled with each call's values
    fixed = [a.clone() if isinstance(a, torch.Tensor) else a
             for a in _chunk_args(g, cfg, cuda_device, seed=0)]
    for call in range(4):
        args = _chunk_args(g, cfg, cuda_device, seed=call)
        for f, a in zip(fixed, args):
            if isinstance(a, torch.Tensor):
                f.copy_(a)
        kernels.reset_counters()
        want = eager.raw(*args)
        torch.cuda.synchronize()
        eager_counts = kernels.counters()
        kernels.reset_counters()
        got = graphed.raw(*_with_device_args(args, fixed))
        torch.cuda.synchronize()
        assert graphed.raw.captured == (call >= 1)
        assert kernels.counters() == eager_counts
        assert sum(c["launches"] for c in eager_counts.values()) > 0
        for w, o in zip(want, got):
            assert _bits_equal(w, o), f"call {call}"
    assert (graphed.raw.captures, graphed.raw.replays) == (1, 3)


@pytest.mark.cuda
def test_replay_keeps_returned_outputs_and_writes_donated_in_place(
        cuda_device):
    cfg, g = _chunk()
    ix = _cache_ix(g)
    cf = TBackend.create("torch", device=cuda_device, fresh=True).compile(
        g.fn, TOptions(level="O2", use_pallas=True, donate_argnums=ix))
    pool = _chunk_args(g, cfg, cuda_device, 0)
    for call in range(3):     # eager, capture, replay
        out = cf.raw(*_with_device_args(
            _chunk_args(g, cfg, cuda_device, call), pool))
        for i, j in cf.raw.donation.items():
            assert out[j] is pool[i], f"call {call}"
        if call == 1:
            toks, kept = out[0], out[0].clone()
    torch.cuda.synchronize()
    assert _bits_equal(toks, kept)     # the replay left it alone
    assert (cf.raw.captures, cf.raw.replays) == (1, 2)
    # another pool is another graph, and the first pool is not touched
    before = [a.clone() if isinstance(a, torch.Tensor) else a for a in pool]
    other = _chunk_args(g, cfg, cuda_device, 3)
    out = cf.raw(*other)
    torch.cuda.synchronize()
    assert (cf.raw.captures, cf.raw.graphs) == (2, 2)
    for i, j in cf.raw.donation.items():
        assert out[j] is other[i]
    for a, b in zip(pool, before):
        if isinstance(a, torch.Tensor):
            assert _bits_equal(a, b)


@pytest.mark.cuda
def test_replay_never_writes_an_input_that_was_not_donated(cuda_device):
    """Two sets of weights of the same shapes through one compiled
    function: each gets its own graph, neither is written, and each
    call gives what the eager program gives on its weights."""
    cfg, g = _chunk()
    opts = TOptions(level="O2", use_pallas=True, donate_argnums=_cache_ix(g))
    be = TBackend.create("torch", device=cuda_device, fresh=True)
    eager = be.compile(g.fn, opts.replace(static_jit=False))
    cf = be.compile(g.fn, opts)
    names = [p.name for p in g.fn.parameters]
    weights = {}
    for seed in (0, 1):
        params = g.builder.init_params(seed)
        weights[seed] = [as_tensor(params[n], cuda_device)
                         if n in params else None for n in names]
    kept = {s: [w.clone() if w is not None else None for w in ws]
            for s, ws in weights.items()}
    pool = _chunk_args(g, cfg, cuda_device, 0)   # its tensors stay
    for call, seed in enumerate((0, 0, 1, 1, 0)):
        fresh = [w if w is not None else a for a, w in zip(
            _chunk_args(g, cfg, cuda_device, call), weights[seed])]
        args = [a if w is not None or not isinstance(a, torch.Tensor)
                else p.copy_(a)
                for a, p, w in zip(fresh, pool, weights[seed])]
        want = eager.raw(*fresh)
        got = cf.raw(*args)
        torch.cuda.synchronize()
        for w, o in zip(want, got):
            assert _bits_equal(w, o), f"call {call}, seed {seed}"
    assert (cf.raw.captures, cf.raw.replays) == (2, 4)
    for s in (0, 1):
        for w, k in zip(weights[s], kept[s]):
            if w is not None:
                assert _bits_equal(w, k), f"weights of seed {s} written"


@pytest.mark.cuda
def test_failed_capture_raises_and_never_runs_eagerly(cuda_device,
                                                      monkeypatch):
    add = torch_emit.EMIT["Add"]

    def syncing_add(node, args, ctx):
        out = add(node, args, ctx)
        float(out[0].float().sum())   # a host read: a sync under capture
        return out

    monkeypatch.setitem(torch_emit.EMIT, "Add", syncing_add)
    x = t_ops.parameter((8,), "f32", "x")
    fn = TFunction([x], [x.out() + x.out()], name="sync_in_add")
    cf = TBackend.create("torch", device=cuda_device, fresh=True).compile(
        fn, TOptions(level="O0"))
    arg = np.arange(8, dtype=np.float32)
    np.testing.assert_array_equal(cf(arg)[0], 2 * arg)   # eager, call 1
    with pytest.raises(GraphCaptureError, match="sync_in_add.*Add"):
        cf(arg)
    with pytest.raises(GraphCaptureError, match="capture failed"):
        cf(arg)


@pytest.mark.cuda
def test_kernels_launch_on_the_capture_stream(cuda_device):
    from repro_torch.kernels import matmul as km
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn((4, 256), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    b = torch.randn((256, 128), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    km.matmul(a, b)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = km.matmul(a, b)
    for _ in range(2):
        a.copy_(torch.randn((4, 256), generator=gen, device=cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        assert _bits_equal(out, km.matmul(a, b))


@pytest.mark.cuda
def test_cumsum_is_bitwise_stable_on_the_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = torch.softmax(torch.randn((4, 102400), generator=gen,
                                  device=cuda_device), dim=-1)
    node = t_ops.cumsum(t_ops.parameter((4, 102400), "f32", "p").out(),
                        1).node
    ctx = EmitCtx(cuda_device)
    first = torch_emit.EMIT["CumSum"](node, [p], ctx)[0]
    for _ in range(19):
        assert _bits_equal(torch_emit.EMIT["CumSum"](node, [p], ctx)[0],
                           first)
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.cuda
def test_scatter_add_is_bitwise_stable_on_the_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    n = 100_000
    op = torch.zeros((4, 64), device=cuda_device)
    upd = torch.randn((n, 64), generator=gen, device=cuda_device)
    idx = torch.full((n,), 2, dtype=torch.int32, device=cuda_device)
    node = t_ops.scatter_add(t_ops.parameter((4, 64), "f32", "op").out(),
                             t_ops.parameter((n,), "i32", "idx").out(),
                             t_ops.parameter((n, 64), "f32", "u").out()).node
    ctx = EmitCtx(cuda_device)
    a = torch_emit.EMIT["ScatterAdd"](node, [op, idx, upd], ctx)[0]
    b = torch_emit.EMIT["ScatterAdd"](node, [op, idx, upd], ctx)[0]
    assert _bits_equal(a, b)
    assert torch.allclose(a[2].double(), upd.double().sum(0), atol=1e-2)
    assert not torch.equal(a[2], torch.zeros_like(a[2]))


def test_clear_cache_drops_the_capture_pool():
    """A cleared backend captures later graphs into a new pool (its old
    graphs are gone with the cache); on the CPU no pool is ever made."""
    be = TBackend.create("torch", device="cpu", fresh=True)
    be._graph_pool = object()
    be.clear_cache()
    assert be._graph_pool is None


@pytest.mark.cuda
def test_capture_after_clear_cache(cuda_device):
    """Graphs captured, the backend's cache cleared (every graph of its
    pool released), then a new graph captured on the same backend: the
    capture takes a new pool, where reusing the released one failed
    PyTorch's host-allocator assert, and replays give the eager bits."""
    import gc
    cfg, g = _chunk()
    opts = TOptions(level="O2", use_pallas=True, donate_argnums=_cache_ix(g))
    be = TBackend.create("torch", device=cuda_device, fresh=True)
    for round_ in range(2):
        eager = be.compile(g.fn, opts.replace(static_jit=False))
        graphed = be.compile(g.fn, opts)
        args = _chunk_args(g, cfg, cuda_device, seed=round_)
        fixed = [a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args]
        want = eager.raw(*args)
        for _ in range(3):
            for f, a in zip(fixed, _chunk_args(g, cfg, cuda_device,
                                               seed=round_)):
                if isinstance(a, torch.Tensor):
                    f.copy_(a)
            got = graphed.raw(*fixed)
        torch.cuda.synchronize()
        assert graphed.raw.captures == 1 and graphed.raw.replays == 2
        for w, o in zip(want, got):
            assert _bits_equal(w, o), f"round {round_}"
        del eager, graphed, got, want, fixed
        be.clear_cache()
        gc.collect()
