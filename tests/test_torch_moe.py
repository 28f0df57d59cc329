"""The mixture-of-experts families on torch -- mixtral-8x22b (``moe``) and
deepseek-v3-671b (``mla_moe``) -- against the JAX package on the CPU.

Both packages build the same graphs (their structural signatures agree)
and run them on the same numpy inputs and weights (the JAX builder's, or
the JAX engine's, carried across by name with ``params_from_numpy``).
The port runs at O2 with ``use_pallas`` (the kernels' plain versions on
CPU tensors) or O1; JAX at O1, or its engine at O2 with the Pallas
kernels in interpret mode.  Widths: ``reduced()``, and a d_head-128
width at which the port's attention takes flash (for MLA the prefill's
d_nope + d_rope and the absorbed decode's kv_lora + d_rope are 128).

Tolerances are ``scripts/check_kernel_parity.py``'s: 1e-4 of scale in
f32, 3e-2 in bf16.  f32 greedy tokens and logits argmax are identical.
In bf16 two correct implementations split near-ties.  A router may pick
another expert where its k-th and (k+1)-th probabilities lie within one
bf16 unit, which moves the layer's output by a whole expert's share; so
in bf16 both packages run on JAX's routing (the port's ``TopK`` takes
the experts JAX's chose, in the order the routers ran), each row where
the port's own choice differs must be such a near-tie, and the outputs
are held to 3e-2 with no exemption.  A greedy token may still differ
where the port's top two logits lie within one bf16 unit
(``tests/test_torch_engine_modes.py``'s rule).
"""
import contextlib

import jax
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import Backend as JBackend  # noqa: E402
from repro.backend import CompileOptions as JOptions  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.builder import ModelBuilder as JBuilder  # noqa: E402
from repro.transformers import jax_backend as j_emit  # noqa: E402

from repro_torch.backend import Backend, CompileOptions  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import ops as t_ops  # noqa: E402
from repro_torch.core.function import Function as TFunction  # noqa: E402
from repro_torch.launch.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.builder import ModelBuilder as TBuilder  # noqa: E402
from repro_torch.models.weights import (init_params_on_device,  # noqa: E402
                                        params_from_numpy)
from repro_torch.transformers import torch_emit  # noqa: E402

ARCHS = ("mixtral-8x22b", "deepseek-v3-671b")
TOL = {"f32": 1e-4, "bf16": 3e-2}
B, S = 2, 16
# the d_head-128 width: flash carries the Attention op on the card
DH128 = dict(d_model=256, n_heads=2, n_kv_heads=2, d_head=128, d_ff=256)
MLA_DH128 = dict(d_nope=64, d_rope=64, d_v=128, kv_lora=64)


def _cfg(get, arch, dtype="f32", width="reduced", **over):
    over = dict(over)
    if width == "dh128":
        over.update(DH128)
        if get(arch).mla:
            over.update(MLA_DH128)
    return get(arch).reduced(compute_dtype=dtype, **over)


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(float(x)), 2.0 ** -14))) - 7)


@contextlib.contextmanager
def _jax_routing(routes: list):
    """While open, each ``TopK`` the JAX package traces (the MoE routers)
    appends its indices to ``routes`` every time it runs, in the order
    the routers run.  Trace inside (a fresh or cleared backend), and
    call ``jax.effects_barrier()`` before reading."""
    run = j_emit.EMIT["TopK"]

    def recorded(node, args, ctx):
        v, i = run(node, args, ctx)
        jax.debug.callback(lambda a: routes.append(np.asarray(a)), i,
                           ordered=True)
        return [v, i]

    j_emit.EMIT["TopK"] = recorded
    try:
        yield
    finally:
        j_emit.EMIT["TopK"] = run


@contextlib.contextmanager
def _on_jax_routing(routes: list, flips: list):
    """While open, the port's ``TopK`` takes JAX's choices (``routes``,
    run by run) and its own inputs at them, so both packages send every
    token to the same experts in the same order.  Each row where the
    port's own choice differs adds ``(run, gap)`` to ``flips``: its own
    pick's input above JAX's pick's, in bf16 units at its own.  Yields
    the list of runs taken.  Compile with a fresh or cleared backend
    inside."""
    run = torch_emit.EMIT["TopK"]
    taken = []

    def forced(node, args, ctx):
        v, i = run(node, args, ctx)
        n = len(taken)
        assert n < len(routes), "the port ran more routers than JAX"
        taken.append(n)
        want = torch.from_numpy(np.array(routes[n])).to(i.device)
        assert want.shape == i.shape, (n, want.shape, i.shape)
        at = torch.gather(args[0], -1, want.long())
        off = (i != want).reshape(-1, i.shape[-1]).any(-1)
        if bool(off.any()):
            own = v.float().reshape(-1, v.shape[-1])[off]
            theirs = at.float().reshape(-1, v.shape[-1])[off]
            ulp = torch.exp2(torch.floor(torch.log2(
                own.abs().clamp_min(2.0 ** -14))) - 7)
            gaps = ((own - theirs).abs() / ulp).amax(-1)
            flips.extend((n, float(g)) for g in gaps)
        return [at, want.to(torch.int32)]

    torch_emit.EMIT["TopK"] = forced
    try:
        yield taken
    finally:
        torch_emit.EMIT["TopK"] = run


def _rel_err(ref, got) -> float:
    a = np.asarray(ref, np.float64)
    b = np.asarray(got, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1.0)


def _hold(where, ref, got, dtype):
    err = _rel_err(ref, got)
    assert err <= TOL[dtype], f"{where}: {err:.3e} of scale > {TOL[dtype]}"


def _both(jfn, tfn, args, dtype, levels=("O1", "O2")):
    """JAX at O1 and the port at each of ``levels`` on ``args``: (JAX's
    outputs, {level: the port's}).  In bf16 the port runs on JAX's
    routing, and its own choice may differ only at a near-tie."""
    if dtype == "f32":
        return (JBackend.create("jax").compile(jfn, JOptions(level="O1"))(
            *args), {lvl: _port(tfn, args, lvl) for lvl in levels})
    routes = []
    with _jax_routing(routes):
        ref = JBackend.create("jax", fresh=True).compile(
            jfn, JOptions(level="O1"))(*args)
        jax.effects_barrier()
    assert routes, "no router ran"
    got = {}
    for lvl in levels:
        flips = []
        with _on_jax_routing(routes, flips) as taken:
            got[lvl] = _port(tfn, args, lvl)
        assert len(taken) == len(routes), (len(taken), len(routes))
        assert all(g <= 1.0 for _, g in flips), flips
    return ref, got


def _graphs(arch, kind, dtype, width="reduced"):
    jc = _cfg(j_get_config, arch, dtype, width)
    tc = _cfg(get_config, arch, dtype, width)
    jg = j_lm.build_graphs(jc, JShapeConfig(kind, kind, S, B), B)
    tg = lm.build_graphs(tc, ShapeConfig(kind, kind, S, B), B)
    assert jg.fn.signature() == tg.fn.signature()
    return jc, tc, jg, tg


def _inputs(g, cfg, rng):
    """The graph's inputs: token ids, a decode position inside the
    cache, caches, the builder's seeded weights."""
    params = g.builder.init_params(0)
    out = []
    for node in g.builder.inputs:
        t = node.out_types[0]
        if node.name in ("tokens", "labels", "token"):
            out.append(rng.integers(0, cfg.vocab, size=t.shape)
                       .astype(np.int32))
        elif node.name == "pos":
            out.append(np.int32(S // 2))
        else:   # caches
            out.append((rng.normal(size=t.shape) * 0.5).astype(t.dtype))
    return out + [params[n] for n in g.builder.param_names()]


def _port(fn, args, level="O2"):
    be = Backend.create("torch", device="cpu", fresh=True)
    return be.compile(fn, CompileOptions(level=level,
                                         use_pallas=level == "O2"))(*args)


# -- apply_moe alone ---------------------------------------------------------
D_MOE, E, K, FF = 32, 4, 2, 16


def _moe_fn(ops, Function, Builder, moe_mod, dtype, T, factor):
    b = Builder("f32", dtype)
    x = ops.parameter((B, T // B, D_MOE), dtype, "x")
    shapes = {"router": (D_MOE, E), "we_gate": (E, D_MOE, FF),
              "we_up": (E, D_MOE, FF), "we_down": (E, FF, D_MOE)}
    ws = {n: ops.parameter(s, "f32", n) for n, s in shapes.items()}
    out, aux = moe_mod.apply_moe(
        b, x.out(), {f"moe_{n}": w.out() for n, w in ws.items()},
        prefix="moe_", n_experts=E, top_k=K, capacity_factor=factor)
    return Function([x] + list(ws.values()), [out, aux], "moe")


def _moe_args(dtype, T, rigged, rng):
    x = rng.normal(size=(B, T // B, D_MOE))
    router = rng.normal(size=(D_MOE, E)) * 0.3
    if rigged:
        # every token's top expert is 0: |x| against a positive column
        x = np.abs(x)
        router[:, 0] = 1.0
    ws = [router] + [rng.normal(size=s) / np.sqrt(s[-2]) for s in
                     ((E, D_MOE, FF), (E, D_MOE, FF), (E, FF, D_MOE))]
    x_dt = np.float32 if dtype == "f32" else ml_dtypes.bfloat16
    return [x.astype(np.float32).astype(x_dt)] + \
        [w.astype(np.float32) for w in ws]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rigged", [False, True],
                         ids=["random_router", "expert0_overflows"])
def test_apply_moe_matches_jax(rigged, dtype):
    """The GShard dispatch (TopK, CumSum positions, ScatterAdd into the
    expert buffers, batched expert FFN, Gather and the weighted combine)
    and its aux loss, the port against JAX; rigged, every token's first
    choice is expert 0, so half its assignments overflow the capacity
    and take the drop path (``keep`` false)."""
    T, factor = 32, 1.0
    C = j_moe.capacity_for(T, K, E, factor)
    assert t_moe.capacity_for(T, K, E, factor) == C == 16
    rng = np.random.default_rng(3)
    args = _moe_args(dtype, T, rigged, rng)
    top1 = np.argmax(args[0].astype(np.float32).reshape(T, D_MOE)
                     @ args[1], -1)
    overflow = int((top1 == 0).sum()) > C
    assert overflow == rigged
    jfn = _moe_fn(j_ops, JFunction, JBuilder, j_moe, dtype, T, factor)
    tfn = _moe_fn(t_ops, TFunction, TBuilder, t_moe, dtype, T, factor)
    assert jfn.signature() == tfn.signature()
    ref, gots = _both(jfn, tfn, args, dtype)
    for level, got in gots.items():
        for i, (a, b) in enumerate(zip(ref, got)):
            _hold(f"{level} output {i}", a, b, dtype)


# -- the families' graphs ------------------------------------------------------
KINDS = [(a, k) for a in ARCHS for k in ("prefill", "decode", "train")] + \
    [("mixtral-8x22b", "long_decode")]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,kind", KINDS)
def test_graph_matches_jax(arch, kind, dtype):
    """Each graph kind of both families (reduced width; the d_head-128
    width is the parity gate's, ``scripts/check_torch_parity.py``): the
    port at O2 (kernels' plain versions) and O1 against JAX at O1."""
    jc, tc, jg, tg = _graphs(arch, kind, dtype)
    args = _inputs(jg, jc, np.random.default_rng(5))
    ref, gots = _both(jg.fn, tg.fn, args, dtype)
    for level, got in gots.items():
        assert len(got) == len(ref)
        for i, (a, b) in enumerate(zip(ref, got)):
            _hold(f"{kind} {level} output {i}", a, b, dtype)
        logits = np.asarray(got[0], np.float32)
        if dtype == "f32" and logits.ndim and logits.shape[-1] == tc.vocab:
            assert np.array_equal(np.asarray(ref[0], np.float32).argmax(-1),
                                  logits.argmax(-1))


def test_mixtral_long_decode_ring_matches_jax():
    """Mixtral's sliding window on the long shape: a ring cache of
    ``window`` rows, stepped past the window so the ring wraps twice;
    every step's logits and ring against JAX's (f32)."""
    jc, tc, jg, tg = _graphs("mixtral-8x22b", "long_decode", "f32")
    assert jg.fn.signature() == tg.fn.signature()
    W = tc.window
    ring = [n for n in tg.builder.inputs if n.name.startswith("cache")]
    assert all(n.out_types[0].shape[3] == W for n in ring)
    rng = np.random.default_rng(6)
    params = jg.builder.init_params(0)
    pv = [params[n] for n in jg.builder.param_names()]
    jcf = JBackend.create("jax").compile(jg.fn, JOptions(level="O1"))
    tcf = Backend.create("torch", device="cpu").compile(
        tg.fn, CompileOptions(level="O2", use_pallas=True))
    jc_, tc_ = ([np.zeros(n.out_types[0].shape, n.out_types[0].dtype)
                 for n in ring] for _ in range(2))
    for step in range(2 * W + 3):
        tok = rng.integers(0, tc.vocab, size=(B, 1)).astype(np.int32)
        jo = jcf(tok, np.int32(step), *jc_, *pv)
        to = tcf(tok, np.int32(step), *tc_, *pv)
        assert _rel_err(jo[0], to[0]) <= TOL["f32"], step
        assert np.array_equal(np.asarray(jo[0]).argmax(-1),
                              np.asarray(to[0]).argmax(-1))
        jc_, tc_ = [np.asarray(o) for o in jo[1:]], \
            [np.asarray(o) for o in to[1:]]
        for a, b in zip(jc_, tc_):
            assert _rel_err(a, b) <= TOL["f32"], step


@pytest.mark.parametrize("width", ["reduced", "dh128"])
def test_mla_latent_decode_matches_prefill(width):
    """The port's copy of ``tests/test_serving.py``'s MLA check: the
    absorbed latent-cache decode, stepped through the prompt, gives the
    expanded attention's prefill logits (MLA's algebraic identity); at
    d_head 128 both attentions take flash (its plain version here)."""
    cfg = _cfg(get_config, "deepseek-v3-671b", "bf16", width)
    P = 8
    rng = np.random.default_rng(0)
    be = Backend.create("torch", device="cpu")
    opts = CompileOptions(level="O2", use_pallas=True)
    pre = lm.build_graphs(cfg, ShapeConfig("prefill", "prefill", P, B), B)
    params = pre.builder.init_params(0)
    prompts = rng.integers(0, cfg.vocab, size=(B, P)).astype(np.int32)
    pouts = be.compile(pre.fn, opts)(
        prompts, *[params[n] for n in pre.builder.param_names()])
    prefill_logits = np.asarray(pouts[0], np.float32).reshape(B, -1)
    dec = lm.build_graphs(cfg, ShapeConfig("decode", "decode", P, B), B)
    assert dec.aux["cache_names"] == ["dense_ckv", "dense_kr", "moe_ckv",
                                      "moe_kr"]
    dex = be.compile(dec.fn, opts)
    caches = [np.zeros(n.out_types[0].shape, n.out_types[0].dtype)
              for n in dec.builder.inputs if n.name not in ("token", "pos")]
    for t_i in range(P):
        outs = dex(prompts[:, t_i:t_i + 1], np.int32(t_i), *caches,
                   *[params[n] for n in dec.builder.param_names()])
        logits = np.asarray(outs[0], np.float32).reshape(B, -1)
        caches = [np.asarray(o) for o in outs[1:]]
    np.testing.assert_allclose(logits, prefill_logits, atol=5e-2, rtol=5e-2)
    assert np.array_equal(np.argmax(logits, -1),
                          np.argmax(prefill_logits, -1))


# -- lockstep serving ------------------------------------------------------------
SLOTS, MAX_LEN, NEW = 2, 24, 8
ENGINE_CASES = [(a, lvl, dt, "reduced") for a in ARCHS
                for lvl in ("O1", "O2") for dt in ("f32", "bf16")] + \
    [(a, "O2", dt, "dh128") for a in ARCHS for dt in ("f32", "bf16")]


def _prefill_logits(jcfg, tcfg, jparams, level, tokens):
    """The last-position logits of a dense prefill of ``tokens``: JAX's
    at O1 and the port's at ``level`` on JAX's routing (bf16)."""
    P = len(tokens)
    jg = j_lm.build_graphs(jcfg, JShapeConfig("prefill", "prefill", P, 1), 1)
    tg = lm.build_graphs(tcfg, ShapeConfig("prefill", "prefill", P, 1), 1)
    args = [np.asarray(tokens, np.int32).reshape(1, P)] + \
        [np.asarray(jparams[n]) for n in jg.builder.param_names()]
    ref, got = _both(jg.fn, tg.fn, args, "bf16", levels=(level,))
    return [np.asarray(o[0], np.float32).reshape(-1)
            for o in (ref, got[level])]


def _routers_per_dispatch(routes) -> int:
    """The router runs of one lockstep dispatch: the prefill's, up to
    the first run over one row per slot (a decode step's)."""
    return next(n for n, r in enumerate(routes)
                if int(np.prod(r.shape[:-1])) == SLOTS)


@pytest.mark.parametrize("arch,level,dtype,width", ENGINE_CASES)
def test_lockstep_tokens_match_jax(arch, level, dtype, width):
    """``ServeEngine(mode="lockstep")`` serves both families; its greedy
    tokens equal the JAX engine's on the JAX engine's weights -- in f32
    exactly.  In bf16 the port's engine runs on the JAX engine's routing,
    its own choice differing only at a router near-tie while both
    engines see the same tokens.  The first differing token of a request
    must sit at a logit near-tie: in a dense prefill of the prompt plus
    the agreed tokens (the port on JAX's routing), one package's top two
    are the two engines' tokens, within one bf16 unit of each other."""
    jcfg = _cfg(j_get_config, arch, dtype, width)
    tcfg = _cfg(get_config, arch, dtype, width)
    bf16 = dtype == "bf16"
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab, 12).astype(np.int32)
               for _ in range(SLOTS)]
    routes, flips = [], []
    with _jax_routing(routes) if bf16 else contextlib.nullcontext():
        if bf16:   # trace the engine's graphs through the recording
            JBackend.create("jax").clear_cache()
        jeng = JServeEngine(jcfg, mode="lockstep", slots=SLOTS,
                            max_len=MAX_LEN, options=JOptions(
                                level=level, use_pallas=level == "O2",
                                interpret_pallas=True))
        jr = [jeng.submit(p, NEW) for p in prompts]
        jrep = jeng.run()
        jax.effects_barrier()
    params = params_from_numpy(jeng.params, "cpu")
    with _on_jax_routing(routes, flips) if bf16 else \
            contextlib.nullcontext() as taken:
        if bf16:
            Backend.create("torch", device="cpu").clear_cache()
        teng = ServeEngine(tcfg, EngineConfig(
            mode="lockstep", slots=SLOTS, max_len=MAX_LEN, device="cpu",
            params=params), options=CompileOptions(
                level=level, use_pallas=level == "O2"))
        tr = [teng.submit(p, NEW) for p in prompts]
        trep = teng.run()
    assert all(trep.statuses[r] == "completed" for r in tr), trep.statuses
    jt = [jrep.results[r].tolist() for r in jr]
    tt = [trep.results[r].tolist() for r in tr]
    assert all(len(t) == NEW for t in tt)
    if not bf16:
        assert tt == jt
        return
    assert len(taken) == len(routes), (len(taken), len(routes))
    firsts = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   NEW) for a, b in zip(jt, tt)]
    # the dispatches up to the one that gave the first differing token
    # ran on the same tokens in both engines
    agreed = _routers_per_dispatch(routes) * (min(firsts) + 1)
    assert all(g <= 1.0 for n, g in flips if n < agreed), flips
    for r, (a, b) in enumerate(zip(jt, tt)):
        j = firsts[r]
        if j == NEW:
            continue
        seq = np.concatenate([prompts[r], np.asarray(a[:j], np.int32)])
        ties = []
        for lg in _prefill_logits(jcfg, tcfg, jeng.params, level, seq):
            top = np.argsort(-lg, kind="stable")[:2]
            if set(top.tolist()) == {a[j], b[j]}:
                ties.append(float(lg[top[0]] - lg[top[1]])
                            / _bf16_ulp(lg[top[0]]))
        assert ties and min(ties) <= 1, (r, j, a[j], b[j], ties)


@pytest.mark.parametrize("mode", ["donated", "continuous", "paged"])
@pytest.mark.parametrize("arch", ARCHS + ("recurrentgemma-9b",
                                          "xlstm-350m", "whisper-medium",
                                          "llama-3.2-vision-11b"))
def test_other_modes_refuse_with_the_reference_message(arch, mode):
    """Only lockstep serves a non-dense family (the MoE, the recurrent and
    the multimodal ones), as in the reference; the other modes refuse at
    construction with the reference's message."""
    with pytest.raises(NotImplementedError) as jerr:
        JServeEngine(j_get_config(arch).reduced(), mode=mode, slots=2,
                     max_len=16)
    with pytest.raises(NotImplementedError) as terr:
        ServeEngine(get_config(arch).reduced(), EngineConfig(
            mode=mode, slots=2, max_len=16, device="cpu"))
    assert str(terr.value) == str(jerr.value)
    assert "serves via mode='lockstep'" in str(terr.value)


# -- the reference's per-arch smoke cases ---------------------------------------
def _smoke_data(cfg, builder, rng, skv):
    out = []
    for node in builder.inputs:
        t = node.out_types[0]
        if node.name in ("tokens", "labels", "token"):
            out.append(rng.integers(0, cfg.vocab, size=t.shape)
                       .astype(np.int32))
        elif node.name == "pos":
            out.append(np.int32(skv // 2))
        else:
            out.append((rng.normal(size=t.shape) * 0.01).astype(t.dtype))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_smoke(arch):
    """``tests/test_models_smoke.py::test_train_step`` on the port: one IR
    train step (autodiff + AdamW) gives a finite loss and moves the
    parameters -- and the same loss as JAX's step."""
    from repro.models import train_graph as j_tg
    from repro_torch.models import train_graph as t_tg
    jcfg, tcfg = _cfg(j_get_config, arch, "bf16"), \
        _cfg(get_config, arch, "bf16")
    jg = j_lm.build_graphs(jcfg, JShapeConfig("train", "train", S, B), B)
    g = lm.build_graphs(tcfg, ShapeConfig("train", "train", S, B), B)
    jts, ts = j_tg.make_train_step(jg, jcfg), t_tg.make_train_step(g, tcfg)
    assert jts.fn.signature() == ts.fn.signature()
    params = g.builder.init_params(0)
    m, v = t_tg.init_opt_state(g.builder, tcfg, params)
    args = _smoke_data(tcfg, g.builder, np.random.default_rng(0), 32) + \
        [np.int32(0)] + [params[n] for n in ts.param_names] + \
        [m[n] for n in ts.param_names] + [v[n] for n in ts.param_names]
    outs = _port(ts.fn, args, "O2")
    loss = float(np.asarray(outs[0]))
    assert np.isfinite(loss) and 0.0 < loss < 20.0
    moved = sum(float(np.abs(np.asarray(o, np.float32)
                             - np.asarray(params[n], np.float32)).max())
                for o, n in zip(outs[1:1 + len(ts.param_names)],
                                ts.param_names))
    assert moved > 0.0
    jloss = float(np.asarray(JBackend.create("jax").compile(jts.fn)(*args)[0]))
    assert abs(loss - jloss) <= TOL["bf16"] * max(abs(jloss), 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_smoke(arch):
    """``tests/test_models_smoke.py::test_forward_shapes`` on the port:
    prefill and decode give (B, 1, vocab) finite logits, and decode's
    outputs mirror its cache inputs."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(1)
    for kind, seq in (("prefill", S), ("decode", 32)):
        g = lm.build_graphs(cfg, ShapeConfig(kind, kind, seq, B), B)
        params = g.builder.init_params(0)
        outs = _port(g.fn, _smoke_data(cfg, g.builder, rng, 32)
                     + [params[n] for n in g.builder.param_names()], "O2")
        assert np.asarray(outs[0]).shape == (B, 1, cfg.vocab)
        for o in outs:
            assert np.all(np.isfinite(np.asarray(o, np.float32))), kind
        if kind == "decode":
            caches = [n for n in g.builder.inputs
                      if n.name not in ("token", "pos")]
            assert len(outs) - 1 == len(caches)
            for o, n in zip(outs[1:], caches):
                assert np.asarray(o).shape == n.out_types[0].shape


@pytest.mark.parametrize("arch,knob", [
    ("mixtral-8x22b", dict(router_aux_weight=0.0)),
    ("deepseek-v3-671b", dict(router_aux_weight=0.0)),
    ("deepseek-v3-671b", dict(mtp=False))],
    ids=["mixtral-aux", "v3-aux", "v3-mtp"])
def test_train_loss_holds_aux_and_mtp(arch, knob):
    """The router's load-balancing loss (both families) and v3's
    multi-token-prediction loss are terms of the train loss: turning one
    off changes the loss on the same weights and batch."""
    losses = []
    for over in ({}, knob):
        cfg = _cfg(get_config, arch, "f32", **over)
        g = lm.build_graphs(cfg, ShapeConfig("train", "train", S, B), B)
        args = _smoke_data(cfg, g.builder, np.random.default_rng(2), 32)
        params = g.builder.init_params(0)
        losses.append(float(np.asarray(_port(
            g.fn, args + [params[n] for n in g.builder.param_names()],
            "O1")[0])))
    assert np.isfinite(losses).all() and losses[0] != losses[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_cli_trains_the_reduced_arch(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch ... --reduced --device
    cpu``: the IR train step on the CPU, loss falling (exit 0)."""
    from repro_torch.launch import train
    rc = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--steps", "12", "--ckpt-dir", str(tmp_path),
                     "--ckpt-every", "0"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[done] 12 steps on cpu" in out


# -- weights and the serving CLI ------------------------------------------------
def test_params_carry_expert_stacks_and_bf16_exactly():
    """``params_from_numpy`` carries deepseek-v3's 3-D (stacked 4-D) expert
    weights and a bf16 config's parameters bit for bit."""
    cfg = _cfg(get_config, "deepseek-v3-671b", "bf16",
               param_dtype="bf16")
    b = lm.build_graphs(cfg, ShapeConfig("decode", "decode", 16, B),
                        B).builder
    params = b.init_params(0)
    stack = params["moe/moe_we_gate"]
    assert stack.shape == (cfg.n_layers - cfg.first_dense, cfg.n_experts,
                           cfg.d_model, cfg.expert_d_ff)
    t = params_from_numpy(params, "cpu")
    for n, v in params.items():
        assert t[n].dtype == {np.dtype(np.float32): torch.float32}.get(
            v.dtype, torch.bfloat16)
        assert np.array_equal(t[n].float().numpy(),
                              np.asarray(v, np.float32)), n


@pytest.mark.parametrize("arch", ARCHS)
def test_init_on_device_draws_expert_stacks_by_fan_in(arch):
    """``init_params_on_device`` on a bf16 config: every parameter in the
    builder's dtype and shape, and the expert stacks drawn with the
    reference's fan-in scale (``shape[-2]``)."""
    cfg = _cfg(get_config, arch, "bf16", d_model=128, expert_d_ff=256,
               param_dtype="bf16")
    b = lm.build_graphs(cfg, ShapeConfig("decode", "decode", 16, B),
                        B).builder
    got = init_params_on_device(b, 0, "cpu")
    assert set(got) == set(b.param_names())
    for spec in b.params.values():
        assert tuple(got[spec.name].shape) == tuple(spec.shape)
        assert got[spec.name].dtype == torch.bfloat16
    prefix = "moe/" if cfg.mla else "layers/"
    for k, fan in (("moe_we_gate", cfg.d_model),
                   ("moe_we_down", cfg.expert_d_ff)):
        std = float(got[prefix + k].float().std())
        assert abs(std * np.sqrt(fan) - 1.0) < 0.05, (k, std)


@pytest.mark.parametrize("arch", ("deepseek-7b",) + ARCHS)
def test_full_width_weights_come_from_the_family_graph(arch):
    """``serve.py``'s full-width draw reads its parameter names from the
    config family's own decode graph (it drew the dense family's names
    for every ``--arch``); for the dense family they are the fused
    chunk's, which every dense mode compiles."""
    from repro_torch.launch.serve import full_width_builder
    cfg = get_config(arch)
    names = full_width_builder(cfg, 64, 4).param_names()
    want = lm.build_graphs(cfg, ShapeConfig("decode", "decode", 64, 4),
                           4).builder.param_names()
    assert names == want
    if cfg.family == "dense":
        assert names == lm.build_dense_chunk(cfg, 64, 4, 1).builder \
            .param_names()
    else:
        stack = "moe/moe_we_gate" if cfg.mla else "layers/moe_we_gate"
        assert stack in names


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_lockstep_smoke(arch, capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", arch, "--reduced", "--mode", "lockstep",
                     "--device", "cpu", "--level", "O2", "--kernels",
                     "--prompt-len", "8", "--gen", "6", "--smoke"])
    out = capsys.readouterr().out
    assert rc == 0 and "[serve:lockstep]" in out and "[smoke] ok" in out


def test_serve_cli_refuses_a_non_lockstep_moe_mode():
    """An explicit ``--mode paged`` on a non-dense family is the
    reference's ``SystemExit``, word for word (no silent fallback to a
    mode that ignores the page and sampling flags)."""
    from repro.launch import serve as j_serve
    from repro_torch.launch import serve
    argv = ["--arch", "mixtral-8x22b", "--reduced", "--mode", "paged"]
    with pytest.raises(SystemExit) as terr:
        serve.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jerr:
        j_serve.main(argv)
    assert str(terr.value) == str(jerr.value)
    assert "only serves via --mode lockstep" in str(terr.value)


@pytest.mark.parametrize("flag", [["--temperature", "0.5"],
                                  ["--top-k", "4"],
                                  ["--prefill-chunk", "8"],
                                  ["--no-prefix-sharing"]],
                         ids=["temperature", "top_k", "prefill_chunk",
                              "no_prefix_sharing"])
def test_serve_cli_refuses_paged_flags_outside_paged(flag):
    """Sampling, page, chunk and prefill flags outside paged mode are the
    reference's clean ``SystemExit`` (the default mode, continuous, and a
    non-dense family's lockstep fallback alike), not a traceback."""
    from repro.launch import serve as j_serve
    from repro_torch.launch import serve
    for arch in ("deepseek-7b", "mixtral-8x22b"):
        argv = ["--arch", arch, "--reduced"] + flag
        with pytest.raises(SystemExit) as terr:
            serve.main(argv + ["--device", "cpu"])
        with pytest.raises(SystemExit) as jerr:
            j_serve.main(argv)
        assert str(terr.value) == str(jerr.value) and \
            "--mode paged" in str(terr.value)


def _f32_reduced(monkeypatch, *config_classes):
    """Both packages' ``ModelConfig.reduced`` compute in f32 while open."""
    for cls in config_classes:
        red = cls.reduced
        monkeypatch.setattr(cls, "reduced", lambda self, _r=red, **o:
                            _r(self, **dict(o, compute_dtype="f32")))


def test_serve_cli_lockstep_fallback_matches_the_reference(monkeypatch,
                                                           capsys):
    """``repro_torch.launch.serve --arch mixtral-8x22b --reduced`` with no
    ``--mode``: the reference's notice, lockstep, exit 0, and the tokens
    ``repro.launch.serve`` prints for the same flags.  In bf16 the two
    MoE engines may split a router or logit near-tie (the module
    docstring), so the tokens are compared in f32, where they are
    identical; the bf16 run is held to the notice and exit code."""
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.launch import serve as j_serve
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch import serve
    argv = ["--arch", "mixtral-8x22b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
    notice = ("[serve] mixtral-8x22b-smoke (moe): no serve/chunk graphs "
              "yet, falling back to --mode lockstep")
    assert serve.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert notice in out and "[serve:lockstep]" in out
    _f32_reduced(monkeypatch, ModelConfig, JModelConfig)
    outs = []
    for main, extra in ((serve.main, ["--device", "cpu"]),
                        (j_serve.main, [])):
        assert main(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    toks = [[ln for ln in o.splitlines() if ln.startswith("  req")]
            for o in outs]
    assert all(notice in o for o in outs)
    assert len(toks[0]) == 2 and toks[0] == toks[1]


def test_smoke_kernels_follow_the_family():
    from repro_torch.launch.serve import smoke_kernels
    need, refuse = smoke_kernels(get_config("mixtral-8x22b"))
    assert need == {"matmul", "norm_matmul", "rmsnorm", "flash_attention",
                    "batched_matmul"}
    assert refuse == set()
    need, refuse = smoke_kernels(get_config("deepseek-v3-671b"))
    assert "swiglu" in need and "flash_attention" in need
    assert refuse == {"flash_attention"}
    need, _ = smoke_kernels(get_config("deepseek-7b"), attention=False)
    assert "flash_attention" not in need and "swiglu" in need


# -- on the card ----------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_lockstep_matches_the_cpu_in_f32(arch):
    """At the d_head-128 width in f32: lockstep on the card (kernels,
    flash in the prefill and -- for MLA -- the absorbed decode) gives the
    CPU's greedy tokens; every kernel of the path launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import kernels
    cfg = _cfg(get_config, arch, "f32", "dh128")
    params = lm.build_graphs(cfg, ShapeConfig("decode", "decode", MAX_LEN,
                                              SLOTS), SLOTS) \
        .builder.init_params(0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, 12).astype(np.int32)
               for _ in range(SLOTS)]
    toks = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_counters()
        eng = ServeEngine(cfg, EngineConfig(
            mode="lockstep", slots=SLOTS, max_len=MAX_LEN, device=dev,
            params=params_from_numpy(params, dev)),
            options=CompileOptions(level="O2", use_pallas=True))
        rids = [eng.submit(p, NEW) for p in prompts]
        rep = eng.run()
        toks[dev] = [rep.results[r].tolist() for r in rids]
        if dev == "cuda":
            counts = kernels.counters()
    assert toks["cuda"] == toks["cpu"]
    from repro_torch.launch.serve import smoke_kernels
    need, _ = smoke_kernels(cfg)
    assert all(counts[k]["launches"] > 0 for k in need), counts


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_graphs_match_jax(arch):
    """The families' prefill and decode graphs on the card at O2 against
    JAX at O1 (f32, d_head 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for kind in ("prefill", "decode"):
        jc, tc, jg, tg = _graphs(arch, kind, "f32", "dh128")
        args = _inputs(jg, jc, np.random.default_rng(5))
        ref = JBackend.create("jax").compile(jg.fn,
                                             JOptions(level="O1"))(*args)
        got = Backend.create("torch", device="cuda").compile(
            tg.fn, CompileOptions(level="O2", use_pallas=True))(*args)
        for a, b in zip(ref, got):
            assert _rel_err(a, b) <= TOL["f32"], kind
