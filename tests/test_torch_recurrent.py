"""The recurrent families on torch, part one: ``LinearRecurrence`` and
recurrentgemma-9b (``rg_hybrid``) against the JAX package on the CPU
(xlstm-350m is ``tests/test_torch_xlstm.py``; both files share the
full-width kernel census below).

``LinearRecurrence`` is the emitter's log-depth doubling scan against
JAX's ``lax.associative_scan`` and the port's sequential interpreter,
forward and reversed, in f32 and bf16; within torch its bits do not
depend on a row's batch.  The RG-LRU (``rg_lru``) and the causal conv
(``_conv1d``) are held alone, with and without their decode state; every
graph kind of the family at torch O1 and O2 (the kernels' plain
versions) against JAX O1, on the builder's seeded weights; the lockstep
engine's f32 greedy tokens against the JAX engine's on its weights
(``params_from_numpy``); the prefill-to-decode cache map and the long
decode's constant state; and five f32 train steps against the JAX
trainer.  Tolerances are ``scripts/check_kernel_parity.py``'s: 1e-4 of
scale in f32, 3e-2 in bf16 (an f32 output of a bf16 graph, such as the
RG-LRU state, is computed from bf16 values and held at bf16's), with
identical logits argmax.
"""
import collections
import contextlib
import dataclasses

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
from repro.models import recurrent as j_rg  # noqa: E402
from repro.models import train_graph as j_tg  # noqa: E402
from repro.models.builder import ModelBuilder as JBuilder  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.backend import Backend, CompileOptions  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import ops as t_ops  # noqa: E402
from repro_torch.core.function import Function as TFunction  # noqa: E402
from repro_torch.core.passes import run_pipeline  # noqa: E402
from repro_torch.devices import torch_dtype  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.launch.serve import smoke_kernels  # noqa: E402
from repro_torch.launch.train import step_data  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import recurrent as t_rg  # noqa: E402
from repro_torch.models import train_graph as t_tg  # noqa: E402
from repro_torch.models.builder import ModelBuilder as TBuilder  # noqa: E402
from repro_torch.models.weights import (init_params_on_device,  # noqa: E402
                                        params_from_numpy)
from repro_torch.runtime.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.transformers.interpreter import EVAL  # noqa: E402
from repro_torch.transformers.torch_emit import (EMIT, EmitCtx,  # noqa: E402
                                                 emit_callable)

ARCH = "recurrentgemma-9b"
TOL = {"f32": 1e-4, "bf16": 3e-2}
NP_DT = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}
B, S = 2, 16
# five f32 train steps' update against JAX's: its norm within f32's
# tolerance, its direction within UPDATE_L2 in L2 over its norm.  AdamW
# scales each gradient element to about +-lr, so an element whose f32
# gradient lies a rounding from zero flips its whole update: xlstm's
# sLSTM gate biases (zeros at the start) move 1.25e-3 off JAX's update,
# and the reference's own numpy interpreter moves them 1.29e-3 off
UPDATE_L2 = 1e-2
# the d_head-128 width: flash carries the Attention op on the card
DH128 = dict(d_model=256, n_heads=2, n_kv_heads=2, d_head=128, d_ff=256)


def _rel_err(ref, got) -> float:
    a = np.asarray(ref, np.float64)
    b = np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1.0)


def _hold(where, ref, got, dtype):
    err = _rel_err(ref, got)
    assert err <= TOL[dtype], f"{where}: {err:.3e} of scale > {TOL[dtype]}"


def _port(fn, args, level="O2", device="cpu"):
    be = Backend.create("torch", device=device, fresh=True)
    return be.compile(fn, CompileOptions(level=level,
                                         use_pallas=level == "O2"))(*args)


def _jax(fn, args):
    return JBackend.create("jax").compile(fn, JOptions(level="O1"))(*args)


def _cfg(get, arch=ARCH, dtype="f32", width="reduced", **over):
    if width == "dh128":
        over = dict(DH128, **over)
    return get(arch).reduced(compute_dtype=dtype, **over)


def graphs(arch, kind, dtype, width="reduced", **over):
    """The two packages' ``kind`` graphs of ``arch`` (same signature)."""
    jc = _cfg(j_get_config, arch, dtype, width, **over)
    tc = _cfg(get_config, arch, dtype, width, **over)
    jg = j_lm.build_graphs(jc, JShapeConfig(kind, kind, S, B), B)
    tg = lm.build_graphs(tc, ShapeConfig(kind, kind, S, B), B)
    assert jg.fn.signature() == tg.fn.signature()
    return jc, tc, jg, tg


def inputs(g, cfg, rng):
    """The graph's inputs: token ids, a decode position inside the
    cache, caches and recurrent states, the builder's seeded weights."""
    params = g.builder.init_params(0)
    out = []
    for node in g.builder.inputs:
        t = node.out_types[0]
        if node.name in ("tokens", "labels", "token"):
            out.append(rng.integers(0, cfg.vocab, size=t.shape)
                       .astype(np.int32))
        elif node.name == "pos":
            out.append(np.int32(S // 2))
        else:   # caches and states
            out.append((rng.normal(size=t.shape) * 0.5).astype(t.dtype))
    return out + [params[n] for n in g.builder.param_names()]


def hold_graph(arch, kind, dtype):
    """``kind`` at torch O1 and O2 against JAX O1, output by output; f32
    logits with JAX's argmax."""
    jc, tc, jg, tg = graphs(arch, kind, dtype)
    args = inputs(jg, jc, np.random.default_rng(5))
    ref = _jax(jg.fn, args)
    for level in ("O1", "O2"):
        got = _port(tg.fn, args, level)
        assert len(got) == len(ref)
        for i, (a, b) in enumerate(zip(ref, got)):
            _hold(f"{kind} {level} output {i}", a, b, dtype)
        if kind != "train":
            assert np.array_equal(np.asarray(ref[0], np.float32).argmax(-1),
                                  np.asarray(got[0], np.float32).argmax(-1))


def lockstep_tokens(arch, level, width="reduced"):
    """f32 greedy tokens of both lockstep engines on the JAX engine's
    weights, 2 slots of 12 prompt tokens and 8 new ones: (JAX's, the
    port's)."""
    jcfg = _cfg(j_get_config, arch, "f32", width)
    tcfg = _cfg(get_config, arch, "f32", width)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab, 12).astype(np.int32)
               for _ in range(B)]
    jeng = JServeEngine(jcfg, mode="lockstep", slots=B, max_len=24,
                        options=JOptions(level=level,
                                         use_pallas=level == "O2",
                                         interpret_pallas=True))
    jr = [jeng.submit(p, 8) for p in prompts]
    jrep = jeng.run()
    teng = ServeEngine(tcfg, EngineConfig(
        mode="lockstep", slots=B, max_len=24, device="cpu",
        params=params_from_numpy(jeng.params, "cpu")),
        options=CompileOptions(level=level, use_pallas=level == "O2"))
    tr = [teng.submit(p, 8) for p in prompts]
    trep = teng.run()
    assert all(trep.statuses[r] == "completed" for r in tr), trep.errors
    return ([jrep.results[r].tolist() for r in jr],
            [trep.results[r].tolist() for r in tr])


def cache_name_map(arch):
    """``tests/test_serving.py::test_cache_name_map_prefill_to_decode``:
    prefill output i is the decode input ``aux["cache_names"][i]``, whose
    type it matches but along ``kv_seq``; the decode's state outputs are
    named, each the type of the input it updates."""
    cfg = get_config(arch).reduced()
    P = 8
    pre = lm.build_graphs(cfg, ShapeConfig("prefill", "prefill", P, B), B)
    dec = lm.build_graphs(cfg, ShapeConfig("decode", "decode", P, B), B)
    names = pre.aux["cache_names"]
    assert names == dec.aux["cache_names"]
    assert len(names) == len(pre.fn.results) - 1
    dec_inputs = {n.name: n.out_types[0] for n in dec.builder.inputs}
    for i, name in enumerate(names):
        pt, dt = pre.fn.results[1 + i].type, dec_inputs[name]
        spec = tuple(dec.builder.input_specs[name])
        for ax, (a, b) in enumerate(zip(pt.shape, dt.shape)):
            if "kv_seq" in spec and ax == spec.index("kv_seq"):
                assert a <= b
            else:
                assert a == b, (name, ax, pt, dt)
    out_names = dec.aux["state_out_names"]
    assert sorted(out_names) == sorted(n for n in dec_inputs
                                       if n not in ("token", "pos"))
    for i, name in enumerate(out_names):
        assert dec.fn.results[1 + i].type == dec_inputs[name], name
    return names, out_names


def long_decode_state_is_constant(arch):
    """``tests/test_models_smoke.py::test_long_decode_sub_quadratic``: no
    input of the 524,288-token decode graph scales with the context."""
    cfg = get_config(arch).reduced()
    g = lm.build_graphs(cfg, ShapeConfig("long", "long_decode", 1 << 19,
                                         B), B)
    for node in g.builder.inputs:
        t = node.out_types[0]
        assert t.size < 1 << 22, f"{node.name} scales: {t.shape}"


def five_train_steps(arch, level, **over):
    """Five f32 train steps (IR autodiff + AdamW) on SyntheticLM batches
    (and the trainer's stubbed frames or images, ``train.step_data``):
    the port at ``level`` against the JAX backend at O1: the losses and
    the final parameters within 1e-4 of scale, each AdamW moment within
    1e-4 of its own norm, each update in norm and direction as
    :data:`UPDATE_L2` says.  ``over`` overrides the reduced config."""
    jcfg = _cfg(j_get_config, arch, "f32", **over)
    tcfg = _cfg(get_config, arch, "f32", **over)
    jg = j_lm.build_graphs(jcfg, JShapeConfig("train", "train", S, B), B)
    g = lm.build_graphs(tcfg, ShapeConfig("train", "train", S, B), B)
    jts, ts = j_tg.make_train_step(jg, jcfg), t_tg.make_train_step(g, tcfg)
    assert jts.fn.signature() == ts.fn.signature()
    params = g.builder.init_params(0)
    m, v = t_tg.init_opt_state(g.builder, tcfg, params)
    data = SyntheticLM(DataConfig(tcfg.vocab, S, B, seed=0))
    batches = [data.batch(s) for s in range(5)]
    names = ts.param_names
    start = [params[k] for k in names] + [m[k] for k in names] + \
        [v[k] for k in names]
    runs = []
    for cf in (JBackend.create("jax").compile(jts.fn, JOptions(level="O1")),
               Backend.create("torch", device="cpu").compile(
                   ts.fn, CompileOptions(level=level,
                                         use_pallas=level == "O2"))):
        flat, losses = list(start), []
        for i, bt in enumerate(batches):
            outs = cf(*step_data(tcfg, g.builder, bt, 0, i, B), np.int32(i),
                      *flat)
            losses.append(float(np.asarray(outs[0])))
            flat = [np.asarray(o) for o in outs[1:]]
        runs.append((losses, flat))
    (jl, jflat), (tl, tflat) = runs
    assert np.isfinite(tl).all()
    for i, (a, b) in enumerate(zip(jl, tl)):
        _hold(f"loss at step {i}", a, b, "f32")
    n = len(names)
    for i, name in enumerate(names):
        if np.asarray(start[i]).size == 0:
            # deepseek-v3's MoE stacks when every layer is dense: length 0
            for j in (i, n + i, 2 * n + i):
                assert np.shape(tflat[j]) == np.shape(jflat[j]), name
            continue
        _hold(f"parameter {name}", jflat[i], tflat[i], "f32")
        for k, j in (("m", n + i), ("v", 2 * n + i)):
            ref = np.asarray(jflat[j], np.float64)
            err = np.linalg.norm(np.asarray(tflat[j], np.float64) - ref)
            assert err <= TOL["f32"] * np.linalg.norm(ref), (k, name, err)
        # the update itself, which is far below the parameter's scale
        d_ref = np.asarray(jflat[i], np.float64) - start[i]
        d_got = np.asarray(tflat[i], np.float64) - start[i]
        norm = np.linalg.norm(d_ref)
        assert norm > 0, name
        assert abs(np.linalg.norm(d_got) / norm - 1) <= TOL["f32"], name
        err = np.linalg.norm(d_got - d_ref) / norm
        assert err <= UPDATE_L2, f"{name}: update off by {err:.3e} in L2"


# -- the full-width kernel census (shapes only, on the meta device) -----------
_REFS = {"matmul": kref.matmul_ref, "norm_matmul": kref.norm_matmul_ref,
         "swiglu": kref.swiglu_ref, "rmsnorm": kref.rmsnorm_ref,
         "flash_attention": kref.flash_attention_ref,
         "batched_matmul": kref.batched_matmul_ref}


@contextlib.contextmanager
def _meta_kernels(launched: collections.Counter,
                  refused: collections.Counter):
    """While open, each kernel wrapper called on a meta tensor adds one
    to ``launched`` and returns its plain version's (shape-only) result,
    and each predicate that refuses a meta operand adds one to
    ``refused``: the emitter's choices at full width, without memory."""
    saved = []
    for name, mod in kernels.MODULES.items():
        fn, sup = getattr(mod, name), mod.supported
        saved.append((mod, name, fn, sup))

        def call(*a, _n=name, _f=fn, **kw):
            if not a[0].is_meta:
                return _f(*a, **kw)
            launched[_n] += 1
            return _REFS[_n](*a, **kw)

        def check(*a, _n=name, _s=sup, **kw):
            ok = _s(*a, **kw)
            if not ok and a[0].is_meta:
                refused[_n] += 1
            return ok
        setattr(mod, name, call)
        mod.supported = check
    try:
        yield
    finally:
        for mod, name, fn, sup in saved:
            setattr(mod, name, fn)
            mod.supported = sup


def full_width_census(cfg, kind, seq, batch):
    """(kernel launches, refusals) of one call of ``cfg``'s ``kind`` graph
    at O2 with the kernels, in bf16, walked on the meta device."""
    g = lm.build_graphs(cfg, ShapeConfig(kind, kind, seq, batch), batch)
    opt, _ = run_pipeline(g.fn, "O2", fuse={"swiglu": True,
                                            "norm_matmul": True,
                                            "rotary_qkv": True})
    run = emit_callable(opt, EmitCtx(torch.device("meta"), use_pallas=True))
    args = [torch.empty(p.out_types[0].shape,
                        dtype=torch_dtype(p.out_types[0].dtype),
                        device="meta") for p in opt.parameters]
    launched, refused = collections.Counter(), collections.Counter()
    with _meta_kernels(launched, refused):
        outs = run(*args)
    assert outs[0].shape == (batch, 1, cfg.vocab)
    return dict(launched), dict(refused)


def hold_census(cfg, cases, flash_per_call):
    """Each (kind, seq, batch) of ``cases`` launches exactly the kernels
    ``serve.smoke_kernels`` writes down for the family, refuses only
    what it allows, and calls flash ``flash_per_call`` times."""
    need, may_refuse = smoke_kernels(cfg)
    for kind, seq, batch in cases:
        launched, refused = full_width_census(cfg, kind, seq, batch)
        assert set(launched) == need, (kind, seq, launched)
        assert set(refused) <= may_refuse, (kind, seq, refused)
        assert launched.get("flash_attention", 0) == flash_per_call, \
            (kind, seq, launched)


# -- LinearRecurrence -----------------------------------------------------------
def _recurrence_fn(ops, Function, shape, axis, dtype):
    a = ops.parameter(shape, dtype, "a")
    b = ops.parameter(shape, dtype, "b")
    ga = ops.sigmoid(a.out())
    return Function([a, b], [
        ops.linear_recurrence(ga, b.out(), axis=axis),
        ops.linear_recurrence(ga, b.out(), axis=axis, reverse=True)])


def _recurrence_args(shape, dtype, rng):
    return [(rng.normal(size=shape) * 2 + 2).astype(np.float32)
            .astype(NP_DT[dtype]),
            rng.normal(size=shape).astype(np.float32).astype(NP_DT[dtype])]


def _shape(length, axis):
    return (2, length, 3, 4) if axis == 1 else (2, 3, length, 4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("axis", [-2, 1])
@pytest.mark.parametrize("length", [1, 5, 64, 257])
def test_linear_recurrence_matches_jax(length, axis, dtype):
    """The doubling scan (torch backend) and the sequential interpreter
    against JAX's associative scan, forward and reversed, along ``axis``
    of a 4-D operand; a in (0, 1) as the RG-LRU's decay is."""
    shape = _shape(length, axis)
    jfn = _recurrence_fn(j_ops, JFunction, shape, axis, dtype)
    tfn = _recurrence_fn(t_ops, TFunction, shape, axis, dtype)
    assert jfn.signature() == tfn.signature()
    args = _recurrence_args(shape, dtype, np.random.default_rng(length))
    ref = _jax(jfn, args)
    got = _port(tfn, args, "O1")
    interp = Backend.create("interpreter").compile(tfn)(*args)
    for i in range(2):
        assert np.asarray(got[i]).dtype == np.asarray(ref[i]).dtype
        _hold(f"torch output {i}", ref[i], got[i], dtype)
        _hold(f"interpreter output {i}", ref[i], interp[i], dtype)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_linear_recurrence_rows_are_bitwise_alone_and_in_a_batch(dtype,
                                                                 reverse):
    """Within torch the scan's bits depend only on a row's own values:
    two runs agree, and each row of a batch of 5 (2,176 steps, rg's long
    prefill) equals the row run alone; the result stays within 1e-4 of
    the interpreter's sequential f32 loop (the emitter runs bf16 in
    f32)."""
    rng = np.random.default_rng(11)
    L, C = 2176, 8
    a, b = _recurrence_args((5, L, C), dtype, rng)
    node = t_ops.linear_recurrence(
        t_ops.parameter(a.shape, dtype, "a").out(),
        t_ops.parameter(b.shape, dtype, "b").out(), axis=-2,
        reverse=reverse).node
    ctx = EmitCtx(torch.device("cpu"))
    ta = torch.sigmoid(torch.from_numpy(a.astype(np.float32))).to(
        torch_dtype(dtype))
    tb = torch.from_numpy(b.astype(np.float32)).to(torch_dtype(dtype))
    full = EMIT["LinearRecurrence"](node, [ta, tb], ctx)[0]
    again = EMIT["LinearRecurrence"](node, [ta, tb], ctx)[0]
    assert torch.equal(full, again)
    one = t_ops.linear_recurrence(
        t_ops.parameter((1, L, C), dtype, "a").out(),
        t_ops.parameter((1, L, C), dtype, "b").out(), axis=-2,
        reverse=reverse).node
    for r in (0, 3):
        alone = EMIT["LinearRecurrence"](one, [ta[r:r + 1], tb[r:r + 1]],
                                         ctx)[0]
        assert torch.equal(alone, full[r:r + 1]), r
    seq = EVAL["LinearRecurrence"](node, [ta.float().numpy(),
                                          tb.float().numpy()])[0]
    _hold("against the sequential loop", seq, full.float().numpy(), "f32"
          if dtype == "f32" else "bf16")


# -- the RG-LRU and the causal conv ------------------------------------------
LRU_C = 64    # 16 gate blocks of 4


def _lru_fn(ops, Function, Builder, rg, dtype, state):
    b = Builder("f32", dtype)
    s = 1 if state else 9
    u = ops.parameter((B, s, LRU_C), dtype, "u")
    specs = rg.rg_specs(32, LRU_C, 4)
    ws = {n: ops.parameter(specs[n][0], "f32", n)
          for n in ("w_a", "w_i", "lam")}
    params = [u] + list(ws.values())
    h0 = None
    if state:
        h0 = ops.parameter((B, 1, LRU_C), "f32", "h")
        params.append(h0)
        h0 = h0.out()
    h, new_h = rg.rg_lru(u.out(), {f"p_{n}": w.out() for n, w in ws.items()},
                         "p_", b, h_state=h0)
    return Function(params, [h] + ([new_h] if state else []), "rg_lru")


def _conv_fn(ops, Function, rg, dtype, state):
    u = ops.parameter((B, 9, LRU_C), dtype, "u")
    w = ops.parameter((4, LRU_C), "f32", "w")
    bias = ops.parameter((LRU_C,), "f32", "b")
    params = [u, w, bias]
    tail = None
    if state:
        tail = ops.parameter((B, 3, LRU_C), dtype, "tail")
        params.append(tail)
        tail = tail.out()
    out, new_tail = rg._conv1d(u.out(), w.out(), bias.out(), tail=tail)
    return Function(params, [out, new_tail], "conv1d")


@pytest.mark.parametrize("state", [False, True],
                         ids=["parallel", "decode_state"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["rg_lru", "conv1d"])
def test_rg_pieces_match_jax(which, dtype, state):
    """``rg_lru`` (the recurrence over 9 steps, or one decode step from an
    f32 state ``h``) and ``_conv1d`` (left-padded, or after a decode
    tail) at torch O1 and O2 against JAX."""
    rng = np.random.default_rng(4)
    if which == "rg_lru":
        jfn = _lru_fn(j_ops, JFunction, JBuilder, j_rg, dtype, state)
        tfn = _lru_fn(t_ops, TFunction, TBuilder, t_rg, dtype, state)
    else:
        jfn = _conv_fn(j_ops, JFunction, j_rg, dtype, state)
        tfn = _conv_fn(t_ops, TFunction, t_rg, dtype, state)
    assert jfn.signature() == tfn.signature()
    args = []
    for p in jfn.parameters:
        t = p.out_types[0]
        scale = 0.3 if p.name in ("w_a", "w_i", "w") else 1.0
        args.append((rng.normal(size=t.shape) * scale).astype(np.float32)
                    .astype(t.dtype))
    ref = _jax(jfn, args)
    for level in ("O1", "O2"):
        got = _port(tfn, args, level)
        for i, (a, b) in enumerate(zip(ref, got)):
            _hold(f"{which} {level} output {i}", a, b, dtype)


# -- the family's graphs, engine and trainer ----------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode",
                                  "long_decode"])
def test_graph_matches_jax(kind, dtype):
    """Every graph kind of the reduced family (two (rec, rec, attn)
    groups' worth: one group and the two-rec tail), torch O1 and O2
    against JAX O1."""
    hold_graph(ARCH, kind, dtype)


@pytest.mark.parametrize("level,width", [("O1", "reduced"),
                                         ("O2", "reduced"),
                                         ("O2", "dh128")])
def test_lockstep_tokens_match_jax(level, width):
    """``ServeEngine(mode="lockstep")`` serves the family: f32 greedy
    tokens equal the JAX engine's (its decode starts the RG-LRU states
    and conv tails from zeros, as the reference's does).  At d_head 128
    both engines' attention takes flash (JAX's Pallas kernel in
    interpret mode, the port's plain version); the 12-token prompts and
    8 new tokens cross the reduced 8-token window."""
    jt, tt = lockstep_tokens(ARCH, level, width)
    assert tt == jt


def test_lockstep_decode_starts_recurrent_states_from_zeros():
    """The reference's property the port copies: the prefill exports only
    the attention caches, so the lockstep decode's conv tails and
    RG-LRU states start at zero while its attention caches hold the
    prefill's rows."""
    cfg = _cfg(get_config)
    eng = ServeEngine(cfg, EngineConfig(mode="lockstep", slots=B,
                                        max_len=S, device="cpu"))
    P = 6
    g, cf, pvals = eng._prefill_for(P, B)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P)).astype(np.int32)
    outs = cf(prompts, *pvals)
    caches = dict(zip(eng.cache_names, eng._init_caches(g, outs[1:])))
    assert set(caches) == set(eng.graphs.aux["state_out_names"])
    for name, c in caches.items():
        if name in g.aux["cache_names"]:
            got = np.asarray(outs[1 + g.aux["cache_names"].index(name)])
            assert np.array_equal(c[:, :, :, :P], got), name
            assert not c[:, :, :, P:].any(), name
        else:
            assert name.endswith(("_tail", "_h")), name
            assert not np.asarray(c, np.float32).any(), name


def test_cache_name_map_prefill_to_decode():
    names, out_names = cache_name_map(ARCH)
    assert names == ["g_2_ck", "g_2_cv"]
    assert out_names[:4] == ["g_0_tail", "g_0_h", "g_1_tail", "g_1_h"]


def test_long_decode_state_does_not_grow_with_context():
    long_decode_state_is_constant(ARCH)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_five_train_steps_match_the_jax_backend(level):
    five_train_steps(ARCH, level)


def test_init_on_device_draws_the_rg_initializers():
    """``init_params_on_device`` covers the block's initializers: fan-in
    for the projections, ``normal_init(0.1)`` for ``conv_w``, 0.5 for
    ``lam``, zeros for ``conv_b``, ones for the norms."""
    cfg = _cfg(get_config, d_model=256, lru_width=1024)
    b = lm.build_graphs(cfg, ShapeConfig("decode", "decode", S, B),
                        B).builder
    got = init_params_on_device(b, 0, "cpu")
    assert set(got) == set(b.param_names())
    for spec in b.params.values():
        assert tuple(got[spec.name].shape) == tuple(spec.shape)
    g = {n.split("/")[-1]: t for n, t in got.items()
         if n.startswith("groups/")}
    for name, std in (("b0_rec_w_x", 256 ** -0.5), ("b0_rec_conv_w", 0.1),
                      ("b0_rec_lam", 0.5), ("b0_rec_w_a", 0.02)):
        assert abs(float(g[name].float().std()) / std - 1) < 0.1, name
    assert not g["b0_rec_conv_b"].any()
    assert bool((g["b0_ln1_g"] == 1).all())


def test_serve_cli_lockstep_smoke(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--arch", ARCH, "--reduced", "--mode", "lockstep",
                     "--device", "cpu", "--level", "O2", "--kernels",
                     "--prompt-len", "8", "--gen", "6", "--smoke"])
    out = capsys.readouterr().out
    assert rc == 0 and "[serve:lockstep]" in out and "[smoke] ok" in out


# -- full width: the kernels the card's path launches -------------------------
@pytest.mark.parametrize("arch", [ARCH, "xlstm-350m"])
def test_smoke_kernels_name_the_recurrent_paths(arch):
    need, refuse = smoke_kernels(get_config(arch))
    if arch == ARCH:
        assert need == set(kernels.MODULES)
    else:   # GeLU-gated FFN, no Attention op
        assert need == {"matmul", "norm_matmul", "rmsnorm", "batched_matmul"}
    assert refuse == set()


def test_full_width_rg_launches_the_written_kernels():
    """recurrentgemma-9b at full width, depth 8 (two groups and the tail),
    at ``chip_smoke.py`` phase 10's shapes: every kernel
    ``smoke_kernels`` names launches, nothing is refused, and flash runs
    once per attention layer and call (2)."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=8)
    hold_census(cfg, [("prefill", 128, 4), ("decode", 144, 4),
                      ("prefill", 2176, 1), ("decode", 2184, 1)], 2)


# -- on the card -----------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cuda_linear_recurrence_equals_the_cpu(dtype):
    """The scan on the card gives the CPU's bits (each product and sum is
    one rounded op on both), forward and reversed, at rg's prefill
    widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for shape in ((4, 128, 4096), (1, 2176, 4096)):
        a, b = _recurrence_args(shape, dtype, np.random.default_rng(3))
        ta = torch.sigmoid(torch.from_numpy(a.astype(np.float32))).to(
            torch_dtype(dtype))
        tb = torch.from_numpy(b.astype(np.float32)).to(torch_dtype(dtype))
        for reverse in (False, True):
            node = t_ops.linear_recurrence(
                t_ops.parameter(shape, dtype, "a").out(),
                t_ops.parameter(shape, dtype, "b").out(), axis=-2,
                reverse=reverse).node
            cpu = EMIT["LinearRecurrence"](node, [ta, tb],
                                           EmitCtx(torch.device("cpu")))[0]
            card = EMIT["LinearRecurrence"](
                node, [ta.cuda(), tb.cuda()], EmitCtx(torch.device("cuda")))[0]
            assert torch.equal(card.cpu(), cpu), (shape, reverse)


@pytest.mark.cuda
def test_cuda_dh128_graphs_match_jax():
    """The family's prefill and decode graphs on the card at O2 (flash at
    d_head 128) against JAX O1, f32; flash launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for kind in ("prefill", "decode"):
        jc, tc, jg, tg = graphs(ARCH, kind, "f32", "dh128")
        args = inputs(jg, jc, np.random.default_rng(5))
        ref = _jax(jg.fn, args)
        kernels.reset_counters()
        got = _port(tg.fn, args, "O2", device="cuda")
        assert kernels.counters()["flash_attention"]["launches"] > 0
        for i, (a, b) in enumerate(zip(ref, got)):
            _hold(f"{kind} output {i}", a, b, "f32")
