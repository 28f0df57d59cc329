"""The torch emitter against the JAX emitter on the same numpy inputs.

Every op of the O1 and O2 reduced paged chunk and paged prefill graphs
is emitted by ``repro_torch.transformers.torch_emit`` and by the JAX
package's emitter (its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them).  Integer outputs (sampled tokens)
must be identical; float outputs agree within 1e-4 of scale in f32 and
3e-2 in bf16 (the tolerances of ``scripts/check_kernel_parity.py``).
The edge semantics the paged graphs rely on are pinned one op at a time.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import Backend as JBackend  # noqa: E402
from repro.backend import CompileOptions as JOptions  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402

from repro_torch.backend import Backend as TBackend  # noqa: E402
from repro_torch.backend import CompileOptions as TOptions  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import ops as t_ops  # noqa: E402
from repro_torch.core.function import Function as TFunction  # noqa: E402
from repro_torch.core.passes import run_pipeline  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.transformers import torch_emit  # noqa: E402

MAX_LEN, SLOTS, STEPS, PS, PAGES, CHUNK = 32, 4, 3, 8, 17, 8


def _cfg(get_config, dtype):
    cfg = get_config("deepseek-7b").reduced()
    return dataclasses.replace(cfg, compute_dtype=dtype)


def _graph(lm, cfg, kind):
    if kind == "chunk":
        return lm.build_dense_chunk(cfg, MAX_LEN, SLOTS, STEPS,
                                    page_size=PS, n_pages=PAGES)
    return lm.build_dense_paged_prefill(cfg, MAX_LEN, CHUNK, page_size=PS,
                                        n_pages=PAGES)


def _inputs(g, cfg, seed=0):
    """Weights from the JAX builder's numpy init; step inputs and a
    random KV pool from one numpy generator."""
    rng = np.random.default_rng(seed)
    params = g.builder.init_params(0)
    mp = -(-MAX_LEN // PS)
    args = []
    for node in g.fn.parameters:
        t = node.out_types[0]
        name = node.name
        if name in params:
            args.append(params[name])
        elif name == "token":
            args.append(rng.integers(0, cfg.vocab, t.shape).astype(np.int32))
        elif name == "pos":
            hi = MAX_LEN - STEPS - CHUNK
            args.append(rng.integers(1, hi, t.shape).astype(np.int32))
        elif name == "page_tbl":
            args.append(rng.integers(1, PAGES, (t.shape[0], mp))
                        .astype(np.int32))
        elif name in ("temperature", "top_k", "key"):
            args.append(np.zeros(t.shape, t.dtype))   # greedy rows
        else:
            args.append((rng.normal(size=t.shape) * 0.5).astype(t.dtype))
    return args


def _close(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, name
    if a.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b, err_msg=name)
        return
    af, bf = a.astype(np.float64), b.astype(np.float64)
    tol = 3e-2 if "bfloat16" in str(a.dtype) else 1e-4
    scale = max(float(np.abs(af).max()), 1.0)
    diff = float(np.abs(af - bf).max())
    assert diff <= tol * scale, f"{name}: max diff {diff} > {tol * scale}"


def _walk_ops(fn, seen):
    for n in fn.nodes():
        seen.add(n.op)
        if n.op == "Scan":
            _walk_ops(n.attrs["body"], seen)
    return seen


@pytest.mark.parametrize("kind", ["chunk", "prefill"])
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_graphs_match_jax(kind, level, dtype):
    jcfg = _cfg(j_get_config, dtype)
    tcfg = _cfg(t_get_config, dtype)
    jg = _graph(j_lm, jcfg, kind)
    tg = _graph(t_lm, tcfg, kind)
    assert jg.fn.signature() == tg.fn.signature()
    pallas = level == "O2"
    jcf = JBackend.create("jax").compile(jg.fn, JOptions(
        level=level, use_pallas=pallas, interpret_pallas=True))
    tcf = TBackend.create("torch", device="cpu").compile(
        tg.fn, TOptions(level=level, use_pallas=pallas))
    # every op of the optimized graph has a torch emitter
    ops = _walk_ops(tcf.function, set()) - {"Parameter"}
    missing = ops - set(torch_emit.EMIT) - {"Constant", "Iota"}
    assert not missing, missing
    if level == "O2":
        assert {"NormMatmul", "SwiGLU"} <= ops
    args = _inputs(jg, jcfg)
    jout = jcf(*args)
    tout = tcf(*args)
    assert len(jout) == len(tout)
    for i, (a, b) in enumerate(zip(jout, tout)):
        _close(f"{kind} {level} {dtype} output {i}", a, b)


# -- edge semantics, one op at a time -------------------------------------------
def _both(build, args):
    """Build the same graph with both packages' ops, compile at O0 (no
    rewriting), run on ``args``, return (jax outputs, torch outputs)."""
    jps, jres = build(j_ops)
    tps, tres = build(t_ops)
    jcf = JBackend.create("jax").compile(JFunction(jps, jres, "edge"),
                                         JOptions(level="O0"))
    tcf = TBackend.create("torch", device="cpu").compile(
        TFunction(tps, tres, "edge"), TOptions(level="O0"))
    return jcf(*args), tcf(*args)


def _same(jout, tout):
    for a, b in zip(jout, tout):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_argmax_and_topk_int32_ties_to_lowest_index():
    def build(ops):
        x = ops.parameter((2, 5), "f32", "x")
        v, i = ops.top_k(x.out(), 3)
        return [x], [ops.argmax(x.out(), axis=1), v, i]
    x = np.array([[1, 3, 3, 0, 3], [2, 2, 1, 5, 5]], np.float32)
    jout, tout = _both(build, [x])
    assert tout[0].dtype == np.int32 and tout[2].dtype == np.int32
    _same(jout, tout)


def test_integer_divide_floors_and_iota_cumsum():
    def build(ops):
        a = ops.parameter((4,), "i32", "a")
        b = ops.parameter((4,), "i32", "b")
        io = ops.iota((2, 4), 1, "i32")
        cs = ops.cumsum(ops.convert(a.out(), "f32"), axis=0, exclusive=True)
        return [a, b], [ops.divide(a.out(), b.out()), io, cs]
    a = np.array([-7, 7, -8, 9], np.int32)
    b = np.array([2, -2, 3, 4], np.int32)
    jout, tout = _both(build, [a, b])
    np.testing.assert_array_equal(tout[0], [-4, -4, -3, 2])
    _same(jout, tout)


@pytest.mark.parametrize("start", [-3, 0, 2, 5, 40])
def test_dynamic_slice_and_update_clamp_starts(start):
    def build(ops):
        x = ops.parameter((6, 4), "f32", "x")
        u = ops.parameter((3, 2), "f32", "u")
        s0 = ops.parameter((), "i32", "s0")
        s1 = ops.parameter((), "i32", "s1")
        ds = ops.dynamic_slice(x.out(), [s0.out(), s1.out()], (3, 2))
        dus = ops.dynamic_update_slice(x.out(), u.out(), [s0.out(), s1.out()])
        return [x, u, s0, s1], [ds, dus]
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    u = -np.ones((3, 2), np.float32)
    jout, tout = _both(build, [x, u, np.int32(start), np.int32(start - 1)])
    _same(jout, tout)


@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_gather_out_of_range_fills_like_jnp_take(dtype):
    def build(ops):
        x = ops.parameter((5, 2), dtype, "x")
        i = ops.parameter((2, 3), "i32", "i")
        return [x, i], [ops.gather(x.out(), i.out(), axis=0)]
    x = np.arange(10).reshape(5, 2).astype(np.float32 if dtype == "f32"
                                           else np.int32)
    idx = np.array([[0, -1, -5], [-6, 5, 7]], np.int32)
    jout, tout = _both(build, [x, idx])
    if dtype == "f32":
        np.testing.assert_array_equal(np.isnan(jout[0]), np.isnan(tout[0]))
        np.testing.assert_array_equal(np.nan_to_num(jout[0]),
                                      np.nan_to_num(tout[0]))
    else:
        _same(jout, tout)


def test_scatter_add_drops_out_of_range_like_at_add():
    def build(ops):
        x = ops.parameter((4, 2), "f32", "x")
        i = ops.parameter((6,), "i32", "i")
        u = ops.parameter((6, 2), "f32", "u")
        return [x, i, u], [ops.scatter_add(x.out(), i.out(), u.out())]
    x = np.zeros((4, 2), np.float32)
    idx = np.array([0, 0, -1, 4, -5, 2], np.int32)
    u = np.arange(12, dtype=np.float32).reshape(6, 2)
    jout, tout = _both(build, [x, idx, u])
    _same(jout, tout)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_honours_reverse(reverse):
    def build(ops):
        from_pkg = JFunction if ops is j_ops else TFunction
        c = ops.parameter((2,), "f32", "c")
        xi = ops.parameter((2,), "f32", "xi")
        nc = ops.add(ops.multiply(c.out(), ops.constant(2.0)), xi.out())
        body = from_pkg([c, xi], [nc, nc], "body")
        c0 = ops.parameter((2,), "f32", "c0")
        xs = ops.parameter((4, 2), "f32", "xs")
        outs = ops.scan(body, [c0.out()], xs=[xs.out()], reverse=reverse)
        return [c0, xs], outs
    c0 = np.array([1.0, -1.0], np.float32)
    xs = np.arange(8, dtype=np.float32).reshape(4, 2)
    jout, tout = _both(build, [c0, xs])
    _same(jout, tout)


def test_attention_raises_where_the_flash_kernel_would_run():
    """Where the reference selects its flash kernel (d_head 128 under
    ``use_pallas``) the torch emitter, which raised there before the
    port had the kernel, now runs it -- on the CPU its plain version --
    and gives the JAX emitter's output (the Pallas kernel, interpret
    mode); without ``use_pallas`` both take the plain composition."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels.ref import flash_attention_ref
    shape = (1, 2, 4, 128)

    def build(ops, Function):
        q, k, v = (ops.parameter(shape, "f32", n) for n in "qkv")
        pos = ops.parameter((), "i32", "pos")
        out = ops.attention(q.out(), k.out(), v.out(), causal=True,
                            q_offset=pos.out())
        return Function([q, k, v, pos], [out], "att")

    rng = np.random.default_rng(0)
    args = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    args.append(np.int32(2))
    be = TBackend.create("torch", device="cpu")
    tfn, jfn = build(t_ops, TFunction), build(j_ops, JFunction)
    kernel = be.compile(tfn, TOptions(level="O0", use_pallas=True))
    out = kernel(*args)[0]
    expect = flash_attention_ref(*(torch.from_numpy(a) for a in args[:3]),
                                 causal=True, q_offset=2)
    assert np.array_equal(out, expect.numpy()) and kf.launches == 0
    jout = JBackend.create("jax").compile(jfn, JOptions(
        level="O0", use_pallas=True, interpret_pallas=True))(*args)[0]
    _close("flash", out, jout)
    plain = be.compile(tfn, TOptions(level="O0"))(*args)[0]
    _close("plain", plain, jout)


def test_kernel_selection_counts_no_launch_on_cpu():
    """On the CPU the kernel-selection points run the plain versions:
    no launch and no rejection is counted."""
    from repro_torch import kernels
    cfg = _cfg(t_get_config, "bf16")
    g = _graph(t_lm, cfg, "chunk")
    opt, _ = run_pipeline(g.fn, "O2")
    assert opt.nodes()
    kernels.reset_counters()
    cf = TBackend.create("torch", device="cpu").compile(
        g.fn, TOptions(level="O2", use_pallas=True))
    cf(*_inputs(g, cfg))
    assert all(c == {"launches": 0, "rejected": 0}
               for c in kernels.counters().values())


def test_bf16_crosses_between_numpy_and_torch_bit_exactly():
    from repro_torch.devices import as_tensor, to_numpy
    import ml_dtypes
    x = (np.random.default_rng(0).normal(size=(3, 5)) * 100).astype(
        ml_dtypes.bfloat16)
    t = as_tensor(x, torch.device("cpu"))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
    back = to_numpy(t)
    assert back.dtype == x.dtype
    np.testing.assert_array_equal(back.view(np.uint16), x.view(np.uint16))


def test_a_parameter_no_result_reads_still_takes_its_argument():
    """A function may declare a parameter none of its results read (the
    backward Scan body of a MoE layer does, for an input whose cotangent
    it drops); both emitters take the argument and ignore it."""
    import ml_dtypes

    def build(ops):
        x = ops.parameter((3,), "f32", "x")
        unused = ops.parameter((2, 2), "bf16", "unused")
        y = ops.parameter((3,), "f32", "y")
        return [x, unused, y], [ops.add(x.out(), y.out())]
    rng = np.random.default_rng(0)
    args = [rng.normal(size=(3,)).astype(np.float32),
            np.zeros((2, 2), ml_dtypes.bfloat16),
            rng.normal(size=(3,)).astype(np.float32)]
    jout, tout = _both(build, args)
    _same(jout, tout)
