"""One IR, many backends, on torch: every case of ``tests/test_backends.py``
runs through the port's torch backend on the CPU and through its numpy
``"interpreter"`` backend, against the JAX package's jax backend on the
same numpy inputs.

Each case builds its graph twice, once with each package's ops (the
port keeps its own copy of the IR), and checks that the two builds are
the same graph by their structural signatures.  Integer outputs must be
identical; float outputs agree within 1e-4 of scale in f32 and 3e-2 in
bf16 (``scripts/check_kernel_parity.py:69``), the scale being
``max(max |jax|, 1)``.  ``LinearRecurrence`` waits for the port's
recurrent-family slice: the interpreter runs it against JAX, and the
torch emitter must refuse it by naming that slice.  And the model-level
gate, ``scripts/check_torch_parity.py``, passes on the CPU at the stock
reduced widths and at d_head 128.
"""
import importlib.util
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import Backend as JBackend  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402

from repro_torch.backend import Backend  # noqa: E402
from repro_torch.core import ops as t_ops  # noqa: E402
from repro_torch.core.function import Function as TFunction  # noqa: E402

RNG = np.random.default_rng(7)
TOL = {"f32": 1e-4, "bf16": 3e-2}


def _close(where, ref, got, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype, \
        (where, ref.shape, ref.dtype, got.shape, got.dtype)
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(ref, got, err_msg=where)
        return
    rf, gf = ref.astype(np.float64), got.astype(np.float64)
    scale = max(float(np.abs(rf).max()), 1.0)
    diff = float(np.abs(rf - gf).max())
    assert diff <= tol * scale, f"{where}: max diff {diff} > {tol * scale}"


def _compiled(build):
    """``build(ops, Function)`` with each package's IR: JAX's graph on the
    jax backend; the port's on its torch backend (CPU) and interpreter."""
    jfn = build(j_ops, JFunction)
    tfn = build(t_ops, TFunction)
    assert jfn.signature() == tfn.signature()
    return (JBackend.create("jax").compile(jfn),
            Backend.create("torch", device="cpu").compile(tfn),
            Backend.create("interpreter").compile(tfn))


def three(build, *args, tol="f32"):
    jcf, tcf, icf = _compiled(build)
    ref = jcf(*args)
    for label, cf in (("torch", tcf), ("interpreter", icf)):
        outs = cf(*args)
        assert len(outs) == len(ref), label
        for i, (a, b) in enumerate(zip(ref, outs)):
            _close(f"{label} output {i}", a, b, TOL[tol])
    return ref


UNARIES = ["exp", "log1p", "tanh", "sigmoid", "relu", "abs_", "sqrt",
           "rsqrt", "erf", "sin", "cos", "floor", "gelu", "silu",
           "negative", "sign"]


@pytest.mark.parametrize("opname", UNARIES)
def test_unary(opname):
    def build(ops, Function):
        x = ops.parameter((3, 4), "f32", "x")
        y = getattr(ops, opname)(ops.sigmoid(x.out()) + 0.5)
        return Function([x], [y])
    three(build, RNG.normal(size=(3, 4)).astype(np.float32))


BINARIES = ["add", "subtract", "multiply", "divide", "maximum", "minimum",
            "less", "greater_equal", "equal"]


@pytest.mark.parametrize("opname", BINARIES)
def test_binary_with_broadcast(opname):
    def build(ops, Function):
        a = ops.parameter((3, 4), "f32", "a")
        b = ops.parameter((4,), "f32", "b")
        y = getattr(ops, opname)(a.out(), ops.abs_(b.out()) + 1.0)
        return Function([a, b], [ops.convert(y, "f32")])
    three(build, RNG.normal(size=(3, 4)).astype(np.float32),
          RNG.normal(size=(4,)).astype(np.float32))


def test_shape_ops():
    def build(ops, Function):
        x = ops.parameter((2, 3, 4), "f32", "x")
        v = x.out()
        return Function([x], [
            ops.transpose(v, (2, 0, 1)),
            ops.reshape(v, (6, 4)),
            ops.slice_(v, [0, 1, 0], [2, 3, 4], [1, 1, 2]),
            ops.pad(v, [1, 0, 0], [0, 2, 0], value=-1.0),
            ops.reverse(v, [1]),
            ops.concat([v, v], axis=2),
            ops.broadcast_to(ops.reduce_max(v, [1], keepdims=True),
                             v.shape),
        ])
    three(build, RNG.normal(size=(2, 3, 4)).astype(np.float32))


def test_reductions_and_cumsum():
    def build(ops, Function):
        x = ops.parameter((4, 5), "f32", "x")
        v = x.out()
        return Function([x], [
            ops.reduce_sum(v, [0]), ops.reduce_mean(v, [1], keepdims=True),
            ops.reduce_min(v), ops.cumsum(v, 1),
            ops.cumsum(v, 0, exclusive=True),
            ops.convert(ops.argmax(v, 1), "f32"), ops.argmax(v, 0)])
    three(build, RNG.normal(size=(4, 5)).astype(np.float32))


def test_dot_general_and_einsum():
    def build(ops, Function):
        a = ops.parameter((2, 3, 4), "f32", "a")
        b = ops.parameter((2, 4, 5), "f32", "b")
        return Function([a, b], [
            ops.matmul(a.out(), b.out()),
            ops.einsum("bij,bjk->bki", a.out(), b.out())])
    three(build, RNG.normal(size=(2, 3, 4)).astype(np.float32),
          RNG.normal(size=(2, 4, 5)).astype(np.float32))


def test_gather_scatter_dynamic():
    def build(ops, Function):
        x = ops.parameter((6, 3), "f32", "x")
        idx = ops.parameter((4,), "i32", "idx")
        g = ops.gather(x.out(), idx.out(), axis=0)
        sc = ops.scatter_add(x.out(), idx.out(), g)
        ds = ops.dynamic_slice(x.out(), [ops.constant(2), ops.constant(1)],
                               (3, 2))
        du = ops.dynamic_update_slice(x.out(), ds * 2.0,
                                      [ops.constant(0), ops.constant(0)])
        return Function([x, idx], [g, sc, ds, du])
    three(build, RNG.normal(size=(6, 3)).astype(np.float32),
          np.array([0, 5, 2, 2], np.int32))


def test_compounds():
    def build(ops, Function):
        x = ops.parameter((4, 8), "f32", "x")
        w = ops.parameter((8,), "f32", "w")
        b = ops.parameter((8,), "f32", "b")
        return Function([x, w, b], [
            ops.softmax(x.out(), -1),
            ops.log_softmax(x.out(), -1),
            ops.rms_norm(x.out(), w.out()),
            ops.layer_norm(x.out(), w.out(), b.out())])
    three(build, RNG.normal(size=(4, 8)).astype(np.float32),
          RNG.normal(size=(8,)).astype(np.float32),
          RNG.normal(size=(8,)).astype(np.float32))


@pytest.mark.parametrize("causal,window,offset", [
    (True, None, None), (False, None, None), (True, 3, None),
    (True, None, 4), (True, 2, 4)])
def test_attention_variants(causal, window, offset):
    def build(ops, Function):
        q = ops.parameter((2, 4, 6, 8), "f32", "q")
        k = ops.parameter((2, 2, 10, 8), "f32", "k")
        v = ops.parameter((2, 2, 10, 8), "f32", "v")
        off = (ops.constant(offset, dtype="i32")
               if offset is not None else None)
        return Function([q, k, v], [ops.attention(
            q.out(), k.out(), v.out(), causal=causal, window=window,
            q_offset=off)])
    three(build, RNG.normal(size=(2, 4, 6, 8)).astype(np.float32),
          RNG.normal(size=(2, 2, 10, 8)).astype(np.float32),
          RNG.normal(size=(2, 2, 10, 8)).astype(np.float32))


def test_xent_and_topk():
    def build(ops, Function):
        lg = ops.parameter((3, 7), "f32", "logits")
        lb = ops.parameter((3,), "i32", "labels")
        tv, ti = ops.top_k(lg.out(), 3)
        return Function([lg, lb], [
            ops.softmax_cross_entropy(lg.out(), lb.out()), tv, ti])
    three(build, RNG.normal(size=(3, 7)).astype(np.float32),
          np.array([0, 6, 3], np.int32))


def test_linear_recurrence_waits_for_the_recurrent_slice():
    def build(ops, Function):
        a = ops.parameter((2, 5, 3), "f32", "a")
        b = ops.parameter((2, 5, 3), "f32", "b")
        y = ops.linear_recurrence(ops.sigmoid(a.out()), b.out(), axis=1)
        yr = ops.linear_recurrence(ops.sigmoid(a.out()), b.out(), axis=1,
                                   reverse=True)
        return Function([a, b], [y, yr])
    args = (RNG.normal(size=(2, 5, 3)).astype(np.float32),
            RNG.normal(size=(2, 5, 3)).astype(np.float32))
    jcf, tcf, icf = _compiled(build)
    ref = jcf(*args)
    for i, (a, b) in enumerate(zip(ref, icf(*args))):
        _close(f"interpreter output {i}", a, b, TOL["f32"])
    with pytest.raises(NotImplementedError,
                       match="recurrent-family slice of the torch port"):
        tcf(*args)


def test_scan_with_ys_and_reverse():
    def build(ops, Function):
        c = ops.parameter((3,), "f32", "c")
        x = ops.parameter((3,), "f32", "x")
        w = ops.parameter((3,), "f32", "w")
        body = Function([c, x, w], [ops.tanh(c.out() + x.out() * w.out()),
                                    c.out() * 2.0])
        init = ops.parameter((3,), "f32", "init")
        xs = ops.parameter((6, 3), "f32", "xs")
        wv = ops.parameter((3,), "f32", "wv")
        outs = ops.scan(body, [init.out()], xs=[xs.out()],
                        consts=[wv.out()])
        outs_r = ops.scan(body, [init.out()], xs=[xs.out()],
                          consts=[wv.out()], reverse=True)
        return Function([init, xs, wv], list(outs) + list(outs_r))
    three(build, RNG.normal(size=(3,)).astype(np.float32),
          RNG.normal(size=(6, 3)).astype(np.float32),
          RNG.normal(size=(3,)).astype(np.float32))


def test_bf16_roundtrip():
    def build(ops, Function):
        x = ops.parameter((4, 4), "bf16", "x")
        y = ops.rms_norm(x.out(), ops.constant(np.ones(4, np.float32)))
        return Function([x], [ops.convert(y, "f32"), y])
    ref = three(build, RNG.normal(size=(4, 4)).astype(ml_dtypes.bfloat16),
                tol="bf16")
    assert ref[1].dtype == ml_dtypes.bfloat16


@pytest.mark.parametrize("width", ["reduced", "dh128"])
def test_serving_graphs_match_jax_through_the_parity_gate(width, capsys):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "check_torch_parity",
        os.path.join(root, "scripts", "check_torch_parity.py"))
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    assert gate.main(["--device", "cpu", "--width", width]) == 0
    out = capsys.readouterr().out
    assert f"torch parity ok ({width}, cpu)" in out
    assert all(f"{kind}: fused" in out for kind in gate.EXPECTED)
