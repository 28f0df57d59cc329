"""The framework bridges on torch (``repro_torch.bridges``, a copy of
``repro.bridges``): ``tests/test_bridges.py``'s four cases, each run
through the port and held against the JAX package on the same numpy
inputs and weights.  The neon layer bridge, the functional builder and
the serialized-graph import produce the same IR in both packages (their
structural signatures agree) and compute the same thing on the torch
backend, the port's numpy interpreter and JAX.  Tolerances are
``tests/test_bridges.py``'s (1e-5 absolute; 1e-6 for the Scan round
trip), the training case's loss curve within 1e-4 of JAX's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import Backend as JBackend  # noqa: E402
from repro.bridges import neon as j_neon  # noqa: E402
from repro.bridges import onnx_like as j_onnx  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core import serialize as j_serialize  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402

from repro_torch.backend import Backend  # noqa: E402
from repro_torch.bridges import neon, onnx_like  # noqa: E402
from repro_torch.core import ops, serialize  # noqa: E402
from repro_torch.core.function import Function  # noqa: E402


def _torch(fn, args):
    return Backend.create("torch", device="cpu").compile(fn)(*args)


def _mlp_functional(ops, Function, w1, b1, w2, b2):
    x = ops.parameter((4, 8), "f32", "input")
    h = ops.tanh(ops.matmul(x.out(), ops.constant(w1)) + ops.constant(b1))
    y = ops.matmul(h, ops.constant(w2)) + ops.constant(b2)
    return Function([x], [y])


def _mlp_model(neon):
    return neon.Model(neon.Sequential([
        neon.Dense(8, 16, activation="tanh", name="d1", seed=1),
        neon.Dense(16, 3, name="d2", seed=2)]))


def test_neon_bridge_matches_functional():
    """The neon bridge's IR and the functional builder's compute the same
    MLP on the torch backend and the port's interpreter, and JAX's
    result for it."""
    model, jmodel = _mlp_model(neon), _mlp_model(j_neon)
    fn, names = neon.bridge_to_ir(model, (4, 8))
    jfn, jnames = j_neon.bridge_to_ir(jmodel, (4, 8))
    assert names == jnames and fn.signature() == jfn.signature()
    for n in names:
        assert np.array_equal(model.param_values[n], jmodel.param_values[n])
    w = [model.param_values[k] for k in ("d1/w", "d1/b", "d2/w", "d2/b")]
    fn2 = _mlp_functional(ops, Function, *w)
    x = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    args1 = [x] + [model.param_values[n] for n in names]
    ref = JBackend.create("jax").compile(jfn)(*args1)[0]
    for backend in ("interpreter", "torch"):
        be = Backend.create(backend, device="cpu") if backend == "torch" \
            else Backend.create(backend)
        y1 = be.compile(fn)(*args1)[0]
        y2 = be.compile(fn2)(x)[0]
        np.testing.assert_allclose(y1, y2, atol=1e-5)
        np.testing.assert_allclose(y1, ref, atol=1e-5)


def _train(neon, compile_):
    net = neon.Sequential([neon.Dense(6, 32, activation="tanh", seed=3),
                           neon.Dense(32, 5, name="out", seed=4)])
    model = neon.Model(net)
    fn, names = neon.bridge_to_ir(model, (16, 6), loss="softmax_xent",
                                  label_shape=(16,), with_grads=True)
    ex = compile_(fn)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 6)).astype(np.float32)
    labels = rng.integers(0, 5, size=(16,)).astype(np.int32)
    params = {n: model.param_values[n].copy() for n in names}
    losses = []
    for _ in range(30):
        outs = ex(x, labels, *[params[n] for n in names])
        losses.append(float(np.asarray(outs[0])))
        for n, g in zip(names, outs[1:]):
            params[n] -= 0.5 * np.asarray(g)
    return fn, losses


def test_neon_training_via_ir_autodiff():
    """Thirty SGD steps on the bridge's IR-autodiff graph: the loss falls
    as in the reference, and each step's loss is JAX's."""
    fn, losses = _train(neon, lambda f: Backend.create(
        "torch", device="cpu").compile(f))
    jfn, jlosses = _train(j_neon, lambda f: JBackend.create("jax")
                          .compile(f))
    assert fn.signature() == jfn.signature()
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-4)


def test_compile_model_goes_through_the_torch_backend():
    """``neon.compile_model``, the bridge's one-call path, compiles on
    the port's ``"torch"`` backend by default (here on the CPU)."""
    model = _mlp_model(neon)
    compiled, names = neon.compile_model(model, (4, 8), device="cpu")
    assert compiled.backend == "torch"
    x = np.random.default_rng(3).normal(size=(4, 8)).astype(np.float32)
    y = compiled(x, *[model.param_values[n] for n in names])[0]
    jc, _ = j_neon.compile_model(_mlp_model(j_neon), (4, 8))
    np.testing.assert_allclose(
        y, jc(x, *[model.param_values[n] for n in names])[0], atol=1e-5)


def _ir(ops, Function):
    x = ops.parameter((3, 4), "f32", "x")
    w = ops.parameter((4,), "f32", "w")
    y = ops.softmax(ops.rms_norm(x.out(), w.out()), axis=-1)
    vals, idx = ops.top_k(y, 2)
    return Function([x, w], [vals, ops.convert(idx, "f32")])


def test_serialization_roundtrip_is_same_ir():
    """A graph exported by one package imports into the other as the same
    IR, and the port's import computes what JAX computes."""
    fn, jfn = _ir(ops, Function), _ir(j_ops, JFunction)
    doc = onnx_like.export_graph(fn)
    fn2 = onnx_like.import_graph(doc)
    assert [t.shape for t in fn2.out_types] == \
        [t.shape for t in fn.out_types]
    # node names carry each package's own counter; the IR is the same
    assert fn2.signature() == jfn.signature() == \
        j_onnx.import_graph(j_onnx.export_graph(jfn)).signature()
    rng = np.random.default_rng(2)
    args = [rng.normal(size=(3, 4)).astype(np.float32),
            rng.normal(size=(4,)).astype(np.float32)]
    a = Backend.create("interpreter").compile(fn)(*args)
    b = _torch(fn2, args)
    ref = JBackend.create("jax").compile(jfn)(*args)
    for u, v, r in zip(a, b, ref):
        np.testing.assert_allclose(u, v, atol=1e-5)
        np.testing.assert_allclose(v, r, atol=1e-5)


def _scan_fn(ops, Function):
    c = ops.parameter((2,), "f32", "c")
    xx = ops.parameter((2,), "f32", "x")
    body = Function([c, xx], [ops.tanh(c.out() + xx.out())])
    init = ops.parameter((2,), "f32", "init")
    xs = ops.parameter((4, 2), "f32", "xs")
    outs = ops.scan(body, [init.out()], xs=[xs.out()])
    return Function([init, xs], list(outs))


def test_serialize_scan():
    """A Scan survives the serialized round trip: the port's interpreter
    and torch backend give the reference interpreter's result."""
    fn = _scan_fn(ops, Function)
    text = serialize.dumps(fn)
    fn2 = serialize.loads(text)
    assert fn2.signature() == _scan_fn(j_ops, JFunction).signature()
    rng = np.random.default_rng(2)
    args = [rng.normal(size=(2,)).astype(np.float32),
            rng.normal(size=(4, 2)).astype(np.float32)]
    a = Backend.create("interpreter").compile(fn)(*args)
    b = Backend.create("interpreter").compile(fn2)(*args)
    np.testing.assert_allclose(a[0], b[0], atol=1e-6)
    np.testing.assert_allclose(_torch(fn2, args)[0], a[0], atol=1e-6)
    ref = JBackend.create("interpreter").compile(
        j_serialize.loads(text))(*args)
    np.testing.assert_allclose(a[0], ref[0], atol=1e-6)
