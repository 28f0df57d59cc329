"""The port's Backend/CompiledFunction API (``repro_torch.backend``), case
by case after ``tests/test_backend_api.py``: the registry, the compile
cache and its key, named-parameter calling, warmup and timing hooks,
donation, concurrent compiles and the device errors -- on the torch
backend (CPU) and the port's numpy ``"interpreter"`` backend.

Not ported: the disk-cache cases (the persistent cache is a later slice,
refused with ``OptionsError``), the AOT-export case (the port has no
executable format yet) and the legacy ``get_transformer`` shim (the port
has no shim).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.backend import Backend as JBackend  # noqa: E402
from repro.core import ops as j_ops  # noqa: E402
from repro.core.function import Function as JFunction  # noqa: E402

from repro_torch.backend import (Backend, CompileOptions,  # noqa: E402
                                 CompiledFunction, OptionsError,
                                 available_backends)
from repro_torch.core import ops  # noqa: E402
from repro_torch.core.function import Function  # noqa: E402

RNG = np.random.default_rng(5)
BACKENDS = ["torch", "interpreter"]


def _create(name, **kw):
    """The named backend; torch on the CPU, as the tests ask."""
    if name == "torch":
        kw["device"] = "cpu"
    return Backend.create(name, **kw)


def _graph(scale=1.0, ops=ops, Function=Function):
    x = ops.parameter((4, 16), "f32", "x")
    w = ops.parameter((16,), "f32", "w")
    y = ops.softmax(ops.rms_norm(ops.gelu(x.out() * scale), w.out()), -1)
    return Function([x, w], [y])


def _args():
    return [RNG.normal(size=(4, 16)).astype(np.float32),
            np.ones(16, np.float32)]


def test_available_backends():
    assert {"interpreter", "torch"} <= set(available_backends())
    with pytest.raises(KeyError):
        Backend.create("no-such-backend")


def test_compile_runs_pipeline_and_attaches_report():
    be = _create("torch", fresh=True)
    cf = be.compile(_graph(), CompileOptions(level="O2"))
    assert isinstance(cf, CompiledFunction)
    assert cf.report is not None and cf.report.nodes_after >= 1
    # O2 ran real passes
    assert [name for name, _ in cf.report.stats]
    # metadata rides along
    assert cf.memory_plan.arena_bytes >= 0
    assert cf.cost.flops > 0


@pytest.mark.parametrize("name", BACKENDS)
def test_cache_hit_same_fn_same_options(name):
    be = _create(name, fresh=True)
    fn = _graph()
    cf1 = be.compile(fn, CompileOptions(level="O2"))
    cf2 = be.compile(fn, CompileOptions(level="O2"))
    assert cf2 is cf1
    st = be.cache_stats()
    assert (st.hits, st.misses, st.size) == (1, 1, 1)


@pytest.mark.parametrize("name", BACKENDS)
def test_cache_hit_structurally_identical_rebuilt_graph(name):
    be = _create(name, fresh=True)
    cf1 = be.compile(_graph(), CompileOptions(level="O1"))
    cf2 = be.compile(_graph(), CompileOptions(level="O1"))  # rebuilt
    assert cf2 is cf1
    assert be.cache_stats().hits == 1


@pytest.mark.parametrize("name", BACKENDS)
def test_cache_miss_on_changed_options_or_graph(name):
    be = _create(name, fresh=True)
    fn = _graph()
    be.compile(fn, CompileOptions(level="O1"))
    be.compile(fn, CompileOptions(level="O2"))          # options differ
    be.compile(fn, CompileOptions(level="O1", attn_chunk=512))
    be.compile(_graph(scale=2.0), CompileOptions(level="O1"))  # graph differs
    st = be.cache_stats()
    assert st.hits == 0 and st.misses == 4 and st.size == 4


def test_cache_isolated_per_backend_and_clearable():
    bt = _create("torch", fresh=True)
    bi = _create("interpreter", fresh=True)
    fn = _graph()
    bt.compile(fn)
    bi.compile(fn)
    assert bt.cache_stats().misses == 1
    assert bi.cache_stats().misses == 1
    bt.clear_cache()
    assert bt.cache_stats().size == 0
    assert bi.cache_stats().size == 1
    bt.compile(fn)
    assert bt.cache_stats().misses == 1


@pytest.mark.parametrize("name", BACKENDS)
def test_create_memoizes_instances(name):
    assert _create(name) is _create(name)
    assert _create(name, fresh=True) is not _create(name)


@pytest.mark.parametrize("name", BACKENDS)
def test_named_parameter_calling(name):
    fn = _graph()
    cf = _create(name, fresh=True).compile(fn)
    xa, wa = _args()
    ref = cf(xa, wa)[0]
    np.testing.assert_allclose(cf(x=xa, w=wa)[0], ref)
    np.testing.assert_allclose(cf(w=wa, x=xa)[0], ref)
    np.testing.assert_allclose(cf(xa, w=wa)[0], ref)
    with pytest.raises(TypeError):
        cf(xa, x=xa, w=wa)           # duplicate
    with pytest.raises(TypeError):
        cf(x=xa)                     # missing
    with pytest.raises(TypeError):
        cf(x=xa, w=wa, bogus=xa)     # unknown
    with pytest.raises(TypeError):
        cf(xa)                       # too few positional


@pytest.mark.parametrize("name", BACKENDS)
def test_warmup_and_timing_hook(name):
    cf = _create(name, fresh=True).compile(_graph())
    seen = []
    hook = lambda c, s: seen.append((c, s))  # noqa: E731
    cf.add_timing_hook(hook)
    cf.warmup()
    assert cf.n_calls == 1 and cf.last_seconds is not None
    assert seen and seen[0][0] is cf and seen[0][1] > 0
    cf.remove_timing_hook(hook)
    cf.warmup()
    assert len(seen) == 1  # removed hooks stop firing


def test_warmup_is_donation_safe():
    """Warming an executable compiled with donate_argnums must not touch
    caller tensors, and real calls afterwards must work (the serving
    engine warms donated graphs).  On the CPU a donated input is one the
    program may drop after its last use; the caller's reference keeps it
    intact."""
    be = _create("torch", fresh=True)
    cf = be.compile(_graph(), CompileOptions(donate_argnums=(0,)))
    x, w = _args()
    tx = torch.from_numpy(x.copy())  # caller-held device tensor
    ptr = tx.data_ptr()
    cf.warmup()
    cf.warmup()  # repeated warmups allocate fresh zeros each time
    assert tx.data_ptr() == ptr and torch.equal(tx, torch.from_numpy(x))
    # post-warmup real calls are unpoisoned, numpy path copies per call
    ref = cf(x, w)[0]
    again = cf(x, w)[0]
    np.testing.assert_array_equal(ref, again)
    # the raw path takes device tensors and returns device tensors
    out = cf.raw(tx, torch.from_numpy(w))
    assert isinstance(out[0], torch.Tensor)
    np.testing.assert_allclose(out[0].numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("name", BACKENDS)
def test_donate_argnums_validated_against_parameters(name):
    be = _create(name, fresh=True)
    with pytest.raises(OptionsError, match="out of range"):
        be.compile(_graph(), CompileOptions(donate_argnums=(7,)))
    with pytest.raises(OptionsError, match="out of range"):
        be.compile(_graph(), CompileOptions(donate_argnums=(-1,)))


@pytest.mark.parametrize("name,level", [("interpreter", "O0"),
                                        ("torch", "O1")])
def test_cache_key_includes_param_names_and_resolved_level(name, level):
    """A renamed-but-structurally-identical graph must NOT be a cache hit
    (the executable binds named parameters), while level=None vs an
    explicit backend-default level must share one executable."""
    be = _create(name, fresh=True)
    assert be.default_level == level
    fn = _graph()
    cf1 = be.compile(fn)                                # default level
    cf2 = be.compile(fn, CompileOptions(level=level))   # explicit default
    assert cf2 is cf1
    x = ops.parameter((4, 16), "f32", "inp")
    w = ops.parameter((16,), "f32", "gain")
    renamed = Function([x, w],
                       [ops.softmax(ops.rms_norm(ops.gelu(x.out() * 1.0),
                                                 w.out()), -1)])
    assert renamed.signature() == fn.signature()       # structural identity
    cf3 = be.compile(renamed)                          # but names differ
    assert cf3 is not cf1
    xa, wa = _args()
    np.testing.assert_allclose(cf3(inp=xa, gain=wa)[0], cf1(x=xa, w=wa)[0])


@pytest.mark.parametrize("name", BACKENDS)
def test_concurrent_compiles_deduplicate(name):
    be = _create(name, fresh=True)
    fn = _graph()
    results = []

    def worker():
        results.append(be.compile(fn))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 8
    assert all(r is results[0] for r in results)
    st = be.cache_stats()
    assert st.misses == 1 and st.size == 1 and st.hits == 7


def test_backends_agree_through_new_api():
    """The port's interpreter and its torch backend at O2 agree with each
    other and with the JAX package's jax backend on the same inputs."""
    fn = _graph()
    args = _args()
    a = _create("interpreter", fresh=True).compile(fn)(*args)[0]
    b = _create("torch", fresh=True).compile(
        fn, CompileOptions(level="O2"))(*args)[0]
    j = JBackend.create("jax", fresh=True).compile(
        _graph(ops=j_ops, Function=JFunction))(*args)[0]
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(j, b, atol=1e-5, rtol=1e-4)


def test_device_errors_name_the_available_devices():
    with pytest.raises(ValueError, match="available"):
        Backend.create("torch", fresh=True, device="tpu:7")
    with pytest.raises((ValueError, RuntimeError), match="available"):
        Backend.create("torch", fresh=True, device=99)
    with pytest.raises(ValueError, match="malformed"):
        Backend.create("torch", fresh=True, device="cpu:zero")
    with pytest.raises(TypeError, match="device"):
        Backend.create("torch", fresh=True, device=1.5)
    with pytest.raises(TypeError, match="unknown torch backend opts"):
        Backend.create("torch", fresh=True, gpu=True)


def test_later_slices_are_refused_on_every_backend():
    """The disk cache and the autotuner are refused, not ignored, on the
    interpreter as on torch."""
    for name in BACKENDS:
        be = _create(name, fresh=True)
        with pytest.raises(OptionsError, match="later slices"):
            be.compile(_graph(), CompileOptions(cache_dir="/nonexistent"))
        with pytest.raises(OptionsError, match="later slices"):
            be.compile(_graph(), CompileOptions(autotune=True))
