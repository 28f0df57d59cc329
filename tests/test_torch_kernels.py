"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode, as ``tests/test_kernels.py`` runs them) and its
jnp oracles (``repro/kernels/ref.py``), the Hopper shape predicates, and
-- on a card only -- each CUDA kernel against its plain version.

Tolerances are the repo's: 1e-4 of scale in f32, 3e-2 in bf16 (one bf16
ulp of headroom over the accumulated rounding of two summation orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ops as jk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.norm_matmul import norm_matmul as j_norm_matmul  # noqa: E402
from repro.kernels.swiglu import swiglu as j_swiglu  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.devices import as_tensor, to_numpy  # noqa: E402
from repro_torch.kernels import matmul as km  # noqa: E402
from repro_torch.kernels import norm_matmul as kn  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as kr  # noqa: E402
from repro_torch.kernels import swiglu as ks  # noqa: E402

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = {"f32": (np.float32, torch.float32, 1e-4),
          "bf16": (BF16, torch.bfloat16, 3e-2)}


def _rand(rng, shape, np_dt, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32).astype(np_dt)


def _close(a, b, tol):
    a = np.asarray(a).astype(np.float64)
    b = np.asarray(b).astype(np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1.0)
    assert float(np.abs(a - b).max()) <= tol * scale


def _t(x):
    return as_tensor(x, torch.device("cpu"))


# -- plain versions vs the JAX Pallas kernels (interpret) and oracles ------------
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 128),
                                   (4, 256, 384), (1, 128, 256),
                                   (7, 100, 24)])
def test_matmul_plain_matches_jax(dt, m, k, n):
    np_dt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(m * 7 + n)
    a = _rand(rng, (m, k), np_dt)
    b = _rand(rng, (k, n), np_dt, k ** -0.5)
    out = to_numpy(ref.matmul_ref(_t(a), _t(b)))
    assert out.dtype == np.dtype(np_dt)
    _close(out, np.asarray(jref.matmul_ref(jnp.asarray(a), jnp.asarray(b))),
           tol)
    # the Pallas kernel itself (it lowers to a dot where no tile fits)
    _close(out, np.asarray(jk.matmul(jnp.asarray(a), jnp.asarray(b),
                                     interpret=True)), tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows,d", [(8, 128), (32, 256), (4, 384), (3, 40)])
@pytest.mark.parametrize("w_f32", [False, True])
def test_rmsnorm_plain_matches_jax(dt, rows, d, w_f32):
    np_dt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(rows + d)
    x = _rand(rng, (rows, d), np_dt)
    w = (1 + 0.1 * rng.normal(size=(d,))).astype(
        np.float32 if w_f32 else np_dt)
    out = to_numpy(ref.rmsnorm_ref(_t(x), _t(w)))
    _close(out, np.asarray(jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w))),
           tol)
    if jk.rmsnorm_supported(x.shape):
        _close(out, np.asarray(jk.rmsnorm(jnp.asarray(x), jnp.asarray(w),
                                          interpret=True)), tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,d,f,do", [(8, 128, 256, 128), (16, 256, 384, 256),
                                      (4, 128, 256, 128), (3, 64, 40, 24)])
def test_swiglu_plain_matches_jax(dt, m, d, f, do):
    np_dt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(m + f)
    x = _rand(rng, (m, d), np_dt)
    wg = _rand(rng, (d, f), np_dt, d ** -0.5)
    wu = _rand(rng, (d, f), np_dt, d ** -0.5)
    wd = _rand(rng, (f, do), np_dt, f ** -0.5)
    out = to_numpy(ref.swiglu_ref(_t(x), _t(wg), _t(wu), _t(wd)))
    jargs = [jnp.asarray(v) for v in (x, wg, wu, wd)]
    _close(out, np.asarray(jref.swiglu_ref(*jargs)), tol)
    _close(out, np.asarray(j_swiglu(*jargs, bm=min(8, m), bn=128, bf=128,
                                    interpret=True)), tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,d,n", [(8, 128, 256), (16, 256, 128),
                                   (4, 128, 384), (5, 96, 24)])
def test_norm_matmul_plain_matches_jax(dt, m, d, n):
    np_dt, _, tol = DTYPES[dt]
    rng = np.random.default_rng(m * d + n)
    x = _rand(rng, (m, d), np_dt)
    g = (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32)  # f32 g
    w = _rand(rng, (d, n), np_dt, d ** -0.5)
    out = to_numpy(ref.norm_matmul_ref(_t(x), _t(g), _t(w)))
    jargs = [jnp.asarray(v) for v in (x, g, w)]
    _close(out, np.asarray(jref.norm_matmul_ref(*jargs)), tol)
    _close(out, np.asarray(j_norm_matmul(*jargs, bm=min(8, m), bn=128,
                                         interpret=True)), tol)


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    x = _t(_rand(rng, (4, 64), BF16))
    w = _t(_rand(rng, (64, 32), BF16))
    g = _t(np.ones((64,), np.float32))
    kernels.reset_counters()
    assert torch.equal(km.matmul(x, w), ref.matmul_ref(x, w))
    assert torch.equal(kn.norm_matmul(x, g, w), ref.norm_matmul_ref(x, g, w))
    assert torch.equal(kr.rmsnorm(x, g), ref.rmsnorm_ref(x, g))
    wd = _t(_rand(rng, (32, 64), BF16))
    assert torch.equal(ks.swiglu(x, w, w, wd), ref.swiglu_ref(x, w, w, wd))
    # a CPU refusal is no "rejected" CUDA call either
    assert not km.supported(_t(np.zeros((4, 8), np.float32)),
                            _t(np.zeros((8, 3), np.float32)))
    assert all(c == {"launches": 0, "rejected": 0}
               for c in kernels.counters().values())


# -- the Hopper predicates ------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 4, 17, 64, 256])
def test_predicates_take_decode_and_prefill_rows(m):
    bf = torch.bfloat16
    assert kops.matmul_supported(m, 4096, 4096, bf)
    assert kops.matmul_supported(m, 4096, 102400, bf)
    assert kops.norm_matmul_supported(m, 4096, 102400, bf)
    assert kops.swiglu_supported(m, 4096, 11008, 4096, bf)
    assert kops.rmsnorm_supported((m, 1, 4096), bf, torch.float32)


def test_predicates_refuse_what_the_kernels_cannot_read():
    bf, f32 = torch.bfloat16, torch.float32
    # rows of B must split into 16-byte vectors
    assert not kops.matmul_supported(4, 64, 257, bf)
    assert kops.matmul_supported(4, 64, 260, f32)
    assert not kops.matmul_supported(4, 64, 258, f32)
    assert not kops.swiglu_supported(4, 64, 100, 64, bf)
    assert not kops.matmul_supported(4, 64, 64, torch.float64)
    assert not kops.matmul_supported(0, 64, 64, bf)
    # a normalized row must fit in shared memory
    assert kops.norm_matmul_tile(4, 4096, bf) == 4
    assert kops.norm_matmul_tile(64, 4096, bf) == 16
    assert kops.norm_matmul_tile(64, 16384, f32) == 1
    assert not kops.norm_matmul_supported(1, 1 << 16, 8, f32)
    assert kops.swiglu_slices(11008, bf) == 172


# -- the CUDA kernels (skip without a card) ----------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


CUDA_CASES = [("matmul", (4, 4096, 4096)), ("matmul", (5, 96, 24)),
              ("norm_matmul", (4, 4096, 1024)), ("norm_matmul", (3, 40, 16)),
              ("swiglu", (4, 512, 1024, 256)), ("swiglu", (3, 64, 40, 24)),
              ("rmsnorm", (4, 4096)), ("rmsnorm", (3, 40))]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kernel,shape", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, kernel, shape, dt):
    _, t_dt, tol = DTYPES[dt]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=cuda_device)
                * scale).to(t_dt)

    if kernel == "matmul":
        m, k, n = shape
        args, mod, plain = (r(m, k), r(k, n, scale=k ** -0.5)), km, \
            ref.matmul_ref
        out = km.matmul(*args)
    elif kernel == "norm_matmul":
        m, d, n = shape
        args = (r(m, d), 1 + 0.1 * torch.randn(d, generator=gen,
                                               device=cuda_device),
                r(d, n, scale=d ** -0.5))
        mod, plain = kn, ref.norm_matmul_ref
        out = kn.norm_matmul(*args)
    elif kernel == "swiglu":
        m, d, f, do = shape
        args = (r(m, d), r(d, f, scale=d ** -0.5), r(d, f, scale=d ** -0.5),
                r(f, do, scale=f ** -0.5))
        mod, plain = ks, ref.swiglu_ref
        out = ks.swiglu(*args)
    else:
        m, d = shape
        args = (r(m, d), 1 + 0.1 * torch.randn(d, generator=gen,
                                               device=cuda_device))
        mod, plain = kr, ref.rmsnorm_ref
        out = kr.rmsnorm(*args)
    torch.cuda.synchronize()
    before = mod.launches
    expect = plain(*args)
    assert mod.launches == before
    _close(to_numpy(out.float()), to_numpy(expect.float()), tol)
