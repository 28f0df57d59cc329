"""norm_matmul's and swiglu's 16-bit products on the wgmma mainloop
(``csrc/wg_gemm.cuh``) above ``ops.WG_MIN_ROWS`` rows, on the CPU: the
route the plans choose (``ops.norm_matmul_plan``, ``ops.swiglu_plan``),
their shared memory, the paired B's fragment (g and u of one F column in
one thread) and h's rounding chain, emulated in numpy, and the plain
versions against the JAX package's oracles and Pallas kernels (interpret
mode) at a row count above the threshold.  The kernels themselves run
only on a card (``chip_smoke.py``'s phase 3, ``scripts/torch_bmm_bits.py``).

Tolerances are ``tests/test_torch_kernels.py``'s: 1e-4 of scale in f32,
3e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.norm_matmul import norm_matmul as j_norm_matmul  # noqa: E402
from repro.kernels.swiglu import swiglu as j_swiglu  # noqa: E402

from repro_torch.devices import as_tensor, to_numpy  # noqa: E402
from repro_torch.kernels import norm_matmul as kn  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import swiglu as ks  # noqa: E402

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = {"f32": (np.float32, torch.float32, 1e-4),
          "bf16": (BF16, torch.bfloat16, 3e-2)}
SIXTEEN = (torch.bfloat16, torch.float16)


def _t(x):
    return as_tensor(x, torch.device("cpu"))


def _rand(rng, shape, np_dt, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32).astype(np_dt)


def _close(a, b, tol):
    a = np.asarray(a).astype(np.float64)
    b = np.asarray(b).astype(np.float64)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1.0)
    assert float(np.abs(a - b).max()) <= tol * scale


# -- the route ---------------------------------------------------------------------
@pytest.mark.parametrize("dt", SIXTEEN)
@pytest.mark.parametrize("m", [1, 4, 64, 95, 96, 97, 128, 512, 2048, 2176])
def test_route_starts_just_above_the_threshold(m, dt):
    """At deepseek-7b's widths both kernels keep their tensor-core tiles
    up to WG_MIN_ROWS rows and take the wgmma mainloop from one row more;
    there norm_matmul's product is matmul's wgmma launch on an (m, d)
    workspace of normalised rows in x's type, and swiglu's down product
    matmul's wgmma launch on h."""
    wg = m > kops.WG_MIN_ROWS
    nm = kops.norm_matmul_plan(m, 4096, 4096, dt, torch.float32)
    sw = kops.swiglu_plan(m, 4096, 11008, 4096, dt)
    assert nm.route == sw.route == ("wgmma" if wg else "tensor_core")
    if wg:
        assert nm.gemm == kops.matmul_plan(m, 4096, 4096, dt)
        assert nm.gemm.route == "wgmma"
        assert (nm.ws_shape, nm.ws_dtype) == ((m, 4096), dt)
        assert sw.down == kops.matmul_plan(m, 11008, 4096, dt)
        assert sw.down.route == sw.gate_up.route == "wgmma"
    else:
        assert nm.gemm == kops.tc_matmul_plan(m, 4096, 4096, dt)
        assert (nm.ws_shape, nm.ws_dtype) == ((m,), torch.float32)
        assert sw.down == kops.tc_matmul_plan(m, 11008, 4096, dt)
    # the rows: a warp each, or (wgmma) a block of four warps each
    assert nm.rows_grid == (m if wg else -(-m // 8))


@pytest.mark.parametrize("dt", SIXTEEN)
@pytest.mark.parametrize("m", [97, 2048])
@pytest.mark.parametrize("d", [44, 1001, 4100])
def test_route_needs_whole_vectors_of_d(m, d, dt):
    """Where x's rows are not whole 16-byte vectors (d % 8 != 0) the TMA
    unit cannot read them: both kernels keep the tiles at any row count
    (the tensor-core mainloop reads such an A element by element)."""
    nm = kops.norm_matmul_plan(m, d, 4096, dt)
    sw = kops.swiglu_plan(m, d, 11008, 4096, dt)
    assert nm.route == sw.route == "tensor_core"
    assert nm.ws_shape == (m,) and sw.down.route == "tensor_core"
    assert kops.norm_matmul_supported(m, d, 4096, dt)
    assert kops.swiglu_supported(m, d, 11008, 4096, dt)


@pytest.mark.parametrize("dt", SIXTEEN)
@pytest.mark.parametrize("f,do", [(44, 4096), (11008, 44), (4100, 4096)])
def test_swiglu_refuses_f_and_do_not_in_whole_vectors(f, do, dt):
    """h's rows (F) and out's (Do) must be whole 16-byte vectors on every
    route: the wgmma route's TMA boxes read and write them, the tiles'
    stores pair columns.  The predicate refuses the rest, so no plan is
    asked for them."""
    assert not kops.swiglu_supported(2048, 4096, f, do, dt)


def test_plans_fit_shared_memory():
    """The wgmma plans use matmul's ring and staged outputs (WG_SMEM, at
    most one block an SM), and the paired epilogue's h box -- 64 rows of
    64 16-bit values a consumer -- fits the 64 rows of WG_BN f32 staged
    per consumer; below the threshold the tiles' plans are unchanged."""
    assert kops.WG_SMEM <= 232448
    assert 64 * kops.WG_BOX_MN * 2 <= 64 * kops.WG_BN * 4
    for m in (97, 512, 2048):
        nm = kops.norm_matmul_plan(m, 4096, 102400, torch.bfloat16,
                                   torch.float32)
        sw = kops.swiglu_plan(m, 4096, 11008, 4096, torch.bfloat16)
        assert nm.smem == sw.smem == sw.down.smem == kops.WG_SMEM
        assert sw.gate_up.threads == nm.gemm.threads == kops.WG_THREADS
    tc = kops.norm_matmul_plan(96, 4096, 4096, torch.bfloat16)
    assert tc.smem == kops.tc_matmul_plan(96, 4096, 4096, torch.bfloat16) \
        .smem + tc.stages * kops.TC_KS * 2
    assert kops.swiglu_plan(96, 4096, 11008, 4096, torch.bfloat16).smem \
        == kops.tc_smem_bytes(64, 64, 3)


@pytest.mark.parametrize("m,f", [(97, 11008), (2048, 11008), (130, 200),
                                 (4224, 40)])
def test_paired_grid_covers_every_f_column_once(m, f):
    """The gate/up's persistent blocks walk ceil(m / 128) x ceil(f / 64)
    tiles of 64 F columns each (wg's and wu's at the same columns), at
    most one block an SM: together the tiles hold each (row, F column)
    once; what lies past m or f is the TMA unit's zeros and is not
    stored."""
    plan = kops.swiglu_plan(m, 4096, f, 4096, torch.bfloat16)
    tiles_m, tiles_f = -(-m // kops.WG_BM), -(-f // kops.WG_BOX_MN)
    assert plan.grid == (min(tiles_m * tiles_f, kops.WG_SMS), 1)
    assert (plan.bm, plan.bf) == (kops.WG_BM, kops.WG_BOX_MN)
    cols = np.concatenate([np.arange(t * plan.bf, (t + 1) * plan.bf)
                           for t in range(tiles_f)])
    kept = cols[cols < f]
    assert sorted(kept) == list(range(f))
    assert tiles_m * plan.bm >= m > (tiles_m - 1) * plan.bm


# -- the paired fragment and the h epilogue, emulated ------------------------------
def _fragment():
    """{(thread, register): (row, column)} of a consumer's m64n128 f32
    accumulators (csrc/wg_gemm.cuh): thread t, n8 block j holds d[4j],
    d[4j + 1] at row 16 (t / 32) + (t % 32) / 4, columns 8j + 2 (t % 4)
    and + 1, and d[4j + 2], d[4j + 3] eight rows below."""
    out = {}
    for t in range(128):
        for j in range(16):
            for e in range(4):
                row = 16 * (t // 32) + (t % 32) // 4 + 8 * (e // 2)
                out[t, 4 * j + e] = (row, 8 * j + 2 * (t % 4) + e % 2)
    return out


def test_paired_fragment_holds_g_and_u_of_a_column_in_one_thread():
    """With B's first 64-column box from wg and its second from wu at the
    same F columns, the thread that holds g at n8 block j < 8 holds u of
    the same row and F column at block j + 8, register 4 (j + 8) + e: h
    forms in registers.  Each (row, F column) of the 64 x 64 h tile comes
    from exactly one (thread, register pair), and the staged box under
    the 128-byte swizzle takes each 4-byte place once."""
    frag = _fragment()
    f0 = 640
    seen = set()
    places = set()
    for t in range(128):
        for j in range(8):
            for e in range(4):
                row, n = frag[t, 4 * j + e]
                row2, n2 = frag[t, 4 * (j + 8) + e]
                assert n < 64 and n2 == n + 64 and row2 == row
                # column n of the tile: wg's F column f0 + n; n + 64: wu's
                g_col, u_col = f0 + n, f0 + (n2 - 64)
                assert g_col == u_col
                seen.add((row, g_col))
                if e % 2 == 0:   # the pair (e, e + 1) is one 4-byte store
                    o = row * 128 + n * 2
                    places.add(o ^ (((o >> 7) & 7) << 4))
    assert seen == {(r, f0 + c) for r in range(64) for c in range(64)}
    assert len(places) == 64 * 64 // 2
    assert all(p % 4 == 0 and 0 <= p < 64 * 128 for p in places)


def _round(x, dt):
    np_dt = {torch.bfloat16: BF16, torch.float16: np.float16}[dt]
    return np.asarray(x, np.float32).astype(np_dt).astype(np.float32)


@pytest.mark.parametrize("dt", SIXTEEN)
def test_silu_mul_rounding_chain_is_the_plain_versions(dt):
    """csrc/swiglu.cu's ``silu_mul`` on the f32 sums of g and u -- g and u
    rounded to x's type, exp(-g), 1 + e, its reciprocal, g times it, and
    that times u, each rounded -- emulated in numpy, gives bit for bit the
    h of ``ref.swiglu_ref`` (read through an identity down product, which
    adds each h to zeros in f32)."""
    rng = np.random.default_rng(5)
    m, d, f = 128, 64, 96
    x = _t(_rand(rng, (m, d), np.float32, 2.0)).to(dt)
    wg = _t(_rand(rng, (d, f), np.float32, d ** -0.5)).to(dt)
    wu = _t(_rand(rng, (d, f), np.float32, d ** -0.5)).to(dt)
    g_sum = to_numpy(torch.matmul(x.float(), wg.float()))
    u_sum = to_numpy(torch.matmul(x.float(), wu.float()))
    g, u = _round(g_sum, dt), _round(u_sum, dt)
    e = _round(np.exp(-g), dt)
    sig = _round(np.float32(1) / _round(np.float32(1) + e, dt), dt)
    h = _round(_round(g * sig, dt) * u, dt)
    eye = torch.eye(f, dtype=dt)
    plain = to_numpy(ref.swiglu_ref(x, wg, wu, eye).float())
    assert np.array_equal(h, plain)


# -- the plain versions above the threshold against JAX ----------------------------
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("g_f32", [False, True])
def test_norm_matmul_plain_matches_jax_above_the_threshold(dt, g_f32):
    """128 rows (the wgmma route's, in 16-bit) at a reduced width: the
    plain version, which the CPU wrapper runs, against the JAX package's
    oracle and its Pallas kernel in interpret mode."""
    np_dt, t_dt, tol = DTYPES[dt]
    m, d, n = 128, 128, 256
    if t_dt != torch.float32:
        assert kops.norm_matmul_plan(m, d, n, t_dt).route == "wgmma"
    rng = np.random.default_rng(11)
    x = _rand(rng, (m, d), np_dt)
    g = (1 + 0.1 * rng.normal(size=(d,))).astype(
        np.float32 if g_f32 else np_dt)
    w = _rand(rng, (d, n), np_dt, d ** -0.5)
    out = kn.norm_matmul(_t(x), _t(g), _t(w))
    assert torch.equal(out, ref.norm_matmul_ref(_t(x), _t(g), _t(w)))
    out = to_numpy(out)
    jargs = [jnp.asarray(v) for v in (x, g, w)]
    _close(out, np.asarray(jref.norm_matmul_ref(*jargs)), tol)
    _close(out, np.asarray(j_norm_matmul(*jargs, bm=128, bn=128,
                                         interpret=True)), tol)
    with pytest.raises(ValueError):
        kn.norm_matmul_with_rows(_t(x), _t(g), _t(w))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_swiglu_plain_matches_jax_above_the_threshold(dt):
    """128 rows at m 128, d 128, f 256: the plain version against the JAX
    package's oracle and its Pallas kernel in interpret mode."""
    np_dt, t_dt, tol = DTYPES[dt]
    m, d, f, do = 128, 128, 256, 128
    if t_dt != torch.float32:
        assert kops.swiglu_plan(m, d, f, do, t_dt).route == "wgmma"
    rng = np.random.default_rng(12)
    x = _rand(rng, (m, d), np_dt)
    wg = _rand(rng, (d, f), np_dt, d ** -0.5)
    wu = _rand(rng, (d, f), np_dt, d ** -0.5)
    wd = _rand(rng, (f, do), np_dt, f ** -0.5)
    args = [_t(v) for v in (x, wg, wu, wd)]
    out = ks.swiglu(*args)
    assert torch.equal(out, ref.swiglu_ref(*args))
    out = to_numpy(out)
    jargs = [jnp.asarray(v) for v in (x, wg, wu, wd)]
    _close(out, np.asarray(jref.swiglu_ref(*jargs)), tol)
    _close(out, np.asarray(j_swiglu(*jargs, bm=128, bn=128, bf=128,
                                    interpret=True)), tol)
