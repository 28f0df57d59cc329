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
from repro_torch.kernels import flash_attention as kf  # noqa: E402
from repro_torch.kernels import matmul as km  # noqa: E402
from repro_torch.kernels import norm_matmul as kn  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as kr  # noqa: E402
from repro_torch.kernels import swiglu as ks  # noqa: E402

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = {"f32": (np.float32, torch.float32, 1e-4),
          "bf16": (BF16, torch.bfloat16, 3e-2),
          "f16": (np.float16, torch.float16, 3e-2)}


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
    # neither route holds a whole normalized row: both take matmul's
    # tiles at any width (f32 writes the rows to a workspace first)
    assert kops.norm_matmul_plan(4, 4096, 4096, bf).bm == 16
    assert kops.norm_matmul_plan(64, 4096, 4096, bf).bm == 64
    assert kops.norm_matmul_plan(64, 16384, 4096, f32).bm == 32
    assert kops.norm_matmul_plan(4, 4096, 4096, f32).bm == 4
    assert kops.norm_matmul_plan(64, 4096, 4096, f32).bm == 32
    assert kops.norm_matmul_plan(64, 2048, 4096, f32).bm == 32
    assert kops.norm_matmul_supported(1, 1 << 16, 8, f32)
    assert kops.norm_matmul_supported(1, 1 << 16, 8, bf)
    assert not kops.norm_matmul_supported(4, 64, 258, f32)
    # swiglu's gate/up grid at decode: 64 F columns of each of wg and wu
    # a block
    assert kops.swiglu_plan(4, 4096, 11008, 4096, bf).grid == (1, 172)


# -- the kernels' launch plans (mirrors of csrc/) ---------------------------------------
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 65, 512])
@pytest.mark.parametrize("n", [4096, 102400])
def test_matmul_plan_fits_and_fills_the_card(m, n, dt):
    plan = kops.matmul_plan(m, 4096, n, dt)
    assert plan.smem <= 232448
    if m > kops.WG_MIN_ROWS:
        # the wgmma route: persistent blocks, at most one an SM, walk the
        # 128 x 128 tiles; a ring of stages of two lanes' 32-deep k-tiles
        tiles = -(-m // plan.bm) * -(-n // plan.bn)
        assert plan.route == "wgmma" and (plan.bm, plan.bn) == (128, 128)
        assert plan.grid == (min(tiles, kops.WG_SMS), 1)
        assert plan.threads == kops.WG_THREADS and plan.stages >= 3
        assert (plan.stages - 1) * kops.WG_STAGE_K * plan.bn * 2 >= 48 * 1024
        assert plan.grid[0] * plan.grid[1] >= 128
        return
    assert plan.route == "tensor_core"
    assert plan.stages >= 3
    # at least 48 KB of B in flight per block while one stage is used
    assert (plan.stages - 1) * plan.k_stage * plan.bn * 2 >= 48 * 1024
    assert plan.grid[0] * plan.grid[1] >= 128
    assert plan.grid[1] * plan.bm >= m and plan.grid[0] * plan.bn >= n
    assert plan.bm % 16 == 0     # whole m16n8k16 fragments


@pytest.mark.parametrize("k", [40, 256, 1000, 4096, 11008])
def test_matmul_plan_k_order_does_not_depend_on_m(k):
    """The tensor-core route reduces each output over stages of k_stage,
    each split among the 8 warps in fixed slices: nothing of that may
    change with the row count."""
    plans = [kops.matmul_plan(m, k, 4096, torch.bfloat16)
             for m in (1, 4, 64, 96, 512)]
    # 512 rows take the wgmma route, in the same order
    assert [p.route for p in plans] == ["tensor_core"] * 4 + ["wgmma"]
    assert {p.k_stage for p in plans} == {kops.TC_KS}
    assert kops.TC_WARP_K * 8 == kops.TC_KS and kops.TC_WARP_K % 16 == 0
    # the tiles differ; the order they reduce in does not
    assert [(p.bm, p.bn) for p in plans] == [(16, 32), (16, 32), (64, 32),
                                             (64, 64), (128, 128)]
    assert len({kops.matmul_k_order(p, k) for p in plans}) == 1
    assert kops.matmul_plan(1, k, 102400, torch.bfloat16).k_stage == \
        kops.TC_KS


def test_matmul_plan_streams_weights_evict_first():
    """A weight read once per step streams as L2's first victims; the
    839 MB unembed, many times L2, streams without the policy."""
    bf = torch.bfloat16
    assert kops.matmul_plan(4, 4096, 4096, bf).b_evict_first
    assert kops.matmul_plan(512, 4096, 4096, bf).b_evict_first
    unembed = kops.matmul_plan(1, 4096, 102400, bf)
    assert not unembed.b_evict_first
    assert (unembed.bm, unembed.bn, unembed.grid) == (16, 128, (800, 1))


def test_matmul_plan_keeps_f32_on_the_cuda_cores():
    """f32 stays on the CUDA cores (no TF32) in the batched kernel's f32
    order: decode rows on the chunk lanes (32 columns a block, no ring),
    a prefill chunk on a register tile through a cp.async ring."""
    for m in (1, 4, 64):
        plan = kops.matmul_plan(m, 4096, 4096, torch.float32)
        assert plan.route == "cuda_core" and not plan.b_evict_first
        if m <= kops.F32_LANE_ROWS:
            assert (plan.arrangement, plan.bm, plan.bn, plan.stages,
                    plan.k_stage, plan.threads) == ("lanes", m, 32, 0,
                                                    kops.BMM_CHUNK, 128)
        else:
            # 4 groups of threads on different chunks of one 32 x 64 tile
            assert (plan.arrangement, plan.bm, plan.bn, plan.stages,
                    plan.thread_tile, plan.lanes) == ("tile", 32, 64, 2,
                                                      (4, 8), 4)
            assert kops.BMM_CHUNK % plan.k_stage == 0


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [1, 3, 4, 17, 64, 512])
@pytest.mark.parametrize("n", [8, 200, 4096, 102400])
def test_norm_matmul_plan_is_the_matmul_launch(m, n, dt):
    """The 16-bit fused norm runs matmul's launch.  Up to WG_MIN_ROWS
    rows (or where d is not in whole 16-byte vectors) its tensor-core
    tiles: the same tile, ring, K order and L2 policy, whatever the width
    D -- no normalized row is held whole, so M = 64 takes the 64-row
    tile.  Above, where matmul itself takes the wgmma route, its wgmma
    launch on the normalised rows, which the first kernel writes to an
    (m, d) workspace in x's type."""
    for d in (40, 1000, 4096, 1 << 16):
        wg = m > kops.WG_MIN_ROWS and d % 8 == 0
        mm = (kops.matmul_plan if wg else kops.tc_matmul_plan)(m, d, n, dt)
        assert mm.route == ("wgmma" if wg else "tensor_core")
        for g_dt in (dt, torch.float32):
            plan = kops.norm_matmul_plan(m, d, n, dt, g_dt)
            assert plan.route == mm.route and plan.gemm == mm
            assert (plan.bm, plan.bn, plan.grid, plan.stages,
                    plan.k_stage) == (mm.bm, mm.bn, mm.grid, mm.stages,
                                      mm.k_stage)
            assert plan.w_evict_first == mm.b_evict_first
            if wg:
                # the rows in the workspace; no g in the ring
                assert plan.smem == mm.smem <= 232448
                assert (plan.ws_shape, plan.ws_dtype) == ((m, d), dt)
                continue
            # the ring's stages of W and x, and g's slice of each stage
            assert plan.smem == mm.smem + plan.stages * kops.TC_KS * \
                g_dt.itemsize
            # with the norm's 64-row inverse RMS in static shared memory
            assert plan.smem + 64 * 4 <= 232448 and plan.stages >= 3
            assert (plan.ws_shape, plan.ws_dtype) == ((m,), torch.float32)
        if wg:
            assert plan.grid == (kops.wg_blocks(-(-m // 128) * -(-n // 128)),
                                 1)
        else:
            assert plan.grid[1] * plan.bm >= m and \
                plan.grid[0] * plan.bn >= n
    # the final norm + unembed streams evict-normal in 128-column tiles,
    # the qkv projections evict-first
    unembed = kops.norm_matmul_plan(4, 4096, 102400, dt)
    assert (unembed.bm, unembed.bn, unembed.w_evict_first) == (16, 128,
                                                               False)
    assert kops.norm_matmul_plan(64, 4096, 4096, dt).w_evict_first


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64])
@pytest.mark.parametrize("d", [40, 4096, 11008, 16384])
def test_norm_matmul_plan_keeps_f32_on_the_cuda_cores(m, d):
    """f32 keeps the CUDA cores: a row kernel (a warp a row) writes the
    normalised rows, and the product is matmul's f32 launch on them --
    its arrangement, tile and K order at every width, no row held in
    shared memory and no width refused."""
    plan = kops.norm_matmul_plan(m, d, 4096, torch.float32)
    mm = kops.matmul_plan(m, d, 4096, torch.float32)
    assert plan.route == "cuda_core" and not plan.w_evict_first
    assert plan.gemm == mm and mm.route == "cuda_core"
    assert (plan.bm, plan.bn, plan.grid, plan.stages, plan.k_stage,
            plan.smem) == (mm.bm, mm.bn, mm.grid, mm.stages, mm.k_stage,
                           mm.smem)
    assert plan.rows_grid * 8 >= m > (plan.rows_grid - 1) * 8
    assert plan.smem <= 232448
    assert kops.norm_matmul_supported(m, d, 4096, torch.float32)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [1, 3, 4, 16, 17, 64, 100, 512])
@pytest.mark.parametrize("d,f,do", [(4096, 11008, 4096), (1000, 200, 24),
                                    (44, 40, 16), (4096, 11008, 102400)])
def test_swiglu_plan_down_is_the_matmul_launch(m, d, f, do, dt):
    """The 16-bit down product is matmul's launch on h (m, f) and wd (f,
    do): up to WG_MIN_ROWS rows (or where d is not in whole 16-byte
    vectors, which keeps the gate/up on the tiles) its tensor-core tiles
    (``tc_matmul_plan``), above them its wgmma launch (``matmul_plan``)
    -- the same K order for f either way."""
    plan = kops.swiglu_plan(m, d, f, do, dt)
    wg = m > kops.WG_MIN_ROWS and d % 8 == 0
    assert plan.route == ("wgmma" if wg else "tensor_core")
    assert plan.down == (kops.matmul_plan if wg else kops.tc_matmul_plan)(
        m, f, do, dt)
    assert plan.down.route == plan.route
    assert plan.down.k_stage == kops.TC_KS


@pytest.mark.parametrize("d", [40, 1000, 4096, 11008])
def test_swiglu_plan_gate_up_k_order_does_not_depend_on_m(d):
    """g and u are reduced in matmul's K order for d: stages of TC_KS, each
    split among the 8 lanes of the order in fixed slices, whatever the
    row count picks for the route and tile."""
    rows = (1, 4, 16, 17, 64, 512)
    plans = [kops.swiglu_plan(m, d, 11008, 4096, torch.bfloat16)
             for m in rows]
    # 512 rows take the wgmma mainloop (d % 8 == 0 at every d here)
    assert [p.route for p in plans] == ["tensor_core"] * 5 + ["wgmma"]
    assert {p.k_stage for p in plans} == {kops.TC_KS}
    assert kops.TC_WARP_K * 8 == kops.TC_KS
    # the tiles differ; the order they reduce in does not
    assert [(p.bm, p.bf) for p in plans] == \
        [(16, 64)] * 3 + [(64, 32)] * 2 + [(128, 64)]
    # the same K order as matmul's for (m, d) @ (d, f)
    assert all(p.k_stage == kops.matmul_plan(m, d, 11008, torch.bfloat16)
               .k_stage for p, m in zip(plans, rows))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 65, 512, 1000])
@pytest.mark.parametrize("f", [8, 40, 200, 1000, 11008])
def test_swiglu_plan_fits_and_covers(m, f, dt):
    """The gate/up block fits one SM's shared memory, keeps at least 48 KB
    of B in flight, and the grid covers every (row, F column); its B
    tile is bf columns of wg beside bf of wu.  Tiles (up to WG_MIN_ROWS
    rows): a ring of x and of wg + wu stages, or the epilogue's warp
    partials, the row tiles fastest.  wgmma (above): matmul's ring of
    64-deep stages, 128-row tiles of 64 F columns each walked by at most
    one persistent block an SM."""
    plan = kops.swiglu_plan(m, 4096, f, 4096, dt)
    bn = 2 * plan.bf
    assert plan.smem <= 232448 and plan.down.smem <= 232448
    assert plan.stages >= 3 and plan.bm % 16 == 0
    if m > kops.WG_MIN_ROWS:
        assert plan.route == "wgmma" and plan.smem == kops.WG_SMEM
        assert (plan.bm, bn) == (kops.WG_BM, kops.WG_BN)
        assert (plan.stages - 1) * kops.WG_STAGE_K * bn * 2 >= 48 * 1024
        tiles = -(-m // plan.bm) * -(-f // plan.bf)
        assert plan.grid == (kops.wg_blocks(tiles), 1)
    else:
        assert plan.smem == kops.tc_smem_bytes(plan.bm, bn, plan.stages)
        assert (plan.stages - 1) * plan.k_stage * bn * 2 >= 48 * 1024
        # row tiles fastest: the row tiles of one F tile run together
        assert plan.grid[0] * plan.bm >= m > (plan.grid[0] - 1) * plan.bm
        assert plan.grid[1] * plan.bf >= f > (plan.grid[1] - 1) * plan.bf
    # wg + wu (2 x 4096 x f) stream evict-first, as matmul's B up to 256 MB
    assert plan.b_evict_first


def test_swiglu_plan_at_deepseek_widths():
    """At deepseek-7b's widths the decode gate/up launch has 172 blocks of
    16 rows, each with 128 KB of wg + wu in flight, and the down launch is
    matmul's 128 blocks; the dense prefill (512 rows) takes the wgmma
    mainloop for both: 4 x 172 tiles of 64 F columns on 132 persistent
    blocks, then matmul's 4 x 32 tiles on 128."""
    plan = kops.swiglu_plan(4, 4096, 11008, 4096, torch.bfloat16)
    assert (plan.bm, plan.bf, plan.stages) == (16, 64, 3)
    assert (plan.stages - 1) * plan.k_stage * 2 * plan.bf * 2 == 128 << 10
    assert plan.grid == (1, 172)
    assert plan.down.grid == (128, 1)
    dense = kops.swiglu_plan(512, 4096, 11008, 4096, torch.bfloat16)
    assert dense.route == dense.down.route == "wgmma"
    assert dense.grid == (132, 1) and dense.down.grid == (128, 1)


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 512])
@pytest.mark.parametrize("d,f,do", [(4096, 11008, 4096), (44, 40, 16)])
def test_swiglu_plan_keeps_f32_on_the_cuda_cores(m, d, f, do):
    """f32 keeps the CUDA cores for both launches (no TF32): the gate/up
    kernel on f32_gemm.cuh's chunk lanes up to 4 rows (16 F columns of
    each of wg and wu a block), else its register tiles (32 x 32 up to 32
    rows, 32 x 64 beyond), rows fastest; the down product is matmul's f32
    launch on h."""
    plan = kops.swiglu_plan(m, d, f, do, torch.float32)
    gu = plan.gate_up
    assert plan.route == "cuda_core" and not plan.b_evict_first
    assert plan.down == kops.matmul_plan(m, f, do, torch.float32)
    assert gu.route == "cuda_core" and gu.bn == 2 * plan.bf
    assert (plan.bm, plan.grid, plan.stages, plan.k_stage, plan.smem) == \
        (gu.bm, gu.grid, gu.stages, gu.k_stage, gu.smem)
    if m <= kops.F32_LANE_ROWS:
        assert (gu.arrangement, plan.bf, plan.smem) == ("lanes", 16, 0)
    else:
        assert gu.arrangement == "tile" and plan.bm == 32
        assert plan.bf == (16 if m <= 32 else 32)
        assert plan.smem <= 232448
    # rows fastest; the grid covers every (row, F column)
    assert plan.grid[0] * plan.bm >= m > (plan.grid[0] - 1) * plan.bm
    assert plan.grid[1] * plan.bf >= f > (plan.grid[1] - 1) * plan.bf


# every arrangement and tile of the f32 route (csrc/f32_gemm.cuh): (m, n)
# pairs that reach the cluster per output, the chunk lanes at 1, 2 and 4
# rows, the narrow tile and each of the two register tiles
F32_MATMUL_SHAPES = [(1, 8), (4, 8), (32, 8), (1, 4096), (2, 4096),
                     (4, 4096), (5, 4096), (16, 4096), (1, 102400),
                     (17, 8), (4224, 8), (512, 4096), (128, 4096),
                     (64, 4096), (33, 4096), (17, 256), (256, 256)]


@pytest.mark.parametrize("k", [1, 40, 256, 257, 2047, 2048, 4096, 6144,
                               11008])
def test_matmul_k_order_is_the_batched_kernels_f32_order(k):
    """matmul's f32 order is the batched kernel's: chunks of 256 added in
    order, each the sum in order of its sub-chains of 32, each ascending
    -- at every arrangement and tile the plan can give, whatever M and
    N."""
    want = kops.batched_matmul_k_order(
        kops.batched_matmul_plan(1, 1, 1, k, torch.float32), k)
    assert want == tuple(tuple(tuple(range(s, min(s + 32, k)))
                               for s in range(c, min(c + 256, k), 32))
                         for c in range(0, k, 256))
    arrangements = set()
    for m, n in F32_MATMUL_SHAPES:
        plan = kops.matmul_plan(m, k, n, torch.float32)
        assert plan.route == "cuda_core"
        assert kops.matmul_k_order(plan, k) == want, (m, n, plan)
        assert kops.matmul_k_order(plan, k) == kops.batched_matmul_k_order(
            kops.batched_matmul_plan(1, m, n, k, torch.float32), k)
        arrangements.add((plan.arrangement, plan.bm, plan.bn))
    tiles = {(a, bm, bn) for a, bm, bn in arrangements if a == "tile"}
    assert tiles == {("tile", 32, 8), ("tile", 32, 32), ("tile", 32, 64)}
    assert {bm for a, bm, _ in arrangements if a == "lanes"} == {1, 2, 4}
    assert (("split", 1, 1) in arrangements) == (k >= kops.BMM_SPLIT_MIN_K)


@pytest.mark.parametrize("k", [40, 4096, 11008])
def test_matmul_k_order_keeps_the_tensor_cores_warp_slices(k):
    """The 16-bit route's order: warp w takes k // 32 % 8 == w, stages in
    order -- the batched kernel's 16-bit order too."""
    plan = kops.matmul_plan(4, k, 4096, torch.bfloat16)
    order = kops.matmul_k_order(plan, k)
    assert order == kops.batched_matmul_k_order(
        kops.batched_matmul_plan(1, 4, 4096, k, torch.bfloat16), k)
    assert all(kk // kops.TC_WARP_K % 8 == w
               for w, lane in enumerate(order) for kk in lane)


# (m, k, n) -> (arrangement, bm, bn, grid, stages, k_stage, threads,
# cluster): the f32 route at the main paths' shapes
F32_NAMED_MATMULS = {
    # decode's wo at 4 slots: 128 blocks of 32 columns, 16 chunks a block
    "decode wo": ((4, 4096, 4096), ("lanes", 4, 32, (128, 1), 0, 256, 128,
                                    1)),
    # the unembed of a prefill's last row: 3200 blocks
    "unembed": ((1, 4096, 102400), ("lanes", 1, 32, (3200, 1), 0, 256, 128,
                                    1)),
    # phase 14's f32 prefill: groups of threads on different chunks of
    # one tile, 8 of 64 up to 32 rows (128 blocks), else 4 (two blocks
    # an SM)
    "prefill 32": ((32, 4096, 4096), ("tile", 32, 32, (128, 1), 2, 32, 512,
                                      1)),
    "prefill 64": ((64, 4096, 4096), ("tile", 32, 64, (64, 2), 2, 16, 256,
                                      1)),
    "prefill 128": ((128, 4096, 4096), ("tile", 32, 64, (64, 4), 2, 16, 256,
                                        1)),
    "dense 512": ((512, 4096, 4096), ("tile", 32, 64, (64, 16), 2, 16, 256,
                                      1)),
    # deepseek-v3's router at decode: 28 chunks, 32 lanes a block
    "v3 router decode": ((4, 7168, 256), ("lanes", 4, 32, (8, 1), 0, 256,
                                          256, 1)),
    # mixtral's router: a cluster per output at decode (4 x 8 over 6144),
    # the narrow tile on its 4,224-row prefill
    "router decode": ((4, 6144, 8), ("split", 1, 1, (256, 1), 0, 256, 256,
                                     8)),
    "router 4224": ((4224, 6144, 8), ("tile", 32, 8, (1, 132), 3, 32, 256,
                                      1)),
}


@pytest.mark.parametrize("name", sorted(F32_NAMED_MATMULS))
def test_matmul_f32_plan_at_the_main_paths_shapes(name):
    (m, k, n), want = F32_NAMED_MATMULS[name]
    p = kops.matmul_plan(m, k, n, torch.float32)
    assert (p.arrangement, p.bm, p.bn, p.grid, p.stages, p.k_stage,
            p.threads, p.cluster) == want
    assert p.smem <= 232448
    if p.arrangement != "split":
        assert p.grid[0] * p.bn >= n and p.grid[1] * p.bm >= m


def test_swiglu_predicate_takes_an_unaligned_d():
    """F and Do must split into 16-byte vectors; D need not (the
    mainloop reads an unaligned x element by element)."""
    bf, f32 = torch.bfloat16, torch.float32
    assert kops.swiglu_supported(3, 44, 40, 16, bf)
    assert kops.swiglu_supported(3, 45, 40, 16, bf)
    assert kops.swiglu_supported(3, 45, 40, 16, f32)
    assert not kops.swiglu_supported(3, 64, 36, 16, bf)
    assert kops.swiglu_supported(3, 64, 36, 16, f32)
    assert not kops.swiglu_supported(3, 64, 40, 12, bf)
    assert not kops.swiglu_supported(3, 64, 40, 16, torch.float64)
    # h is (m, f): its elements must be 32-bit indexable too
    assert not kops.swiglu_supported(1 << 17, 64, 1 << 15, 16, bf)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [3, 40, 4096, 4100, 8192, 16384, 65536])
def test_rmsnorm_plan_covers_the_row(d, dt):
    plan = kops.rmsnorm_plan(d, dt)
    assert plan.vector == (d % kops.vec(dt) == 0)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.threads * plan.per_thread * plan.rounds >= plan.units
    assert plan.threads * plan.per_thread * (plan.rounds - 1) < plan.units
    # a thread holds 64 bytes of x per round on either path
    unit_bytes = 16 if plan.vector else dt.itemsize
    assert plan.per_thread * unit_bytes == 64
    if d * dt.itemsize <= 512 * 64:
        assert plan.rounds == 1    # one round trip: the row in registers


def test_rmsnorm_plan_spreads_decode_rows():
    """One block per row with the threads set by d: 4 decode rows of
    4096 get 4 blocks of 128 threads (the old kernel put 8 rows in one
    block)."""
    plan = kops.rmsnorm_plan(4096, torch.bfloat16)
    assert (plan.threads, plan.rounds, plan.units) == (128, 1, 512)


# -- the CUDA kernels (skip without a card) ----------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


CUDA_CASES = [("matmul", (4, 4096, 4096)), ("matmul", (5, 96, 24)),
              # a K tail that is no whole stage and no multiple of 16; a
              # K whose A rows are not 16-byte aligned; the dense prefill
              ("matmul", (65, 40, 8)), ("matmul", (3, 44, 16)),
              ("matmul", (512, 4096, 4096)),
              ("rmsnorm", (4, 4100)), ("rmsnorm", (512, 4096)),
              ("norm_matmul", (4, 4096, 1024)), ("norm_matmul", (3, 40, 16)),
              # the tensor-core route: a 64-row tile, a D tail that is no
              # whole stage, an unaligned D, N = 8, N no whole tile
              ("norm_matmul", (64, 4096, 4096)),
              ("norm_matmul", (17, 1000, 200)), ("norm_matmul", (4, 44, 8)),
              ("norm_matmul", (512, 256, 64)),
              ("swiglu", (4, 512, 1024, 256)), ("swiglu", (3, 64, 40, 24)),
              # (M, D, F, Do): the prefill chunk; an F tail that is no
              # whole tile; an unaligned D; 8 row tiles of the dense tile
              ("swiglu", (64, 4096, 11008, 4096)),
              ("swiglu", (17, 1000, 200, 24)), ("swiglu", (3, 44, 40, 16)),
              ("swiglu", (512, 256, 1000, 64)),
              ("rmsnorm", (4, 4096)), ("rmsnorm", (3, 40)),
              # (B, Hq, Hkv, Sq, Skv, D, decode offset or None)
              ("flash_attention", (4, 32, 32, 1, 256, 128, 255)),
              ("flash_attention", (2, 8, 2, 45, 70, 64, None))]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
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
    elif kernel == "rmsnorm":
        m, d = shape
        args = (r(m, d), 1 + 0.1 * torch.randn(d, generator=gen,
                                               device=cuda_device))
        mod, plain = kr, ref.rmsnorm_ref
        out = kr.rmsnorm(*args)
    else:
        b, hq, hkv, sq, skv, d, off = shape
        args = (r(b, hq, sq, d), r(b, hkv, skv, d), r(b, hkv, skv, d))
        mod = kf

        def plain(q, k, v):
            return ref.flash_attention_ref(q, k, v, q_offset=off)
        out = kf.flash_attention(*args, q_offset=off)
    torch.cuda.synchronize()
    before = mod.launches
    expect = plain(*args)
    assert mod.launches == before
    _close(to_numpy(out.float()), to_numpy(expect.float()), tol)


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("kernel,shape", [("matmul", (1000, 256)),
                                          ("matmul", (4096, 64)),
                                          ("rmsnorm", (4096,)),
                                          ("rmsnorm", (4100,)),
                                          ("norm_matmul", (4096, 64)),
                                          ("norm_matmul", (1000, 200)),
                                          ("swiglu", (4096, 11008, 4096)),
                                          ("swiglu", (1000, 200, 24))])
def test_cuda_row_alone_equals_row_in_batch(cuda_device, kernel, shape, dt):
    """A row computed alone and inside batches of 4, 64 and 512 rows, at
    a different position in each, gives the same bits: the order of every
    reduction depends on the contraction length alone."""
    _, t_dt, _ = DTYPES[dt]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(1)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=cuda_device)
                * scale).to(t_dt)

    k = shape[0]
    if kernel == "matmul":
        w = r(k, shape[1], scale=k ** -0.5)
        run = lambda a: km.matmul(a, w)  # noqa: E731
    elif kernel == "norm_matmul":
        g = 1 + 0.1 * torch.randn(k, generator=gen, device=cuda_device)
        w = r(k, shape[1], scale=k ** -0.5)
        run = lambda a: kn.norm_matmul(a, g, w)  # noqa: E731
    elif kernel == "swiglu":
        f, do = shape[1], shape[2]
        wg, wu = r(k, f, scale=k ** -0.5), r(k, f, scale=k ** -0.5)
        wd = r(f, do, scale=f ** -0.5)
        run = lambda a: ks.swiglu(a, wg, wu, wd)  # noqa: E731
    else:
        w = 1 + 0.1 * torch.randn(k, generator=gen, device=cuda_device)
        run = lambda a: kr.rmsnorm(a, w)  # noqa: E731
    probe = r(1, k)
    alone = run(probe)
    for m, pos in ((4, 3), (64, 37), (512, 300)):
        batch = r(m, k)
        batch[pos] = probe[0]
        out = run(batch)
        assert torch.equal(_bits(out[pos:pos + 1]), _bits(alone)), (m, pos)
        assert torch.equal(_bits(out), _bits(run(batch)))


F32_PROBE_ROWS = (1, 2, 4, 5, 16, 17, 32, 64, 65, 128, 129)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["matmul", "router", "swiglu"])
def test_cuda_f32_row_alone_equals_row_in_batch_at_every_tile(cuda_device,
                                                             kernel):
    """f32 matmul and swiglu: a probe row alone and inside batches whose
    row counts take each arrangement and tile of matmul's f32 route (for
    the router's 8 columns, the cluster per output too) and swiglu's row
    tiles, at a different place in each, gives the same bits."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)

    def r(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=cuda_device) * scale

    if kernel == "swiglu":
        d, f = 4096, 11008
        wg, wu = r(d, f, scale=d ** -0.5), r(d, f, scale=d ** -0.5)
        wd = r(f, d, scale=f ** -0.5)
        run = lambda a: ks.swiglu(a, wg, wu, wd)  # noqa: E731
    else:
        d, n = (6144, 8) if kernel == "router" else (4096, 4096)
        w = r(d, n, scale=d ** -0.5)
        run = lambda a: km.matmul(a, w)  # noqa: E731
    probe = r(1, d)
    alone = run(probe)
    for m in F32_PROBE_ROWS:
        # the last row at an odd count (the ragged last tile), else 5/8 of
        # the way in (past the first tile)
        pos = m - 1 if m % 2 else 5 * m // 8
        batch = r(m, d)
        batch[pos] = probe[0]
        out = run(batch)
        assert torch.equal(_bits(out[pos:pos + 1]), _bits(alone)), (m, pos)
        assert torch.equal(_bits(out), _bits(run(batch)))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(m, 4096, 4096) for m in F32_PROBE_ROWS]
                         + [(1, 4096, 102400), (4, 6144, 8), (33, 6144, 8),
                            (4224, 6144, 8), (3, 40, 8), (17, 300, 24)])
def test_cuda_f32_matmul_is_the_batched_kernels_order(cuda_device, m, k, n):
    """One f32 order in the port: f32 matmul(a, b) is bit for bit the
    batched kernel's batched_matmul(a[None], b[None])[0]."""
    from repro_torch.kernels import batched_matmul as kb
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(4)
    a = torch.randn((m, k), generator=gen, device=cuda_device)
    b = torch.randn((k, n), generator=gen, device=cuda_device) * k ** -0.5
    assert torch.equal(_bits(km.matmul(a, b)),
                       _bits(kb.batched_matmul(a[None], b[None],
                                               torch.float32)[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f16"])
@pytest.mark.parametrize("g_f32", [False, True])
@pytest.mark.parametrize("m", [1, 3, 4, 17, 64, 512])
@pytest.mark.parametrize("d,n", [(4096, 1024), (1000, 200), (44, 8),
                                 (4096, 8192)])
def test_cuda_norm_matmul_tensor_core_route(cuda_device, d, n, m, g_f32, dt):
    """The 16-bit fused norm on the tensor-core mainloop: within the
    16-bit tolerance of the plain version for g in x's dtype and in f32,
    across M, a D tail (1000), an unaligned D (44) and narrow or ragged
    N; two launches bitwise equal; and a probe row gives the same bits
    alone and at another position in the batch."""
    _, t_dt, tol = DTYPES[dt]
    assert kops.norm_matmul_plan(m, d, n, t_dt).route == "tensor_core"
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m + d + n)
    x = torch.randn((m, d), generator=gen, device=cuda_device).to(t_dt)
    g = 1 + 0.1 * torch.randn(d, generator=gen, device=cuda_device)
    g = g if g_f32 else g.to(t_dt)
    w = (torch.randn((d, n), generator=gen, device=cuda_device)
         * d ** -0.5).to(t_dt)
    out = kn.norm_matmul(x, g, w)
    torch.cuda.synchronize()
    _close(to_numpy(out.float()), to_numpy(ref.norm_matmul_ref(x, g, w)
                                           .float()), tol)
    assert torch.equal(_bits(out), _bits(kn.norm_matmul(x, g, w)))
    alone = kn.norm_matmul(x[m - 1:], g, w)
    assert torch.equal(_bits(out[m - 1:]), _bits(alone))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("m,d,f,do", [(4, 4096, 11008, 4096),
                                      (64, 4096, 11008, 4096),
                                      (512, 256, 1000, 64),
                                      (17, 1000, 200, 24)])
def test_cuda_swiglu_alternating_inputs(cuda_device, m, d, f, do, dt):
    """The down launch reads h only after griddepcontrol.wait: called on
    two different inputs in turn, each call gives its own input's output
    (within tolerance of the plain version, and bitwise the same as the
    first call on that input), never one built from the other call's h,
    which the allocator tends to hand back at the same address."""
    _, t_dt, tol = DTYPES[dt]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(m + f)

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=gen, device=cuda_device)
                * scale).to(t_dt)

    wg, wu = r(d, f, scale=d ** -0.5), r(d, f, scale=d ** -0.5)
    wd = r(f, do, scale=f ** -0.5)
    xs = [r(m, d), r(m, d)]
    plain = [ref.swiglu_ref(x, wg, wu, wd) for x in xs]
    first = [None, None]
    for i in range(8):
        out = ks.swiglu(xs[i % 2], wg, wu, wd)
        torch.cuda.synchronize()
        _close(to_numpy(out.float()), to_numpy(plain[i % 2].float()), tol)
        if first[i % 2] is None:
            first[i % 2] = out
        assert torch.equal(_bits(out), _bits(first[i % 2])), i
    assert not torch.equal(_bits(first[0]), _bits(first[1]))


# -- the fixed-order batched matmul on the card ---------------------------------------
# (batch, M, N, K, a transposed, b transposed): decode attention's q.k^T
# (B*Hkv 128, M 1, over 256 keys, B read as (N, K)) and its p.V, a
# chunked prefill's scores, ragged edges and an unaligned K, the
# backward's transposed A, the sampler's pick of one logit out of the
# vocabulary and other Ks of many f32 chunks (a block per output, and a
# thread per output for few rows)
BMM_CASES = [(128, 1, 256, 128, False, True), (128, 1, 128, 256, False, False),
             (32, 64, 40, 128, False, True), (3, 5, 13, 7, False, False),
             (2, 33, 72, 100, True, False), (1, 130, 96, 257, True, True),
             (4, 1, 1, 102400, False, False), (8, 3, 200, 5000, True, True),
             (64, 4, 64, 3000, False, False),
             # 8 x 8 transposed copies of A (K, M) and of B (N, K)
             (2, 64, 72, 128, True, False), (4, 16, 40, 256, True, True)]


def _bmm_operands(gen, device, t_dt, batch, m, n, k, a_t, b_t):
    def r(*s):
        return torch.randn(s, generator=gen, device=device).to(t_dt)
    a = r(batch, k, m).transpose(1, 2) if a_t else r(batch, m, k)
    b = r(batch, n, k).transpose(1, 2) if b_t else r(batch, k, n)
    return a, b * k ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("case", BMM_CASES)
def test_cuda_batched_matmul_matches_plain(cuda_device, case, dt):
    """The kernel against its plain version within the repo's tolerance
    (f32 out), strided operands read in place; two launches bitwise."""
    from repro_torch.kernels import batched_matmul as kb
    _, t_dt, tol = DTYPES[dt]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(sum(case[:4]))
    a, b = _bmm_operands(gen, cuda_device, t_dt, *case)
    before = kb.launches
    out = kb.batched_matmul(a, b, torch.float32)
    assert kb.launches == before + 1
    torch.cuda.synchronize()
    _close(to_numpy(out), to_numpy(ref.batched_matmul_ref(a, b)), tol)
    assert torch.equal(_bits(out), _bits(kb.batched_matmul(a, b,
                                                           torch.float32)))
    if dt != "f32":   # out in the operands' type: the f32 sum rounded
        low = kb.batched_matmul(a, b)
        assert low.dtype == t_dt and torch.equal(_bits(low),
                                                 _bits(out.to(t_dt)))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b_t", [False, True])
def test_cuda_batched_matmul_probe_is_batch_invariant(cuda_device, b_t, dt):
    """A probe (batch entry, row) gives the same bits alone and inside
    batches of 1, 3, 4 and 32 entries at M of 1, 3, 5, 8, 16, 32 and 64
    (every f32 tile), at another place in each: the k order is a function
    of K alone."""
    from repro_torch.kernels import batched_matmul as kb
    _, t_dt, _ = DTYPES[dt]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(7)
    k, n = 128, 40
    pa, pb = _bmm_operands(gen, cuda_device, t_dt, 1, 1, n, k, False, b_t)
    alone = kb.batched_matmul(pa, pb, torch.float32)
    for batch in (1, 3, 4, 32):
        for m in (1, 3, 5, 8, 16, 32, 64):
            a, b = _bmm_operands(gen, cuda_device, t_dt, batch, m, n, k,
                                 False, b_t)
            i, row = (batch * 7 + m) % batch, (m * 5 + batch) % m
            a[i, row] = pa[0, 0]
            b[i] = pb[0]
            out = kb.batched_matmul(a, b, torch.float32)
            assert torch.equal(_bits(out[i, row]), _bits(alone[0, 0])), \
                (batch, m, i, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_batched_matmul_zero_padded_k_gives_the_same_bits(cuda_device,
                                                               dt):
    """Zeros appended to K (a padded cache width, here 40 -> 64 and ->
    300; and 5000 -> 5300, over many f32 chunks) add exact zeros to the
    same sums."""
    from repro_torch.kernels import batched_matmul as kb
    _, t_dt, _ = DTYPES[dt]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    for k, pads in ((40, (24, 260)), (5000, (300,))):
        a, b = _bmm_operands(gen, cuda_device, t_dt, 4, 16, 128, k, False,
                             False)
        want = kb.batched_matmul(a, b, torch.float32)
        for pad in pads:
            ap = torch.nn.functional.pad(a, (0, pad))
            bp = torch.nn.functional.pad(b, (0, 0, 0, pad))
            assert torch.equal(_bits(kb.batched_matmul(ap, bp,
                                                       torch.float32)),
                               _bits(want)), (k, pad)
