"""The wgmma mainloop (``csrc/wg_gemm.cuh``) on the CPU: its walk over k
(``ops.wg_k_walk``) against the port's one 16-bit K order
(``ops.matmul_k_order``), emulated in numpy; and the launch plans that
choose it (``ops.matmul_plan`` above ``WG_MIN_ROWS`` rows, the batched
kernel's training tiles where the TMA unit reads both operands).  The
kernel itself runs only on a card (``chip_smoke.py``'s phase 3, and
``python -m repro_torch.kernels.wgmma_probe`` for the arithmetic it rests
on: one k16 step of wgmma rounds as one of mma.sync).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as kops  # noqa: E402

WALK_KS = (16, 32, 48, 256, 300, 2048, 4096, 6144, 11008)


@pytest.mark.parametrize("k", WALK_KS)
def test_walk_covers_each_k_once(k):
    """The ring stages' k-tiles of the lanes that hold data cover every k
    in [0, K) exactly once; whatever else a stage holds lies past K (the
    TMA unit's zeros).  Each lane's k-tiles come in ascending k."""
    seen = []
    per_lane = {}
    for p, s, k0 in kops.wg_k_walk(k):
        assert k0 == s * kops.TC_KS + p * kops.WG_STAGE_K
        for half in (0, 1):
            lane = 2 * p + half
            lo = k0 + half * kops.TC_WARP_K
            ks = list(range(lo, lo + kops.TC_WARP_K))
            if lane >= kops.wg_lanes(k):
                assert all(kk >= k for kk in ks)
                continue
            seen += [kk for kk in ks if kk < k]
            per_lane.setdefault(lane, []).extend(ks)
    assert sorted(seen) == list(range(k)) and len(seen) == k
    for lane, ks in per_lane.items():
        assert ks == sorted(ks)
        assert {kk // kops.TC_WARP_K % 8 for kk in ks} == {lane}


def _step(acc, a, b, g):
    """One k16 step on f32 accumulators ``acc`` (m, n): the 16 exact
    products of group ``g`` (k in [16 g, 16 g + 16), zeros past K) and
    the accumulator summed exactly, then rounded to f32 once."""
    k = a.shape[1]
    lo, hi = 16 * g, min(16 * g + 16, k)
    out = np.empty_like(acc)
    for i in range(acc.shape[0]):
        for j in range(acc.shape[1]):
            terms = [float(acc[i, j])]
            if lo < k:
                terms += list(a[i, lo:hi].astype(np.float64)
                              * b[lo:hi, j].astype(np.float64))
            out[i, j] = np.float32(math.fsum(terms))
    return out


def _order_sum(a, b, order):
    """The 16-bit order as tc_gemm.cuh runs it: each lane's chain from +0
    over its k16 groups in order, the lanes added in order to +0."""
    m, n = a.shape[0], b.shape[1]
    tot = np.zeros((m, n), np.float32)
    for lane in order:
        acc = np.zeros((m, n), np.float32)
        for g in dict.fromkeys(kk // 16 for kk in lane):
            acc = _step(acc, a, b, g)
        tot = (tot + acc).astype(np.float32)
    return tot


def _walk_sum(a, b, k):
    """The same sums as the wgmma mainloop walks them: per lane pair,
    acc0 and acc1 over the ring stages, then tot += acc0, tot += acc1."""
    m, n = a.shape[0], b.shape[1]
    tot = np.zeros((m, n), np.float32)
    walk = kops.wg_k_walk(k)
    for p in dict.fromkeys(p for p, _, _ in walk):
        acc0 = np.zeros((m, n), np.float32)
        acc1 = np.zeros((m, n), np.float32)
        for _, _, k0 in (w for w in walk if w[0] == p):
            for h in range(2):
                acc0 = _step(acc0, a, b, (k0 + 16 * h) // 16)
            for h in range(2, 4):
                acc1 = _step(acc1, a, b, (k0 + 16 * h) // 16)
        tot = (tot + acc0).astype(np.float32)
        if 2 * p + 1 < kops.wg_lanes(k):
            tot = (tot + acc1).astype(np.float32)
    return tot


@pytest.mark.parametrize("k", WALK_KS)
def test_walk_emulation_is_the_orders_bits(k):
    """In numpy, with f32 chains and sums and each k16 group one exact
    step, the walk gives bitwise what the order gives (the tensor-core
    route's ``matmul_k_order``), on values whose products spread over
    many binades."""
    rng = np.random.default_rng(k)
    m, n = 2, 3
    a = (rng.standard_normal((m, k)) * np.exp2(rng.integers(-12, 12, (m, k)))
         ).astype(np.float32)
    b = (rng.standard_normal((k, n)) * np.exp2(rng.integers(-12, 12, (k, n)))
         ).astype(np.float32)
    # 16-bit operands (bf16's 8 significant bits): exact products in f64
    a = torch.from_numpy(a).bfloat16().float().numpy()
    b = torch.from_numpy(b).bfloat16().float().numpy()
    order = kops.matmul_k_order(kops.tc_matmul_plan(4, k, 8, torch.bfloat16),
                                k)
    want = _order_sum(a, b, order)
    got = _walk_sum(a, b, k)
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("k", [40, 44, 4096, 6144])
@pytest.mark.parametrize("m", [1, 4, 64, 65, 96, 97, 128, 512, 2048, 4224])
def test_matmul_takes_the_new_route_exactly_above_the_threshold(m, k, dt):
    """matmul's 16-bit launch takes the wgmma route above WG_MIN_ROWS
    rows where A's rows are whole 16-byte vectors (k % 8 == 0), the
    tensor-core tiles elsewhere; f32 keeps the CUDA cores."""
    plan = kops.matmul_plan(m, k, 4096, dt)
    new = m > kops.WG_MIN_ROWS and k % 8 == 0
    assert plan.route == ("wgmma" if new else "tensor_core")
    if new:
        assert (plan.bm, plan.bn, plan.stages, plan.smem, plan.threads) == \
            (128, 128, kops.WG_STAGES, kops.WG_SMEM, kops.WG_THREADS)
        assert plan.arrangement == "persistent"
    else:
        assert plan == kops.tc_matmul_plan(m, k, 4096, dt)
    assert kops.matmul_plan(m, k, 4096, torch.float32).route == "cuda_core"
    assert 64 < kops.WG_MIN_ROWS <= 512


@pytest.mark.parametrize("a_t,b_t", [(False, False), (False, True),
                                     (True, False), (True, True)])
@pytest.mark.parametrize("m,n,k", [(64, 256, 4096), (65, 256, 4096),
                                   (65, 72, 40), (128, 4096, 32),
                                   (2048, 4096, 4096), (4096, 11008, 2048),
                                   (130, 200, 300), (1040, 4096, 4),
                                   (4100, 72, 1000)])
def test_batched_takes_the_new_route_only_where_tma_reads_both(m, n, k, a_t,
                                                               b_t):
    """The batched kernel's 16-bit training tiles (more than 64 rows, K
    over one lane) take the wgmma mainloop exactly where both operands
    are in the "rows" or "columns" copy mode; an element-by-element copy
    keeps bmm_seq_kernel."""
    plan = kops.batched_matmul_plan(2, m, n, k, torch.bfloat16, a_t, b_t)
    tma = "elements" not in (plan.a_copy, plan.b_copy)
    new = m > 64 and k > 32 and tma
    assert plan.kernel == ("wg_gemm_kernel" if new else "bmm_seq_kernel")
    assert plan.route == "tensor_core"
    if new:
        assert (plan.bm, plan.bn, plan.ring_k, plan.threads) == \
            (128, 128, kops.WG_STAGE_K, kops.WG_THREADS)
        tiles = 2 * -(-m // 128) * -(-n // 128)
        assert plan.grid == (min(tiles, kops.WG_SMS), 1)
    plan32 = kops.batched_matmul_plan(2, m, n, k, torch.float32, a_t, b_t)
    assert plan32.route == "cuda_core"


def test_new_plan_fits_in_shared_memory():
    """The ring of WG_STAGES stages (128 x 64 of A and of B, 16-bit), the
    two consumers' staged outputs (64 x 128 f32) and the ring's
    mbarriers, on 1024 bytes: within the 227 KB a block may use."""
    ring = kops.WG_STAGES * 2 * 128 * kops.WG_STAGE_K * 2
    assert kops.WG_SMEM == 1024 + ring + 2 * 64 * 128 * 4 + \
        2 * kops.WG_STAGES * 8
    assert kops.WG_SMEM <= kops._SMEM == 232448
    for m in (97, 512, 4224):
        assert kops.matmul_plan(m, 4096, 4096, torch.bfloat16).smem <= \
            kops._SMEM
    assert kops.batched_matmul_plan(1, 2048, 4096, 4096, torch.bfloat16,
                                    False, True).smem <= kops._SMEM


@pytest.mark.parametrize("k", [16, 40, 256, 300, 4096, 6144, 11008])
def test_matmul_k_order_is_one_across_the_threshold(k):
    """matmul_k_order and batched_matmul_k_order give one order on both
    sides of the threshold and in both batched kernels: the bits of a row
    alone (the tensor-core tiles) are its bits inside a 4,224-row prefill
    (the wgmma route)."""
    plans = [kops.matmul_plan(m, k, 4096, torch.bfloat16)
             for m in (1, 64, kops.WG_MIN_ROWS, kops.WG_MIN_ROWS + 1, 4224)]
    assert {p.route for p in plans} == (
        {"tensor_core", "wgmma"} if k % 8 == 0 else {"tensor_core"})
    orders = {kops.matmul_k_order(p, k) for p in plans}
    bplans = [kops.batched_matmul_plan(1, m, 4096, k, torch.bfloat16)
              for m in (1, 64, 65, 2048)]
    orders |= {kops.batched_matmul_k_order(p, k) for p in bplans}
    assert len(orders) == 1
