"""The port's one f32 contraction order (``csrc/f32_gemm.cuh``, stated by
``kernels/ops.py:f32_k_order``): chunks of 256 k added in order, each
the sum in order of its sub-chains of 32 consecutive k, each sub-chain one
fmaf chain from +0.  Every f32 launch plan states it -- matmul's, the
batched kernel's, swiglu's gate/up and down, norm_matmul's product --
and a numpy emulation of it is more accurate than one 256-long chain.
CPU only: the plans are mirrors of the CUDA sources, and the kernels'
bits are held on the card by ``chip_smoke.py`` phase 3.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import norm_matmul as kn
from repro_torch.kernels import ops as kops
from repro_torch.kernels import swiglu as ks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32
KS = [1, 31, 32, 33, 255, 256, 257, 4096, 11008]
ROWS = [1, 2, 3, 4, 5, 16, 17, 32, 33, 64, 128, 512, 4224]


def _stated(k: int) -> tuple:
    """The order written out from its definition, not from ops."""
    return tuple(tuple(tuple(range(s, min(s + 32, c + 256, k)))
                       for s in range(c, min(c + 256, k), 32))
                 for c in range(0, k, 256))


@pytest.mark.parametrize("k", KS)
def test_every_f32_plan_states_the_one_order(k):
    """Whatever M, N, arrangement or tile a plan takes, matmul, the
    batched kernel, swiglu's gate/up (K = D) and down (K = F) launches and
    norm_matmul's product (K = D) state one order at ``k``."""
    want = _stated(k)
    assert kops.f32_k_order(k) == want
    orders, arrangements = set(), set()
    for m in ROWS:
        for n in (8, 16, 256, 4096):
            mm = kops.matmul_plan(m, k, n, F32)
            orders.add(kops.matmul_k_order(mm, k))
            arrangements.add((mm.arrangement, mm.bm, mm.bn))
            bm = kops.batched_matmul_plan(3, m, n, k, F32)
            orders.add(kops.batched_matmul_k_order(bm, k))
            nm = kops.norm_matmul_plan(m, k, n, F32)
            orders.add(kops.matmul_k_order(nm.gemm, k))
            sw = kops.swiglu_plan(m, k, 4 * n, 16, F32)
            orders.add(kops.matmul_k_order(sw.gate_up, k))
            down = kops.swiglu_plan(m, 64, k + (-k) % 4, n, F32).down
            kd = k + (-k) % 4
            assert kops.matmul_k_order(down, kd) == kops.f32_k_order(kd)
            arrangements.add((sw.gate_up.arrangement, sw.bm, sw.bf))
    assert orders == {want}
    assert {a for a, _, _ in arrangements} >= {"lanes", "tile"}


@pytest.mark.parametrize("k", KS)
def test_the_order_is_every_k_once_in_sub_chains_of_32(k):
    order = kops.f32_k_order(k)
    flat = [kk for chunk in order for sub in chunk for kk in sub]
    assert flat == list(range(k))
    assert len(order) == -(-k // 256)
    for c, chunk in enumerate(order):
        assert 1 <= len(chunk) <= 8
        for s, sub in enumerate(chunk):
            # a sub-chain starts at a multiple of 32 from its chunk's start
            assert sub[0] == c * 256 + 32 * s and 1 <= len(sub) <= 32
    # up to 32 k, one chain: the order of one 256-long chain too
    if k <= 32:
        assert order == ((tuple(range(k)),),)


@pytest.mark.parametrize("m", [1, 2, 4, 5, 32, 33, 128, 512])
@pytest.mark.parametrize("d,f,do", [(4096, 11008, 4096), (44, 40, 16),
                                    (1000, 200, 24), (4096, 11008, 102400)])
def test_swiglu_f32_down_is_the_matmul_launch(m, d, f, do):
    plan = kops.swiglu_plan(m, d, f, do, F32)
    assert plan.down == kops.matmul_plan(m, f, do, F32)
    assert plan.gate_up.arrangement == ("lanes" if m <= 4 else "tile")


@pytest.mark.parametrize("d", [8, 40, 1000, 4096, 16384, 65536, 1 << 18])
@pytest.mark.parametrize("m", [1, 4, 64, 128])
def test_norm_matmul_f32_takes_matmuls_plan_at_every_width(m, d):
    plan = kops.norm_matmul_plan(m, d, 4096, F32)
    assert plan is not None and plan.gemm == kops.matmul_plan(m, d, 4096,
                                                              F32)
    assert kops.norm_matmul_supported(m, d, 4096, F32)


# -- the order's accuracy, emulated -------------------------------------------
def _fma_chain(a, b, ks_, acc):
    """acc += a[:, k] * b[k, :] for k in ks_, in order, each product exact
    (f32 x f32 fits f64) and each sum rounded to f32 once: fmaf."""
    for k in ks_:
        acc = (acc.astype(np.float64)
               + a[:, k, None].astype(np.float64) * b[None, k, :]
               ).astype(np.float32)
    return acc


def _emulate(a, b, order):
    """(M, K) @ (K, N) summed in a three-level ``order`` in f32."""
    shape = (a.shape[0], b.shape[1])
    tot = np.zeros(shape, np.float32)
    for chunk in order:
        cs = np.zeros(shape, np.float32)
        for sub in chunk:
            cs = cs + _fma_chain(a, b, sub, np.zeros(shape, np.float32))
        tot = tot + cs
    return tot


def _one_chain_per_chunk(k):
    """The order before sub-chains: each chunk of 256 one chain."""
    return tuple((tuple(range(c, min(c + 256, k))),)
                 for c in range(0, k, 256))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [48, 256])
def test_sub_chains_are_more_accurate_than_one_chain(k, seed):
    """Against the f64 product, the worst error over 64 x 64 outputs of
    seeded normal operands is smaller in the order than in one chain of
    all k (K <= 256), the order this one replaced."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((64, k)).astype(np.float32)
    b = (rng.standard_normal((k, 64)) * k ** -0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    new = np.abs(_emulate(a, b, kops.f32_k_order(k)) - exact).max() / scale
    old = np.abs(_emulate(a, b, _one_chain_per_chunk(k)) - exact).max() \
        / scale
    assert new < old, (new, old)


def test_up_to_32_k_the_order_gives_one_chains_bits():
    """A sum over at most 32 k is one sub-chain: the same bits as one
    chain (so the f32 digests of such sums do not move with the order)."""
    rng = np.random.default_rng(3)
    for k in (1, 4, 31, 32):
        a = rng.standard_normal((8, k)).astype(np.float32)
        b = rng.standard_normal((k, 8)).astype(np.float32)
        assert np.array_equal(_emulate(a, b, kops.f32_k_order(k)),
                              _emulate(a, b, _one_chain_per_chunk(k)))


# -- the check-only accessors and the bits script --------------------------------
def test_check_only_accessors_refuse_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        ks.swiglu_with_hidden(x, torch.zeros(8, 8), torch.zeros(8, 8),
                              torch.zeros(8, 4))
    with pytest.raises(ValueError):
        kn.norm_matmul_with_rows(x, torch.ones(8), torch.zeros(8, 4))


def _bits_doc(digests, meta):
    return {"digests": digests, "meta": meta, "ms": {}}


@pytest.mark.parametrize("case,allow,rc", [
    ("f32 long moved", 32, 0),
    ("f32 long moved", None, 1),
    ("f32 short moved", 32, 1),
    ("bf16 moved", 32, 1),
    ("missing", 32, 1),
    ("none moved", None, 0),
])
def test_bits_compare_lets_only_long_f32_digests_move(tmp_path, case, allow,
                                                      rc):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import torch_bmm_bits as bits
    finally:
        sys.path.pop(0)
    meta = {"f32 K4096": ["f32", 4096], "f32 K32": ["f32", 32],
            "bf16 K4096": ["bf16", 4096]}
    a = {"f32 K4096": "a", "f32 K32": "b", "bf16 K4096": "c"}
    b = dict(a)
    if case == "f32 long moved":
        b["f32 K4096"] = "x"
    elif case == "f32 short moved":
        b["f32 K4096"], b["f32 K32"] = "x", "y"
    elif case == "bf16 moved":
        b["f32 K4096"], b["bf16 K4096"] = "x", "z"
    elif case == "missing":
        del b["bf16 K4096"]
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(_bits_doc(a, meta)))
    pb.write_text(json.dumps(_bits_doc(b, meta)))
    assert bits.compare(str(pa), str(pb), f32_may_move=allow) == rc
