"""The f32 route of the port's flash attention (``csrc/flash_attention.cu``,
``flash_f32_kernel``), emulated in numpy f32 block by block and warp by
warp as ``ops.flash_plan`` launches it, in the order
``ops.flash_f32_order`` states: the emulation agrees with the plain
version and with the JAX Pallas kernel (interpret mode) within 1e-4 of
scale (the repo's f32 tolerance), and within it a row's bits depend on
nothing but Dk, Dv, Skv and the mask -- decode at position p equals row p
of the causal prefill, a packed GQA decode equals its heads over repeated
K and V, the rows a warp owns do not matter, and a tile the mask hides
from a row is an exact no-op for it, run or skipped.

fmaf is emulated through float64 (the product of two f32 values is exact
there; the sum is rounded twice, which departs from one rounding only
where the f64 sum falls on an f32 midpoint), and the card's ex2.approx by
numpy's exp2 in f32: the emulation states the order, it does not predict
the card's bits.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jk  # noqa: E402

from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

NEG = np.float32(-1e30)
LOG2E = np.float32(1.44269504088896341)


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def emulate(q, k, v, *, causal=True, window=None, q_offset=0,
            warp_rows=None, skip=True):
    """The kernel's arithmetic on f32 arrays (B, H, S, D).  ``warp_rows``
    overrides the plan's rows a warp; ``skip=False`` runs every tile and
    half of the cache for every warp instead of skipping those the mask
    hides."""
    B, Hq, Sq, Dk = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    plan = kops.flash_plan(q.shape, k.shape, v.shape, torch.float32)
    order = kops.flash_f32_order(Dk, Skv)
    R = warp_rows or plan.warp_rows
    BQ = kops.FLASH_WARPS * R
    half = kops.FLASH_BK // 2
    packed, rep = Sq == 1, Hq // Hkv
    nrows, heads = (rep, Hkv) if packed else (Sq, Hq)
    scale2 = np.float32(np.float32(Dk ** -0.5) * LOG2E)
    off = int(q_offset or 0)
    lanes = np.arange(kops.FLASH_F32_LANES)
    n_tiles = len(order.tiles)
    out = np.zeros((B, Hq, Sq, Dv), np.float32)
    for b in range(B):
        for hy in range(heads):
            hk = hy if packed else hy // rep
            # the cache's rows, zero past Skv as the copies fill them
            K = np.zeros((n_tiles * kops.FLASH_BK, Dk), np.float32)
            V = np.zeros((n_tiles * kops.FLASH_BK, Dv), np.float32)
            K[:Skv], V[:Skv] = k[b, hk], v[b, hk]
            for R0 in range(0, nrows, BQ):
                rows = min(BQ, nrows - R0)

                def where(r):   # (head, query) of block row r
                    return (hy * rep + R0 + r, 0) if packed else (hy, R0 + r)

                def qpos(r):
                    return off if packed else R0 + r + off
                t_end = n_tiles
                if causal:
                    last = qpos(rows - 1)
                    t_end = 0 if last < 0 else min(n_tiles, last // 64 + 1)
                t_begin = (max(0, qpos(0) - window + 1) // 64
                           if window else 0)
                if not skip:
                    t_begin, t_end = 0, n_tiles
                for w in range(kops.FLASH_WARPS):
                    nr = max(0, min(R, rows - w * R))
                    if nr == 0:
                        continue
                    rr = range(w * R, w * R + nr)
                    Q = np.zeros((R, Dk), np.float32)
                    Q[:nr] = [q[b][where(r)] for r in rr]
                    lo = np.array([max(0, qpos(r) - window + 1) if window
                                   else 0 for r in rr] + [1] * (R - nr))
                    hi = np.array([min(qpos(r), Skv - 1) if causal
                                   else Skv - 1 for r in rr] + [0] * (R - nr))
                    w_first, w_last = qpos(w * R), qpos(w * R + nr - 1)
                    m = np.full(R, NEG, np.float32)
                    l = np.zeros(R, np.float32)
                    acc = np.zeros((R, Dv), np.float32)
                    for t in range(t_begin, t_end):
                        k0 = t * kops.FLASH_BK
                        run = [not skip or (
                            k0 + h * half < Skv
                            and (not causal or k0 + h * half <= w_last)
                            and (not window
                                 or k0 + h * half + half - 1 > w_first - window))
                            for h in (0, 1)]
                        if not any(run):
                            continue
                        s = np.full((R, 2, kops.FLASH_F32_LANES), NEG,
                                    np.float32)
                        for h in (0, 1):
                            if not run[h]:
                                continue
                            keys = k0 + np.array(
                                [order.lane_keys[ln][h] for ln in lanes])
                            chains = np.zeros((R, len(keys), 4), np.float32)
                            for d in range(0, Dk, 4):
                                chains = _fma(Q[:, None, d:d + 4],
                                              K[keys][None, :, d:d + 4],
                                              chains)
                            dot = ((chains[..., 0] + chains[..., 1])
                                   + (chains[..., 2] + chains[..., 3]))
                            vis = (keys >= lo[:, None]) & (keys <= hi[:, None])
                            s[:, h] = np.where(vis, dot * scale2, NEG)
                        mn = np.maximum(m, s.max(axis=(1, 2)))
                        ms = np.where(mn <= NEG * np.float32(0.5),
                                      np.float32(0), mn)
                        with np.errstate(over="ignore", under="ignore"):
                            al = np.where(m == mn, np.float32(1),
                                          np.exp2(m - mn))
                            p = np.exp2(s - ms[:, None, None])
                        tree = p[:, 0] + p[:, 1]
                        for dist in order.tree:
                            tree = tree + tree[:, lanes ^ dist]
                        l = al * l + tree[:, 0]
                        m = mn
                        acc = acc * al[:, None]
                        for j in order.pv_keys:
                            h, ln = divmod(j, half)
                            if run[h]:
                                acc = _fma(p[:, h, ln][:, None],
                                           V[k0 + j][None, :], acc)
                    for i, r in enumerate(rr):
                        out[b][where(r)] = acc[i] / (l[i] if l[i] else 1)
    return out


def _qkv(B, Hq, Hkv, Sq, Skv, Dk, Dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Sq, Dk), (B, Hkv, Skv, Dk), (B, Hkv, Skv, Dv))]


def _close(a, b, tol=1e-4):
    scale = max(float(np.abs(b).max()), 1.0)
    diff = float(np.abs(a.astype(np.float64) - b).max())
    assert diff <= tol * scale, f"max diff {diff} > {tol * scale}"


def test_the_stated_order_covers_each_term_once():
    o = kops.flash_f32_order(136, 300)
    assert sorted(d for c in o.score_chains for d in c) == list(range(136))
    assert all(list(c) == sorted(c) and {d % 4 for d in c} == {i}
               for i, c in enumerate(o.score_chains))
    assert o.tiles == ((0, 64), (64, 128), (128, 192), (192, 256),
                       (256, 300))
    assert sorted(x for pair in o.lane_keys for x in pair) == list(range(64))
    assert o.pv_keys == tuple(range(64))
    # the butterfly reaches every lane: 32 lanes, distances 16 to 1
    reach = {0}
    for dist in o.tree:
        reach |= {x ^ dist for x in reach}
    assert reach == set(range(32))
    assert kops.flash_f32_order(64, 64) == kops.flash_f32_order(64, 64)


# B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, offset
CASES = [
    (1, 2, 2, 128, 128, 128, 128, True, None, None),     # Pallas: prefill
    (2, 4, 2, 1, 256, 128, 128, True, None, 255),        # Pallas: GQA decode
    (1, 2, 1, 40, 100, 64, 32, True, None, 60),          # ragged, Dv != Dk
    (1, 3, 3, 20, 130, 16, 16, True, 48, 110),           # window
    (2, 2, 2, 7, 70, 24, 40, False, None, None),         # no mask
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulation_matches_plain_and_pallas(case):
    B, Hq, Hkv, Sq, Skv, Dk, Dv, causal, window, off = case
    q, k, v = _qkv(*case[:7], seed=sum(case[:7]))
    got = emulate(q, k, v, causal=causal, window=window, q_offset=off)
    plain = ref.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=off).numpy()
    _close(got, plain)
    if jk.attention_supported(q.shape, k.shape) and Dv == Dk:
        jout = jk.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window,
            q_offset=None if off is None else jnp.int32(off), interpret=True)
        _close(got, np.asarray(jout))


@pytest.mark.parametrize("window", [None, 24])
def test_decode_at_p_is_row_p_of_the_prefill(window):
    """Decode (Sq 1, a block of packed heads) at p gives row p of the
    causal prefill (blocks of query rows) bit for bit, on both sides of
    a tile's and a half's edge and of the window's."""
    S = 130
    q, k, v = _qkv(1, 4, 2, S, S, 16, 24, seed=5)
    full = emulate(q, k, v, window=window)
    for p in (0, 31, 32, 63, 64, 100, 129):
        one = emulate(q[:, :, p:p + 1], k, v, window=window, q_offset=p)
        assert np.array_equal(one, full[:, :, p:p + 1]), p


def test_masked_tiles_and_halves_are_exact_noops():
    """Running every tile and half for every warp gives the bits of
    skipping those the mask hides; rows that see no key are exactly 0."""
    q, k, v = _qkv(1, 2, 2, 70, 200, 16, 16, seed=9)
    for kw in (dict(q_offset=100), dict(window=20, q_offset=120),
               dict(causal=False)):
        a = emulate(q, k, v, **kw)
        b = emulate(q, k, v, skip=False, **kw)
        assert np.array_equal(a, b), kw
    dead = emulate(q, k, v, window=1, q_offset=4096)
    assert not dead.any()
    part = emulate(q, k, v, q_offset=-3)
    assert not part[:, :, :3].any() and (np.abs(part[:, :, 3:]).sum(-1) > 0).all()


def test_rows_a_warp_owns_do_not_change_the_bits():
    q, k, v = _qkv(2, 2, 1, 45, 150, 20, 12, seed=13)
    outs = [emulate(q, k, v, q_offset=105, warp_rows=r) for r in (1, 2, 4)]
    assert all(np.array_equal(outs[0], o) for o in outs[1:])


def test_packed_gqa_decode_is_its_heads_over_repeated_kv():
    q, k, v = _qkv(2, 8, 2, 1, 90, 16, 16, seed=17)
    packed = emulate(q, k, v, q_offset=80)
    rep = emulate(q, np.repeat(k, 4, axis=1), np.repeat(v, 4, axis=1),
                  q_offset=80)
    assert kops.flash_plan(q.shape, k.shape, v.shape, torch.float32).packed
    assert np.array_equal(packed, rep)


@pytest.mark.parametrize("case,rc", [("same", 0), ("f32 moved", 0),
                                     ("bf16 moved", 1), ("missing", 1)])
def test_flash_bits_compare_lets_only_f32_digests_move(tmp_path, case, rc):
    """``scripts/torch_flash_bits.py --compare``: the f32 route's digests
    may move by design, a 16-bit digest that moves or a shape missing
    from either run fails."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "scripts"))
    try:
        import torch_flash_bits as bits
    finally:
        sys.path.pop(0)
    a = {"f32 decode": "a", "decode bfloat16": "b", "decode float16": "c"}
    b = dict(a)
    if case == "f32 moved":
        b["f32 decode"] = "x"
    elif case == "bf16 moved":
        b["decode bfloat16"] = "y"
    elif case == "missing":
        del b["decode float16"]
    docs = []
    for name, digests in (("a", a), ("b", b)):
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({"digests": digests,
                                    "ms": {"f32 decode": 0.01},
                                    "sdpa_ms": {"f32 decode": 0.02}}))
        docs.append(str(path))
    assert bits.compare(*docs) == rc
