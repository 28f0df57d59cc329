"""Flash attention's 16-bit order (``ops.flash_16_order``) and its plan
(``ops.flash_plan``), on the CPU.

The order cuts a row's keys into chunks of ``ops.FLASH_CHUNK`` keys by
absolute key index, runs today's tile order inside each chunk and merges
the chunks' states in ascending order.  Both 16-bit routes follow it:
the wgmma prefill merges at the chunk boundaries inside its block, the
mma.sync route gives each chunk a block and merges the chunk states in a
combine launch.  Here a numpy f32 emulation of the order (scores summed
in the order's k16 steps, p as hi + lo in the operands' 16-bit type, the
merge's roundings as the kernel writes them) shows what the kernels rest
on: an empty chunk is an exact no-op, one chunk is the identity, decode
at p equals prefill row p across chunk boundaries, and a row that sees
one chunk gets the unchunked order's bits; and the emulation agrees
with the plain version and with the JAX package's Pallas kernel
(interpret mode) within the bf16 tolerance of 3e-2 of scale
(``scripts/check_kernel_parity.py``'s).  The plan: every 16-bit shape of
``scripts/torch_flash_bits.py`` and of phase 3 takes the route the
order's design gives it and fits one block's shared memory; and
``torch_flash_bits.py --compare`` lets only the multi-chunk shapes'
digests move.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ops as jk  # noqa: E402

from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = np.dtype(ml_dtypes.bfloat16)
C = kops.FLASH_CHUNK
BK = kops.FLASH_BK
NEG = np.float32(-1e30)
LOG2E = np.float32(1.44269504088896341)
F = np.float32


def _chunks_seen(lo, hi):
    """The order's chunks that hold a key of [lo, hi] (a row's visible
    keys), read off ``flash_16_order``'s partition."""
    return tuple(c for c, (a, b) in enumerate(
        kops.flash_16_order(1, hi + 1).chunks) if a <= hi and b > lo) \
        if hi >= lo else ()


def _flash_bits():
    spec = importlib.util.spec_from_file_location(
        "torch_flash_bits", os.path.join(ROOT, "scripts",
                                         "torch_flash_bits.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the numpy emulation -------------------------------------------------------
def _empty(rows, dv):
    return (np.full(rows, NEG, F), np.zeros(rows, F),
            np.zeros((rows, dv), F))


def _tile(state, q, k, v, k0, lo, hi, scale2, dt):
    """One 64-key tile of the order for rows q (rows, Dk) at key range
    [lo, hi] each: scores in k16 steps over d, the tile's max and sum in
    the thread-then-quad order, p.V as hi then lo a k16 step."""
    m, l, acc = state
    keys = k0 + np.arange(BK)
    kt = np.zeros((BK, k.shape[1]), F)
    vt = np.zeros((BK, v.shape[1]), F)
    n = max(0, min(BK, k.shape[0] - k0))
    kt[:n], vt[:n] = k[k0:k0 + n], v[k0:k0 + n]
    # each element's sums in a fixed order (a BLAS product's blocking
    # would depend on the row count): the k16 steps in order, each step's
    # products added in d order
    s = np.zeros((q.shape[0], BK), F)
    for d0, d1 in kops.flash_16_order(q.shape[1], k.shape[0]).score_steps:
        step = np.zeros_like(s)
        for d in range(d0, d1):
            step = (step + q[:, d, None] * kt[None, :, d]).astype(F)
        s = (s + step).astype(F)
    s = (s * scale2).astype(F)
    vis = (keys[None, :] >= lo[:, None]) & (keys[None, :] <= hi[:, None])
    s = np.where(vis, s, NEG)
    mx = s.max(1)
    mn = np.maximum(m, mx)
    ms = np.where(mn <= NEG * F(0.5), F(0), mn)
    al = np.where(m == mn, F(1), np.exp2(m - mn).astype(F))
    p = np.exp2((s - ms[:, None]).astype(F)).astype(F)
    # each of the quad's 4 threads sums its 16 keys in order, then xor 1,
    # then xor 2
    order = np.array(kops.flash_16_order(1, BK).thread_keys)
    part = np.zeros((q.shape[0], 4), F)
    for t in range(4):
        for key in order + 2 * t:
            part[:, t] = (part[:, t] + p[:, key]).astype(F)
    for w in kops.FLASH_16_TREE:
        part = (part + part[:, np.arange(4) ^ w]).astype(F)
    l = (al * l + part[:, 0]).astype(F)
    acc = (acc * al[:, None]).astype(F)
    hi_p = p.astype(dt).astype(F)
    lo_p = (p - hi_p).astype(dt).astype(F)
    for key0, half in kops.flash_16_order(1, BK).pv_steps:
        pp = hi_p if half == "hi" else lo_p
        step = np.zeros_like(acc)
        for key in range(key0, key0 + 16):
            step = (step + pp[:, key, None] * vt[None, key]).astype(F)
        acc = (acc + step).astype(F)
    return mn, l, acc


def _merge(run, chunk):
    """The order's merge of a chunk state into the running state, with
    the kernel's roundings."""
    M, L, A = run
    m, l, a = chunk
    skip, copy = l == 0, (l != 0) & (L == 0)
    mn = np.maximum(M, m)
    fa = np.where(M == mn, F(1), np.exp2((M - mn).astype(F)).astype(F))
    fb = np.where(m == mn, F(1), np.exp2((m - mn).astype(F)).astype(F))
    Lm = ((L * fa).astype(F) + (l * fb).astype(F)).astype(F)
    Am = ((A * fa[:, None]).astype(F) + (a * fb[:, None]).astype(F)) \
        .astype(F)
    M2 = np.where(skip, M, np.where(copy, m, mn))
    L2 = np.where(skip, L, np.where(copy, l, Lm))
    A2 = np.where(skip[:, None], A, np.where(copy[:, None], a, Am))
    return M2.astype(F), L2.astype(F), A2.astype(F)


def _finish(state):
    _, L, A = state
    rl = (F(1) / np.where(L == 0, F(1), L)).astype(F)
    return (A * rl[:, None]).astype(F)


def _ranges(pos, skv, causal, window):
    lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
    hi = np.minimum(pos, skv - 1) if causal else np.full_like(pos, skv - 1)
    return lo, hi


def emulate_prefill(q, k, v, pos, causal=True, window=None, chunked=True,
                    dt=BF16):
    """Rows q (rows, Dk) at positions ``pos`` as one block of the wgmma
    route walks them: the tiles the block's rows can see, a fold into the
    running state at each chunk boundary (``chunked`` False: no folds,
    the unchunked order)."""
    scale2 = F(F(1 / np.sqrt(q.shape[1])) * LOG2E)
    lo, hi = _ranges(pos, k.shape[0], causal, window)
    tiles = -(-k.shape[0] // BK)
    t_end = min(tiles, int(pos.max()) // BK + 1) if causal else tiles
    t_begin = int(max(0, int(pos.min()) - window + 1) // BK) if window \
        else 0
    run, state = _empty(len(pos), v.shape[1]), _empty(len(pos), v.shape[1])
    chunk = t_begin * BK // C
    for t in range(t_begin, t_end):
        if chunked and t * BK // C != chunk:
            run, state = _merge(run, state), _empty(len(pos), v.shape[1])
            chunk = t * BK // C
        state = _tile(state, q, k, v, t * BK, lo, hi, scale2, dt)
    return _finish(_merge(run, state) if chunked else state)


def emulate_decode(q, k, v, p, causal=True, window=None, dt=BF16):
    """One row at position p as the split mma.sync launch walks it: a
    block per chunk that holds a key the row sees (its tiles only), then
    the combine's merge in ascending chunk order."""
    scale2 = F(F(1 / np.sqrt(q.shape[1])) * LOG2E)
    pos = np.array([p])
    lo, hi = _ranges(pos, k.shape[0], causal, window)
    run = _empty(1, v.shape[1])
    for c in _chunks_seen(int(lo[0]), int(hi[0])):
        state = _empty(1, v.shape[1])
        t0 = max(c * C // BK, int(lo[0]) // BK)
        t1 = min((c + 1) * C // BK, int(hi[0]) // BK + 1)
        for t in range(t0, t1):
            state = _tile(state, q, k, v, t * BK, lo, hi, scale2, dt)
        run = _merge(run, state)
    return _finish(run)


def _inputs(skv, dk=64, dv=64, rows=None, seed=0, dt=BF16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(rows or skv, dk)).astype(F).astype(dt).astype(F)
    k = rng.normal(size=(skv, dk)).astype(F).astype(dt).astype(F)
    v = rng.normal(size=(skv, dv)).astype(F).astype(dt).astype(F)
    return q, k, v


# -- the order -----------------------------------------------------------------
def test_chunk_partition_is_by_absolute_key_index():
    """Chunks are fixed runs of FLASH_CHUNK keys from key 0, a multiple
    of the 64-key tile, whatever the row, the shape or the grid: a row
    sees chunks lo // C .. hi // C, and a tile lies in one chunk."""
    assert C % BK == 0 and C == 512
    o = kops.flash_16_order(128, 4224)
    assert o.chunks[0] == (0, C) and o.chunks[-1] == (8 * C, 4224)
    assert all(b - a == C for a, b in o.chunks[:-1])
    for t0, t1 in o.tiles:
        assert t0 // C == (t1 - 1) // C
    assert kops.flash_16_order(128, 100).chunks == ((0, 100),)
    # the same chunk boundaries for any Skv, Dk, or the rows around
    for skv in (513, 1100, 4224):
        assert kops.flash_16_order(64, skv).chunks[:2] == ((0, C),
                                                          (C, min(2 * C,
                                                                  skv)))
    assert _chunks_seen(0, C - 1) == (0,)
    assert _chunks_seen(C - 1, C) == (0, 1)
    assert _chunks_seen(128, 4223) == tuple(range(9))
    assert _chunks_seen(5, 4) == ()
    o = kops.flash_16_order(40, 64)
    assert o.score_steps == ((0, 16), (16, 32), (32, 40))
    assert o.pv_steps[:2] == ((0, "hi"), (0, "lo")) and len(o.pv_steps) == 8
    assert sorted(o.thread_keys) == [8 * n + x for n in range(8)
                                     for x in range(2)]


def test_merge_empty_chunk_is_a_no_op_and_one_chunk_the_identity():
    q, k, v = _inputs(3 * C, rows=4, seed=1)
    pos = np.array([C + 3, C + 70, 2 * C - 1, 2 * C + 11])
    scale2 = F(F(1 / 8.0) * LOG2E)
    lo, hi = _ranges(pos, k.shape[0], True, None)
    state = _empty(4, 64)
    for t in range(0, 2):
        state = _tile(state, q, k, v, t * BK, lo, hi, scale2, BF16)
    empty = _empty(4, 64)
    # into the empty state: a copy, bit for bit
    for a, b in zip(_merge(empty, state), state):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    # an empty chunk: an exact no-op
    for a, b in zip(_merge(state, empty), state):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    # a tile the mask hides from a row is a no-op for it, run or skipped
    hidden = _tile(state, q, k, v, 40 * BK, lo, np.full(4, 10), scale2,
                   BF16)
    for a, b in zip(hidden, state):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_one_chunk_rows_keep_the_unchunked_bits():
    """A row whose visible keys lie in one chunk gets the unchunked
    order's bits (the train shape's 512 keys, every decode over <= 512
    keys, a window inside one chunk); a row across chunks may not."""
    q, k, v = _inputs(C + 200, rows=C + 200, seed=2)
    pos = np.arange(C + 200)
    a = emulate_prefill(q, k, v, pos, chunked=True)
    b = emulate_prefill(q, k, v, pos, chunked=False)
    assert np.array_equal(a[:C].view(np.uint32), b[:C].view(np.uint32))
    # windowed rows inside chunk 1 alone
    w = 100
    pos2 = np.arange(C + 150, C + 200)
    a = emulate_prefill(q[pos2], k, v, pos2, window=w)
    b = emulate_prefill(q[pos2], k, v, pos2, window=w, chunked=False)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("window", [None, 700])
def test_decode_at_p_equals_prefill_row_p_across_chunk_boundaries(window):
    """Decode at p (the split launch: a block per chunk, the combine)
    gives row p of the prefill (a block of 128 rows merging at the chunk
    boundaries as it walks them) bit for bit at p = C - 1, C, 2C and the
    last row, wherever the row sits in its block."""
    L = 2 * C + 60
    q, k, v = _inputs(L, rows=L, seed=3)
    for p in (C - 1, C, 2 * C, L - 1):
        r0 = (p // 128) * 128
        pos = np.arange(r0, min(r0 + 128, L))
        pre = emulate_prefill(q[pos], k, v, pos, window=window)[p - r0]
        dec = emulate_decode(q[p:p + 1], k, v, p, window=window)[0]
        assert np.array_equal(pre.view(np.uint32), dec.view(np.uint32)), p
        # another block of rows around p: the same bits
        pos = np.arange(max(0, p - 7), p + 1)
        pre2 = emulate_prefill(q[pos], k, v, pos, window=window)[-1]
        assert np.array_equal(pre.view(np.uint32), pre2.view(np.uint32))


def test_emulated_order_agrees_with_plain_and_the_pallas_kernel():
    """The chunked order's function is attention: 128 rows at positions
    1024-1151 over 1152 keys (three chunks; the last 128 rows of a
    causal prefill as decode-with-offset rows) against the port's plain
    version and the JAX package's flash kernel in interpret mode, within
    3e-2 of scale in bf16."""
    skv, rows, off, d = 1152, 128, 1024, 128
    q, k, v = _inputs(skv, dk=d, dv=d, rows=rows, seed=4)
    pos = off + np.arange(rows)
    got = emulate_prefill(q, k, v, pos)
    t = [torch.from_numpy(x[None, None]).to(torch.bfloat16)
         for x in (q, k, v)]
    plain = ref.flash_attention_ref(*t, causal=True, q_offset=off)
    plain = plain.float().numpy()[0, 0]
    j = [jnp.asarray(x[None, None].astype(BF16)) for x in (q, k, v)]
    pallas = np.asarray(jk.flash_attention(*j, causal=True, q_offset=off,
                                           interpret=True)
                        .astype(jnp.float32))[0, 0]
    for other in (plain, pallas):
        scale = max(float(np.abs(other).max()), 1.0)
        assert float(np.abs(got.astype(BF16).astype(F) - other).max()) \
            <= 3e-2 * scale


# -- the plan ------------------------------------------------------------------
def _phase3_cases():
    """chip_smoke.py's 16-bit fa(...) cases of phase 3, as (label, q, k,
    v shapes)."""
    from repro_torch.configs import get_config
    mx, v3 = get_config("mixtral-8x22b"), get_config("deepseek-v3-671b")
    mc, rg = get_config("minicpm-2b"), get_config("recurrentgemma-9b")
    dk3 = v3.d_nope + v3.d_rope
    cases = [("decode 255", 4, 32, 32, 1, 256, 128, 128),
             ("dense prefill", 4, 32, 32, 128, 128, 128, 128),
             ("paged-dense prefill", 1, 32, 32, 100, 100, 128, 128),
             ("GQA decode", 4, 64, 8, 1, 256, 128, 128),
             ("decode 16x32", 16, 32, 32, 1, 256, 128, 128),
             ("train", 4, 32, 32, 512, 512, 128, 128),
             ("MLA prefill", 4, v3.n_heads, v3.n_heads, 64, 64, dk3,
              v3.d_v),
             ("mixtral prefill", 1, mx.n_heads, mx.n_kv_heads, 4224, 4224,
              128, 128),
             ("mixtral decode", 1, mx.n_heads, mx.n_kv_heads, 1, 4224, 128,
              128),
             ("minicpm decode", 4, mc.n_heads, mc.n_kv_heads, 1, 256,
              mc.head_dim, mc.head_dim),
             ("minicpm prefill", 4, mc.n_heads, mc.n_kv_heads, 128, 128,
              mc.head_dim, mc.head_dim)]
    for B, Sq in ((4, 128), (1, 2176)):
        cases.append((f"rg prefill {Sq}", B, rg.n_heads, rg.n_kv_heads, Sq,
                      Sq, rg.head_dim, rg.head_dim))
    for B, Skv in ((4, 144), (1, 2184)):
        cases.append((f"rg decode {Skv}", B, rg.n_heads, rg.n_kv_heads, 1,
                      Skv, rg.head_dim, rg.head_dim))
    return cases


def _route(Sq, Dk, Dv):
    wg = (Sq >= kops.FLASH_WG_MIN_SQ and (-(-Dk // 64), -(-Dv // 64))
          in kops.FLASH_WG_CLASSES)
    return "wgmma" if wg else "tensor_core"


def test_plan_routes_and_fits_every_bits16_and_phase3_shape():
    bits = _flash_bits()
    shapes = [(sh[0],) + tuple(sh[1:8]) for sh in bits.BITS16]
    shapes += [(sh[0],) + tuple(sh[1:8]) for sh in bits.TIMES16]
    shapes += _phase3_cases()
    routes = {}
    for label, B, Hq, Hkv, Sq, Skv, Dk, Dv in shapes:
        for dt in (torch.bfloat16, torch.float16):
            q, k, v = (B, Hq, Sq, Dk), (B, Hkv, Skv, Dk), (B, Hkv, Skv, Dv)
            assert kops.attention_supported(q, k, v, dt), label
            p = kops.flash_plan(q, k, v, dt)
            assert p.smem <= 232448 and p.route == _route(Sq, Dk, Dv), label
            routes[label] = p.route
            rows = Hq // Hkv if Sq == 1 else Sq
            assert p.grid[0] * p.bq >= rows > (p.grid[0] - 1) * p.bq
            if p.route == "wgmma":
                # consumers of 64 rows: 2, or 1 past width 128 (Dv 256)
                assert p.bq == 64 * p.row_frags and p.chunks == 1
                assert p.row_frags == (1 if Dv > 128 else 2)
                assert p.workspace == 0 and 1 <= p.stages <= 4
            else:
                chunks = -(-Skv // C)
                assert p.chunks == chunks
                assert p.workspace == (0 if chunks == 1 else
                                       B * Hq * Sq * chunks * (Dv * 4 + 8))
    # the long prefills take wgmma, every decode and the short prefills
    # keep mma.sync
    assert routes["train"] == routes["mixtral prefill"] == "wgmma"
    assert routes["rg prefill 2176"] == "wgmma"
    for label in ("decode 255", "mixtral decode", "rg decode 2184",
                  "dense prefill", "MLA prefill", "minicpm prefill"):
        assert routes[label] == "tensor_core", label
    # the one-slot long decodes split: 9 and 5 chunks
    mx = kops.flash_plan((1, 48, 1, 128), (1, 8, 4224, 128),
                         (1, 8, 4224, 128), torch.bfloat16)
    assert mx.chunks == 9 and mx.grid == (1, 8, 1) and mx.col_split == 1
    # rg's MQA decode: 5 chunks of one kv head, each tile's 256 columns
    # split over 4 blocks (20 blocks); 4 slots over 256 keys keep 128
    rgp = kops.flash_plan((1, 16, 1, 256), (1, 1, 2184, 256),
                          (1, 1, 2184, 256), torch.bfloat16)
    assert rgp.chunks == 5 and rgp.packed and rgp.col_split == 4
    assert kops.flash_plan((4, 32, 1, 128), (4, 32, 256, 128),
                           (4, 32, 256, 128), torch.bfloat16).col_split == 1


def test_wgmma_plan_stages_and_shared_memory():
    """The wgmma launch's shared memory: 1024 bytes of alignment slack,
    the consumers' Q boxes (two work items' with two consumers, whose
    blocks are persistent), the stages, the running accumulators where
    Skv spans chunks, the mbarriers."""
    box = kops.FLASH_WG_BOX_BYTES
    p = kops.flash_plan((4, 32, 512, 128), (4, 32, 512, 128),
                        (4, 32, 512, 128), torch.bfloat16)
    assert (p.route, p.stages, p.bq) == ("wgmma", 4, 128)
    assert p.smem == 1024 + 2 * 2 * 2 * box + 4 * 4 * box + \
        kops.FLASH_WG_BARS
    p = kops.flash_plan((1, 16, 2176, 256), (1, 1, 2176, 256),
                        (1, 1, 2176, 256), torch.bfloat16)
    spill = 128 * 128 * 4
    assert (p.stages, p.bq) == (2, 64)
    assert p.smem == 1024 + 4 * box + spill + 2 * 8 * box + \
        kops.FLASH_WG_BARS <= 232448
    # below the threshold, or a class it does not serve: mma.sync
    for q, k in (((1, 2, 255, 128), (1, 2, 255, 128)),
                 ((1, 2, 300, 256), (1, 2, 300, 256))):
        v = k[:3] + (64,)
        assert kops.flash_plan(q, k, v, torch.bfloat16).route == \
            "tensor_core"


# -- the compare -----------------------------------------------------------------
def test_compare_lets_only_multi_chunk_digests_move(tmp_path, capsys):
    bits = _flash_bits()
    multi = {sh[0] for sh in bits.BITS16 if bits.multi_chunk(sh, C)}
    assert multi == {"mixtral prefill 1x48x4224 48:8 window 4096",
                     "mixtral decode 1x48x1 at pos 4223 window 4096",
                     "rg prefill 1x16x2176 16:1 Dk 256 window 2048",
                     "rg decode 1x16x1 at pos 2183 window 2048",
                     "deepseek prefill 1x32x1100"}
    one = "train 4x32x512"
    many = "mixtral decode 1x48x1 at pos 4223 window 4096"

    def write(name, digests):
        path = tmp_path / name
        path.write_text(json.dumps({"digests": digests,
                                    "ms": {"t": 1.0}, "sdpa_ms": {"t": 2.0}}))
        return str(path)

    base = {f"{one} bfloat16": "a", f"{many} bfloat16": "b",
            "f32 decode 4x32x1 at pos 255": "c"}
    a = write("a.json", base)
    # a multi-chunk shape and an f32 digest moved: exit 0
    b = write("b.json", dict(base, **{f"{many} bfloat16": "x",
                                      "f32 decode 4x32x1 at pos 255": "y"}))
    assert bits.compare(a, b, C) == 0
    assert "1 16-bit moved by the chunked order" in capsys.readouterr().out
    # a one-chunk 16-bit shape moved: exit 1
    b = write("c.json", dict(base, **{f"{one} bfloat16": "x"}))
    assert bits.compare(a, b, C) == 1
    # a shape missing: exit 1
    b = write("d.json", {k: v for k, v in base.items() if k != f"{many} "
                                                              "bfloat16"})
    assert bits.compare(a, b, C) == 1
