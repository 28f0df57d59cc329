"""The fixed-order batched matmul (``repro_torch/kernels/batched_matmul.py``,
``csrc/batched_matmul.cu``) on the CPU: its plain version against the
reference's ``lax.dot_general``, the launch plan's K order, the predicate
against every floating contraction the seven families emit, the
emitter's routing of the paged attention, and the
``scripts/torch_prefix_shapes.py --first-diff`` tool.  The kernel itself
runs only on a card (``tests/test_torch_kernels.py``, ``cuda``).

Tolerances are the repo's: 1e-4 of scale in f32, 3e-2 in bf16.
"""
import collections
import contextlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from jax import lax  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.passes import run_pipeline  # noqa: E402
from repro_torch.devices import torch_dtype  # noqa: E402
from repro_torch.kernels import batched_matmul as kb  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import train_graph as tg  # noqa: E402
from repro_torch.transformers.torch_emit import EmitCtx, emit_callable  # noqa: E402

DTYPES = {"f32": (np.float32, torch.float32, 1e-4),
          "bf16": (np.dtype(ml_dtypes.bfloat16), torch.bfloat16, 3e-2)}
FUSE = {"swiglu": True, "norm_matmul": True, "rotary_qkv": True}


# -- the plain version against lax.dot_general --------------------------------
# (a shape, b shape, contracting, batch): batch on both sides, the
# contraction on the last and on a middle axis, transposed operands
DOTS = {
    "qk_decode": ((2, 4, 1, 1, 16), (2, 4, 40, 16), ((4,), (3,)),
                  ((0, 1), (0, 1))),
    "pv_decode": ((2, 4, 1, 1, 40), (2, 4, 40, 16), ((4,), (2,)),
                  ((0, 1), (0, 1))),
    "middle_axis": ((3, 7, 5), (3, 7, 6), ((1,), (1,)), ((0,), (0,))),
    "batch_last": ((5, 6, 3), (6, 4, 3), ((1,), (0,)), ((2,), (2,))),
    "both_transposed": ((9, 11), (13, 9), ((0,), (1,)), ((), ())),
    "no_contraction": ((3, 5), (3, 4), ((), ()), ((0,), (0,))),
    "wgrad": ((2, 16, 24), (2, 16, 8), ((0, 1), (0, 1)), ((), ())),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(DOTS))
def test_plain_matches_lax_dot_general(name, dt):
    np_dt, t_dt, tol = DTYPES[dt]
    a_shape, b_shape, contracting, batch = DOTS[name]
    rng = np.random.default_rng(0)
    a = rng.normal(size=a_shape).astype(np.float32).astype(np_dt)
    b = rng.normal(size=b_shape).astype(np.float32).astype(np_dt)
    want = np.asarray(lax.dot_general(
        jnp.asarray(a), jnp.asarray(b), (contracting, batch),
        preferred_element_type=jnp.float32).astype(np_dt), np.float64)
    ta, tb = torch.from_numpy(a.astype(np.float32)).to(t_dt), \
        torch.from_numpy(b.astype(np.float32)).to(t_dt)
    a3, b3, shape = kb.dot_operands(ta, tb, contracting, batch)
    got = kb.batched_matmul(a3, b3, t_dt).reshape(shape)
    assert got.dtype == t_dt and tuple(got.shape) == want.shape
    got = got.double().numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale


def test_dot_operands_read_a_transpose_in_place():
    """q.k^T over a (B, H, S, D) cache: B is a strided view of the cache,
    not a copy; a middle-axis contraction that no view reaches is copied,
    as einsum copies it."""
    q = torch.zeros(2, 4, 1, 1, 16)
    k = torch.zeros(2, 4, 40, 16)
    a3, b3, shape = kb.dot_operands(q, k, ((4,), (3,)), ((0, 1), (0, 1)))
    assert (tuple(a3.shape), tuple(b3.shape), shape) == \
        ((8, 1, 16), (8, 16, 40), (2, 4, 1, 1, 40))
    assert b3.data_ptr() == k.data_ptr() and b3.stride() == (640, 1, 16)
    x = torch.zeros(3, 7, 5)
    a3, _, _ = kb.dot_operands(x, torch.zeros(3, 7, 6), ((1,), (1,)),
                               ((0,), (0,)))
    assert a3.stride() == (35, 1, 5) and a3.data_ptr() == x.data_ptr()


# -- the launch plan's K order --------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("k", [1, 7, 40, 128, 257, 600, 2048, 5000, 102400])
def test_k_order_does_not_depend_on_batch_m_or_n(k, dtype):
    """Every (batch, M, N) -- one row, ragged tiles, many tiles, batches
    past the grid's 65535, and on the CUDA cores each of its tiles and
    its split kernel -- gets one K order, a permutation of 0..K-1 whose
    partial sums each run in ascending k."""
    cases = [(1, 1, 1), (1, 1, 256), (3, 5, 13), (128, 1, 40),
             (64, 1, 256), (8, 4, 1024), (64, 9, 64), (32, 64, 40),
             (2, 33, 72), (70000, 17, 9), (1, 4096, 4096)]
    orders, blocks = set(), set()
    for batch, m, n in cases:
        for a_t, b_t in ((False, False), (True, True)):
            plan = kops.batched_matmul_plan(batch, m, n, k, dtype, a_t, b_t)
            assert plan.route == ("cuda_core" if dtype == torch.float32
                                  else "tensor_core")
            assert 1 <= plan.grid[1] <= kops.BMM_BATCH_GRID
            orders.add(kops.batched_matmul_k_order(plan, k))
            blocks.add((plan.bm, plan.bn))
    assert len(orders) == 1
    if dtype == torch.float32 and k >= kops.BMM_SPLIT_MIN_K:
        assert len(blocks) == 6   # five tiles and the split kernel
    (order,) = orders
    if dtype == torch.float32:
        # chunks of 256 in order, each of sub-chains of 32 in order, each
        # ascending: every k once, in ascending order
        assert order == kops.f32_k_order(k)
        assert [kk for chunk in order for sub in chunk for kk in sub] == \
            list(range(k))
        assert all(len(chunk) <= 8 and all(len(sub) <= 32 for sub in chunk)
                   for chunk in order)
        return
    assert sorted(kk for lane in order for kk in lane) == list(range(k))
    assert all(list(lane) == sorted(lane) for lane in order)
    # matmul's: warp w takes k with k // 32 % 8 == w
    assert all(kk // kops.TC_WARP_K % 8 == w
               for w, lane in enumerate(order) for kk in lane)


def test_predicate_takes_every_float_type_and_refuses_the_rest():
    f, b, h = torch.float32, torch.bfloat16, torch.float16
    for pair in ((f, f), (b, b), (h, h), (f, b), (b, h)):
        assert kops.batched_matmul_supported(70000, 1, 3, 5, *pair)
    assert not kops.batched_matmul_supported(1, 1, 1, 1, torch.float64, f)
    assert not kops.batched_matmul_supported(1, 1, 1, 1, f, torch.int32)
    assert not kops.batched_matmul_supported(1, 0, 1, 1, f, f)


# -- the emitter ----------------------------------------------------------------
@contextlib.contextmanager
def _recorded(calls: list, refused: collections.Counter):
    """While open, every call of the wrapper records its operand shapes in
    ``calls``, and the predicate's refusals are counted in
    ``refused[False]``."""
    fn, sup = kb.batched_matmul, kb.supported

    def call(a, b, out_dtype=None):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return fn(a, b, out_dtype)

    def check(a, b):
        ok = sup(a, b)
        refused[False] += not ok
        return ok

    kb.batched_matmul, kb.supported = call, check
    try:
        yield
    finally:
        kb.batched_matmul, kb.supported = fn, sup


def _walk(fn, calls, refused):
    """``fn`` at O2 with the kernels, on the CPU (each wrapper takes its
    plain version) over zero inputs."""
    opt, _ = run_pipeline(fn, "O2", fuse=FUSE)
    run = emit_callable(opt, EmitCtx(torch.device("cpu"), use_pallas=True))
    args = [torch.zeros(p.out_types[0].shape,
                        dtype=torch_dtype(p.out_types[0].dtype))
            for p in opt.parameters]
    with _recorded(calls, refused):
        run(*args)


FAMILIES = ["deepseek-7b", "mixtral-8x22b", "deepseek-v3-671b",
            "recurrentgemma-9b", "xlstm-350m", "whisper-medium",
            "llama-3.2-vision-11b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_predicate_takes_every_contraction_of_the_seven_families(arch):
    """The O2 graphs of each family at ``.reduced()`` in bf16 -- prefill,
    decode and the train step -- run on the CPU: every
    floating contraction the emitter hands the batched kernel is taken
    (0 refused), and every family hands it some."""
    cfg = get_config(arch).reduced()
    calls, refused = [], collections.Counter()
    for kind in ("prefill", "decode"):
        _walk(lm.build_graphs(cfg, ShapeConfig(kind, kind, 24, 2), 2).fn,
              calls, refused)
    g = lm.build_graphs(cfg, ShapeConfig("train", "train", 16, 2), 2)
    _walk(tg.make_train_step(g, cfg).fn, calls, refused)
    assert not refused[False], refused
    assert calls


def _paged_calls(cfg, graph):
    calls, refused = [], collections.Counter()
    _walk(graph.fn, calls, refused)
    assert not refused[False]
    return collections.Counter(calls)


def test_paged_graphs_route_their_contractions_through_the_wrapper():
    """The paged decode chunk (2 steps, 3 slots) and a chunked prefill (16
    tokens) of reduced deepseek-7b at O2 with the kernels on the CPU:
    each layer's scores, (B * Hkv, rep * C, D) against the cache's
    strided (B * Hkv, D, Skv) view, and p.V, (B * Hkv, rep * C, Skv)
    against (B * Hkv, Skv, D), reach the wrapper once per layer and
    step; so do the page writes' one-hot products (the (B, P, ps) mask
    once, shared by k and v, and each new row's scatter into the pool),
    the sampler's pick of the chosen logit, and the reduced vocabulary's
    unembedding (257 columns: no whole 16-byte vector, which the matmul
    kernel refuses).  Nothing else does."""
    cfg = get_config("deepseek-7b").reduced()
    L, hkv, dh, V = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.vocab
    rep = cfg.n_heads // hkv
    ps, max_len, B, steps, C = 4, 40, 3, 2, 16
    skv = -(-max_len // ps) * ps
    P = 1 + B * (skv // ps)

    def attention(b, c, n):
        return {((b * hkv, rep * c, dh), (b * hkv, dh, skv)): n,
                ((b * hkv, rep * c, skv), (b * hkv, skv, dh)): n}

    got = _paged_calls(cfg, lm.build_dense_chunk(cfg, max_len, B, steps,
                                                 page_size=ps))
    assert got == collections.Counter({
        **attention(B, 1, L * steps),
        ((B, P, 1), (B, 1, ps)): L * steps,
        ((1, P * ps, B), (1, B, hkv * dh)): 2 * L * steps,
        ((B, 1, V), (B, V, 1)): steps})
    got = _paged_calls(cfg, lm.build_dense_paged_prefill(
        cfg, max_len, C, page_size=ps, n_pages=P))
    assert got == collections.Counter({
        **attention(1, C, L),
        ((C, P, 1), (C, 1, ps)): L,
        ((1, P * ps, C), (1, C, hkv * dh)): 2 * L,
        ((1, 1, cfg.d_model), (1, cfg.d_model, V)): 1})


# -- scripts/torch_prefix_shapes.py --first-diff ---------------------------------
def test_first_diff_finds_no_split_among_the_paged_legs_on_the_cpu(capsys):
    """The tool on reduced deepseek-7b in bf16 on the CPU: the three-slot
    and one-slot legs, and chunks 16 and 8, compare some floating outputs
    and find no bit that differs (CPU torch keeps one order)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    import torch_bench as tb
    import torch_prefix_shapes as ps
    tb.configure("cpu", True, None)
    out = ps.run_first_diff(tb, tb._cfg())
    tb.free()
    assert [r["diffs"] for r in out] == [[], []], out
    assert all(r["compared"] > 100 for r in out), out
    assert "no difference" in capsys.readouterr().out


@pytest.mark.parametrize("batch,m,n,k,a_t,b_t,want", [
    # decode p.V: A rows along k, B rows along n
    (128, 1, 128, 256, False, False, ("rows", "rows")),
    # the prefill's scores against the (N, K) cache, one 16-byte vector
    # of k a load
    (32, 64, 256, 128, False, True, ("rows", "columns")),
    # the backward's dW = X^T dY: A as (K, M)
    (1, 4096, 4096, 2048, True, False, ("columns", "rows")),
    # a K, an M or an N in no whole 8-element chunks: one element a load
    (3, 5, 13, 7, False, False, ("elements", "elements")),
    (2, 33, 72, 100, True, True, ("elements", "elements"))])
def test_plan_copies_each_layout_as_csrc_does(batch, m, n, k, a_t, b_t,
                                              want):
    plan = kops.batched_matmul_plan(batch, m, n, k, torch.bfloat16, a_t,
                                    b_t)
    assert (plan.a_copy, plan.b_copy) == want


# -- the plan at the main path's shapes ---------------------------------------
# (batch, M, N, K, type, A as (K, M), B as (N, K)) -> (kernel, rows,
# columns, grid, stages, k per ring stage, threads, cluster, A's copy,
# B's copy)
NAMED_PLANS = {
    # phase 4's paged write: the one-hot mask of 4 slots over 65 pages of
    # 16 rows, read as (K, M), against the slots' new rows
    "paged write": ((1, 1040, 4096, 4, torch.bfloat16, True, False),
                    ("bmm_seq_kernel", 128, 128, (9 * 32, 1), 2, 32, 256, 1,
                     "columns", "rows")),
    # phase 8's backward: dX against a transposed weight, dW from a
    # transposed activation -- the wgmma mainloop, persistent blocks one
    # an SM over the 128 x 128 tiles, stages of two lanes' k-tiles
    "train dX": ((1, 2048, 4096, 4096, torch.bfloat16, False, True),
                 ("wg_gemm_kernel", 128, 128, (132, 1), 5, 64, 384, 1,
                  "rows", "columns")),
    "train dW": ((1, 4096, 11008, 2048, torch.bfloat16, True, False),
                 ("wg_gemm_kernel", 128, 128, (132, 1), 5, 64, 384, 1,
                  "columns", "rows")),
    # deepseek-v3's expert FFN at decode: 16-row tiles, stages of four
    # k-tiles
    "expert FFN up": ((256, 8, 2048, 7168, torch.bfloat16, False, False),
                      ("bmm_seq_kernel", 16, 128, (16, 256), 3, 128, 256, 1,
                       "rows", "rows")),
    # a 64-row prefill chunk's bf16 p.V: 64 x 32 tiles, 128 blocks
    "chunk p.V bf16": ((32, 64, 128, 256, torch.bfloat16, False, False),
                       ("bmm_seq_kernel", 64, 32, (4, 32), 3, 128, 256, 1,
                        "rows", "rows")),
    # bf16 decode scores: one query row against 256 keys, K = d_head
    "bf16 decode q.k^T": ((128, 1, 256, 128, torch.bfloat16, False, True),
                          ("bmm_seq_kernel", 16, 128, (2, 128), 3, 128, 256,
                           1, "rows", "columns")),
    # the paged decode's f32 attention: one row and 64 columns a block of
    # 64 threads; the cache's columns of p.V in 16-byte vectors
    "decode q.k^T": ((128, 1, 256, 128, torch.float32, False, True),
                     ("bmm_f32_kernel", 1, 64, (4, 128), 4, 32, 64, 1,
                      "elements", "elements")),
    "decode p.V": ((128, 1, 128, 256, torch.float32, False, False),
                   ("bmm_f32_kernel", 1, 64, (2, 128), 4, 32, 64, 1,
                    "elements", "vectors")),
    # phase 15's xlstm: 64 blocks of 4 x 16 outputs, not 16 of 4 x 64
    "xlstm sLSTM backward": ((4, 4, 256, 1024, torch.float32, False, False),
                             ("bmm_f32_kernel", 4, 16, (16, 4), 4, 32, 64, 1,
                              "elements", "vectors")),
    # phase 8's f32 scores over a 128-wide head (one chunk): the chunk
    # sums in shared memory, two stages
    "train scores f32": ((128, 512, 512, 128, torch.float32, False, True),
                         ("bmm_f32_kernel", 128, 128, (16, 128), 2, 16, 256,
                          1, "elements", "elements")),
    # the sampler's pick: a cluster of 8 blocks per output
    "sampler pick": ((4, 1, 1, 102400, torch.float32, False, False),
                     ("bmm_f32_split_kernel", 1, 1, (8, 4), 0, 256, 256, 8,
                      "elements", "elements")),
}


@pytest.mark.parametrize("name", sorted(NAMED_PLANS))
def test_plan_at_the_main_paths_shapes(name):
    (batch, m, n, k, dt, a_t, b_t), want = NAMED_PLANS[name]
    p = kops.batched_matmul_plan(batch, m, n, k, dt, a_t, b_t)
    assert (p.kernel, p.bm, p.bn, p.grid, p.stages, p.ring_k, p.threads,
            p.cluster, p.a_copy, p.b_copy) == want
    assert p.smem <= kops._SMEM
    if p.kernel == "bmm_seq_kernel":   # the ring holds 32-deep k-tiles
        assert p.ring_k % 32 == 0
        assert p.k_stage == kops.TC_KS and p.lanes == 8 and p.lane_k == 32
    if p.kernel == "wg_gemm_kernel":   # two lanes' k-tiles a stage
        assert p.ring_k == 2 * p.lane_k == kops.WG_STAGE_K
        assert p.k_stage == kops.TC_KS and p.lanes == 8 and p.smem == \
            kops.WG_SMEM


def test_seq_shared_memory_follows_the_k_tiles_and_the_epilogue():
    """The lanes in sequence take the ring's stages their k-tiles fill
    and at least the staged output tile: the paged write (one k-tile)
    needs 16 KB of ring but 34 KB of bf16 tile; phase 8's dW with rows of
    A in no whole 16 bytes (copied element by element) the whole 3-stage
    ring of four k-tiles a stage.  (dW itself takes the wgmma mainloop's
    fixed ring.)"""
    plan = kops.batched_matmul_plan
    bf = torch.bfloat16
    assert plan(1, 1040, 4096, 4, bf, True, False, out_f32=False).smem == \
        128 * (128 * 2 + 16)
    assert plan(1, 1040, 4096, 4, bf, True, False).smem == \
        128 * (128 * 4 + 16)
    assert plan(1, 4100, 11008, 2048, bf, True, False).smem == \
        3 * 4 * 32 * 256 * 2
    assert plan(1, 4096, 11008, 2048, bf, True, False).smem == kops.WG_SMEM
    # K 64: two k-tiles, one stage of the 64 x 32 tile's four
    assert plan(8, 40, 256, 64, bf).smem == 4 * 32 * (64 + 32) * 2


def _plans_over(k, dtype):
    """Plans at shapes that reach every kernel and tile of ``dtype``'s
    route, at contraction ``k``."""
    shapes = [(1, 1, 1), (4, 1, 1), (128, 1, 256), (4, 4, 256), (3, 5, 13),
              (8, 16, 64), (64, 9, 64), (32, 64, 40), (2, 65, 72),
              (1, 128, 64), (2, 130, 200), (1, 2048, 4096),
              (1, 1040, 4096), (256, 8, 2048), (70000, 17, 9)]
    return [kops.batched_matmul_plan(b, m, n, k, dtype, a_t, b_t)
            for b, m, n in shapes for a_t in (False, True)
            for b_t in (False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 4, 31, 32, 200, 256, 300, 1024, 4096,
                               5000])
def test_k_order_is_the_stated_one_for_every_kernel_and_tile(k, dtype):
    """Every kernel and tile the plan gives at ``k`` sums in one order,
    the one the kernel states (``batched_matmul_k_order``): f32 chunks of
    256 in order, each of sub-chains of 32 consecutive k in order, each
    ascending; 16-bit lanes w = 0..7, lane w the k with k // 32 % 8 == w
    in ascending k, whatever the tile."""
    plans = _plans_over(k, dtype)
    if dtype == torch.float32:
        want = tuple(tuple(tuple(range(s, min(s + 32, k)))
                           for s in range(c, min(c + 256, k), 32))
                     for c in range(0, k, 256))
    else:
        want = tuple(tuple(kk for kk in range(k) if kk // 32 % 8 == w)
                     for w in range(8))
    kernels = {(p.kernel, p.bm, p.bn) for p in plans}
    for p in plans:
        assert kops.batched_matmul_k_order(p, k) == want, p
    if dtype == torch.float32:
        assert {kk for kk, _, _ in kernels} >= {"bmm_f32_kernel"}
        if k >= kops.BMM_SPLIT_MIN_K:
            assert ("bmm_f32_split_kernel", 1, 1) in kernels
    else:   # one lane on one tile, else a tile by M; above 64 rows the
        # wgmma mainloop where both operands are TMA-readable
        assert kernels == ({("bmm_seq_kernel", 128, 128)} if k <= 32 else
                           {("bmm_seq_kernel", 16, 128),
                            ("bmm_seq_kernel", 64, 32),
                            ("bmm_seq_kernel", 128, 128),
                            ("wg_gemm_kernel", 128, 128)})
