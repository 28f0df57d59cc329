"""Shape predicates of the port's Hopper kernels (the kernel-selection
surface the torch emitter consults, as the JAX emitter consults
``repro/kernels/ops.py``).

The TPU kernels needed (8, 128)-tiled shapes: rows a multiple of 8 or
128, widths of 128.  The Hopper kernels mask their ragged edges instead,
so any row count M >= 1 is taken -- decode's 4 slots, a 64-row prefill
chunk, the 1-row unembed of a prefill's last position.  What they do
need is that each weight row splits into 16-byte vectors (the output
width N a multiple of 16 / itemsize).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# shared memory one block may use on the H100 (bytes), and the most
# elements a 32-bit index may reach
_SMEM = 232448
_I32 = 2 ** 31 - 1
_THREADS = 256
_WARPS = _THREADS // 32


def vec(dtype: torch.dtype) -> int:
    """Elements in one 16-byte vector load."""
    return 16 // dtype.itemsize


def _ok_dims(*dims: int) -> bool:
    return all(1 <= int(d) <= _I32 for d in dims)


# -- matmul --------------------------------------------------------------------
def matmul_supported(m: int, k: int, n: int, dtype: torch.dtype) -> bool:
    return (dtype in KERNEL_DTYPES and _ok_dims(m, k, n, m * k, k * n, m * n)
            and n % vec(dtype) == 0)


# mirrors csrc/tc_gemm.cuh and csrc/matmul.cu: stages of 256 k, each
# warp a fixed 32-wide k slice of every stage, the warps summed in order
TC_KS = 256
TC_WARP_K = TC_KS // _WARPS
TC_EVICT_FIRST_BYTES = 256 << 20


# mirrors csrc/wg_gemm.cuh (the wgmma route of matmul, norm_matmul's
# product and swiglu's two launches above WG_MIN_ROWS rows, and the
# batched kernel's training tiles): 128 x 128 tiles (a paired B's: 64
# columns of each of two matrices, WG_BOX_MN), a
# producer and two consumer warpgroups, a ring of WG_STAGES stages of
# WG_STAGE_K k (two lanes' k-tiles of the 16-bit order), each consumer's
# 64 x 128 outputs staged for the TMA unit (f32 at most), the ring's
# mbarriers; persistent blocks, at most one an SM
WG_MIN_ROWS = 96
WG_BM = WG_BN = 128
WG_BOX_MN = 64
WG_STAGES = 5
WG_STAGE_K = 2 * TC_WARP_K
WG_THREADS = 384
WG_SMS = 132
WG_SMEM = (1024 + WG_STAGES * (WG_BM + WG_BN) * WG_STAGE_K * 2
           + 2 * 64 * WG_BN * 4 + 2 * WG_STAGES * 8)


def wg_blocks(tiles: int) -> int:
    """The wgmma route's persistent blocks for ``tiles`` output tiles."""
    return min(tiles, WG_SMS)


def wg_lanes(k: int) -> int:
    """Lanes of the 16-bit order that hold data at contraction ``k``: all
    8, but ceil(k / 32) for k under one stage (the others would add +0)."""
    return -(-k // TC_WARP_K) if k < TC_KS else _WARPS


def wg_k_walk(k: int) -> Tuple[Tuple[int, int, int], ...]:
    """The wgmma mainloop's ring stages over ``k``, in the order its
    producer copies them and its consumers multiply them
    (csrc/wg_gemm.cuh): ``(pair p, stage s, k0)`` for the lane pairs in
    order, each over the stages of the order in order.  A ring stage is k
    in [k0, k0 + WG_STAGE_K), k0 = s * TC_KS + p * WG_STAGE_K: lane 2p's
    k-tile [k0, k0 + 32) into its chain ``acc0``, then lane 2p + 1's [k0
    + 32, k0 + 64) into ``acc1``, each k-tile two k16 steps in ascending
    k; after the pair's last stage acc0 and then (for a lane that holds
    data, :func:`wg_lanes`) acc1 are added to the running sum.  k past K
    reads zeros."""
    return tuple((p, s, s * TC_KS + p * WG_STAGE_K)
                 for p in range(-(-wg_lanes(k) // 2))
                 for s in range(-(-k // TC_KS)))


class MatmulPlan(NamedTuple):
    # "tensor_core" (bf16, f16: tc_gemm.cuh), "wgmma" (bf16, f16 above
    # WG_MIN_ROWS rows: wg_gemm.cuh) or "cuda_core" (f32)
    route: str
    bm: int           # rows per block
    bn: int           # columns per block
    # (column tiles, row tiles); split and wgmma: (blocks, 1)
    grid: Tuple[int, int]
    stages: int       # ring depth (0: no ring)
    # k per stage of the K order (f32: the ring's k tile, or a chunk)
    k_stage: int
    smem: int         # dynamic shared-memory bytes per block
    b_evict_first: bool     # B's copies carry L2's evict-first policy
    # f32: "tile" (register tiles), "lanes" (chunks in parallel a block)
    # or "split" (a cluster per output); the tensor cores: "tile"; wgmma:
    # "persistent" (each block walks tiles)
    arrangement: str = "tile"
    threads: int = _THREADS   # per block
    cluster: int = 1          # blocks per cluster
    thread_tile: Tuple[int, int] = (0, 0)   # f32: outputs a thread
    lanes: int = 1    # f32: chunks a block (split: a cluster) runs at once


def tc_tile(m: int, n: int) -> Tuple[int, int, int]:
    """(rows, columns, stages) of the tensor-core block for ``m`` rows of
    output ``n`` wide (csrc/tc_gemm.cuh's ``with_matmul_tile``)."""
    if m <= 16:
        return (16, 128, 3) if n >= 8192 else (16, 32, 4)
    return (64, 32, 4) if m <= 64 else (64, 64, 3)


def tc_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """The ring of 16-bit B and A stages, or the epilogue's f32 warp
    partials that reuse it (``tc::Tile::SMEM``)."""
    ring = stages * (TC_KS * bn + bm * TC_KS) * 2
    return max(ring, _WARPS * bm * (bn + 8) * 4)


# mirrors csrc/f32_gemm.cuh (the f32 route of matmul, of swiglu's and
# norm_matmul's products, and the batched kernel's f32 order, all
# :func:`f32_k_order`): a cluster of BMM_SPLIT_CLUSTER blocks per
# output for at most F32_SPLIT_OUTPUTS outputs over K >= BMM_SPLIT_MIN_K;
# chunk lanes (F32_LANES chunks at once, or F32_LANES_MANY where K has
# more than F32_LANES chunks; 8 threads a lane, F32_LANE_COLS columns and
# 1, 2 or 4 rows a block) up to F32_LANE_ROWS rows; else a register tile
# (rows, columns, rows a thread, columns a thread, k tile, threads a
# group, stages, groups of threads on different chunks): F32_NARROW for
# N <= 8, F32_L32X32 up to 32 rows, else F32_L32X64
F32_SPLIT_OUTPUTS = 64
F32_LANE_COLS, F32_LANES, F32_LANES_MANY, F32_LANE_ROWS = 32, 16, 32, 4
F32_NARROW = (32, 8, 1, 1, 32, 256, 3, 1)
F32_L32X32 = (32, 32, 4, 4, 32, 64, 2, 8)
F32_L32X64 = (32, 64, 4, 8, 16, 64, 2, 4)


def _pow2_rows(m: int) -> int:
    """The chunk lanes' row tile: 1, 2 or 4 rows."""
    bm = 1
    while bm < m:
        bm *= 2
    return bm


def _f32_tile_plan(m: int, n: int, tile):
    """(bm, bn, grid, stages, k tile, smem, threads, thread tile, groups)
    of a register tile: each group's ring of stages (A as [m][k], rows of
    bk + 4; B as [k][n], rows of bn + 4), and, for more than one group,
    the groups' chunk sums for the owners."""
    bm, bn, tm, tn, bk, threads, stages, groups = tile
    grid = (-(-n // bn), -(-m // bm))
    stage = bm * (bk + 4) + bk * (bn + 4)
    part = groups * bm * bn if groups > 1 else 0
    smem = (groups * stages * stage + part) * 4
    return (bm, bn, grid, stages, bk, smem, threads * groups, (tm, tn),
            groups)


def _f32_mm_tile(m: int, n: int):
    if n <= F32_NARROW[1]:
        return F32_NARROW
    return F32_L32X32 if m <= 32 else F32_L32X64


def matmul_plan(m: int, k: int, n: int, dtype: torch.dtype) -> MatmulPlan:
    """How csrc/matmul.cu launches ``(m, k) @ (k, n)``: one kernel a call.
    16-bit: above WG_MIN_ROWS rows, where A's rows are whole 16-byte
    vectors for the TMA unit, the wgmma mainloop (csrc/wg_gemm.cuh), else
    the tensor-core tiles (:func:`tc_matmul_plan`).  The K order of both
    16-bit routes -- lane ``k // TC_WARP_K % 8`` of stage ``k // TC_KS``,
    stages in order, then the lanes in order -- and of the f32 route --
    :func:`f32_k_order`, the batched kernel's f32 order
    (:func:`matmul_k_order`) -- is a function of ``k`` alone; ``m`` and
    ``n`` pick only the route, arrangement and tile."""
    if dtype == torch.float32:
        if k >= BMM_SPLIT_MIN_K and m * n <= F32_SPLIT_OUTPUTS:
            return MatmulPlan("cuda_core", 1, 1,
                              (m * n * BMM_SPLIT_CLUSTER, 1), 0, BMM_CHUNK,
                              BMM_SPLIT_SMEM, False, "split", _THREADS,
                              BMM_SPLIT_CLUSTER, (0, 0),
                              BMM_SPLIT_CLUSTER * BMM_SPLIT_ROUND)
        if m <= F32_LANE_ROWS:
            bm = _pow2_rows(m)
            lanes = F32_LANES_MANY if k > F32_LANES * BMM_CHUNK else F32_LANES
            return MatmulPlan("cuda_core", bm, F32_LANE_COLS,
                              (-(-n // F32_LANE_COLS), -(-m // bm)), 0,
                              BMM_CHUNK, 0, False, "lanes",
                              lanes * F32_LANE_COLS // 4, 1, (bm, 4), lanes)
        bm, bn, grid, stages, bk, smem, threads, tt, groups = \
            _f32_tile_plan(m, n, _f32_mm_tile(m, n))
        return MatmulPlan("cuda_core", bm, bn, grid, stages, bk, smem, False,
                          "tile", threads, 1, tt, groups)
    if m > WG_MIN_ROWS and k % 8 == 0:
        tiles = -(-m // WG_BM) * -(-n // WG_BN)
        # B's copies evict first at every size (csrc/wg_gemm.cuh)
        return MatmulPlan("wgmma", WG_BM, WG_BN, (wg_blocks(tiles), 1),
                          WG_STAGES, TC_KS, WG_SMEM, True, "persistent",
                          WG_THREADS)
    return tc_matmul_plan(m, k, n, dtype)


def tc_matmul_plan(m: int, k: int, n: int, dtype: torch.dtype) -> MatmulPlan:
    """The tensor-core tiles of csrc/tc_gemm.cuh's ``with_matmul_tile`` for
    a 16-bit ``(m, k) @ (k, n)``: the launch of matmul, of norm_matmul's
    product and of swiglu's down product up to WG_MIN_ROWS rows (or where
    k is not in whole 16-byte vectors)."""
    bm, bn, stages = tc_tile(m, n)
    return MatmulPlan("tensor_core", bm, bn, (-(-n // bn), -(-m // bm)),
                      stages, TC_KS, tc_smem_bytes(bm, bn, stages),
                      k * n * dtype.itemsize <= TC_EVICT_FIRST_BYTES)


def f32_k_order(k: int) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
    """The port's one f32 order over ``k`` (csrc/f32_gemm.cuh), in three
    levels: one tuple per chunk of BMM_CHUNK k, in chunk order; in each,
    one tuple per sub-chain of F32_SUB consecutive k, in order; in each,
    its k in accumulation order.  A sub-chain is one fmaf chain from +0, a
    chunk's sub-chain sums are added in order to a chunk sum from +0, and
    the chunk sums in order to a total from +0."""
    return tuple(
        tuple(tuple(range(s, min(s + F32_SUB, c + BMM_CHUNK, k)))
              for s in range(c, min(c + BMM_CHUNK, k), F32_SUB))
        for c in range(0, k, BMM_CHUNK))


def matmul_k_order(plan: MatmulPlan, k: int) -> tuple:
    """The order in which matmul's kernel sums one output over ``k``.
    f32: :func:`f32_k_order` (chunks of sub-chains of k) -- the batched
    kernel's f32 order (:func:`batched_matmul_k_order`).  Tensor cores
    (both 16-bit routes): one tuple per partial sum, each listing its k
    in accumulation order, the partials added in tuple order to a sum
    from +0: lane w takes k in [s * TC_KS + w * TC_WARP_K, + TC_WARP_K)
    over the stages s in order.  Nothing here reads the plan's route
    (tensor_core or wgmma), tile, grid or arrangement."""
    if plan.route == "cuda_core":
        return f32_k_order(k)
    return tuple(
        tuple(kk for s in range(0, k, TC_KS)
              for kk in range(s + w * TC_WARP_K,
                              min(s + (w + 1) * TC_WARP_K, k)))
        for w in range(_WARPS))


# -- fused norm + matmul ----------------------------------------------------------
class NormMatmulPlan(NamedTuple):
    # "tensor_core" (bf16, f16), "wgmma" (bf16, f16 above WG_MIN_ROWS rows
    # where d % 8 == 0) or "cuda_core" (f32)
    route: str
    bm: int           # rows per block
    bn: int           # columns per block
    # (column tiles, row tiles); wgmma: (blocks, 1)
    grid: Tuple[int, int]
    stages: int       # ring depth (0: no ring)
    k_stage: int      # k per stage
    smem: int         # dynamic shared-memory bytes per block
    w_evict_first: bool     # W's copies carry L2's evict-first policy
    # the product: matmul's f32 launch, its tensor-core tiles, or its
    # wgmma mainloop
    gemm: Optional[MatmulPlan] = None
    # blocks of the first kernel: a warp a row, or (wgmma) a block of
    # four warps a row
    rows_grid: int = 0
    # the workspace between the two kernels: the tiles' inverse RMS (m,)
    # f32, or the normalised rows (m, d) in x's dtype (wgmma) or f32
    ws_shape: Tuple[int, ...] = ()
    ws_dtype: Optional[torch.dtype] = None


def norm_matmul_plan(m: int, d: int, n: int, dtype: torch.dtype,
                     g_dtype: Optional[torch.dtype] = None
                     ) -> NormMatmulPlan:
    """How csrc/norm_matmul.cu launches ``rmsnorm(x (m, d), g) @ w (d,
    n)``: a small kernel over the rows (``rows_grid`` blocks), then the
    product as its programmatic dependent.  16-bit, up to WG_MIN_ROWS
    rows (or where d is not in whole 16-byte vectors): the first kernel
    computes the rows' inverse RMS, and the product is matmul's
    tensor-core launch (``tc_matmul_plan``) with the norm applied to A's
    fragments and g's slice of each stage in the ring beside it
    (``g_dtype``, x's dtype when None).  16-bit above WG_MIN_ROWS rows:
    the first kernel writes the normalised rows, rounded to x's dtype, to
    an (m, d) workspace, and the product is matmul's wgmma launch on them
    (``matmul_plan``): bit for bit ``matmul(rows, w)``.  f32: the first
    kernel writes the normalised rows to an (m, d) f32 workspace, and the
    product is matmul's f32 launch on them, in the one f32 order
    (:func:`f32_k_order`).  Either way nothing grows with ``d``, and the
    K order is matmul's, a function of ``d`` alone."""
    rows = -(-m // _WARPS)
    if dtype == torch.float32:
        p = matmul_plan(m, d, n, dtype)
        return NormMatmulPlan("cuda_core", p.bm, p.bn, p.grid, p.stages,
                              p.k_stage, p.smem, False, p, rows, (m, d),
                              torch.float32)
    p = matmul_plan(m, d, n, dtype)
    if p.route == "wgmma":
        return NormMatmulPlan("wgmma", p.bm, p.bn, p.grid, p.stages,
                              p.k_stage, p.smem, p.b_evict_first, p, m,
                              (m, d), dtype)
    p = tc_matmul_plan(m, d, n, dtype)
    g_size = (g_dtype or dtype).itemsize
    return NormMatmulPlan("tensor_core", p.bm, p.bn, p.grid, p.stages,
                          p.k_stage, p.smem + p.stages * TC_KS * g_size,
                          p.b_evict_first, p, rows, (m,), torch.float32)


def norm_matmul_supported(m: int, d: int, n: int, dtype: torch.dtype) -> bool:
    return matmul_supported(m, d, n, dtype)


# -- fused swiglu -----------------------------------------------------------------
class SwigluPlan(NamedTuple):
    # "tensor_core" (bf16, f16), "wgmma" (bf16, f16 above WG_MIN_ROWS rows
    # where d % 8 == 0) or "cuda_core" (f32)
    route: str
    bm: int           # gate/up: rows per block (wgmma: per tile)
    bf: int           # gate/up: F columns per block, of each of wg and wu
    # gate/up: (row tiles, F tiles), rows fastest; wgmma: (blocks, 1)
    grid: Tuple[int, int]
    stages: int       # gate/up: ring depth (0: no ring)
    k_stage: int      # gate/up: k per stage
    smem: int         # gate/up: dynamic shared-memory bytes per block
    b_evict_first: bool     # gate/up: wg and wu carry L2's evict-first
    # the down launch on h (m, f) and wd: matmul's f32 launch, its
    # tensor-core tiles, or its wgmma mainloop
    down: MatmulPlan
    # f32 and wgmma: the gate/up's arrangement (bn = 2 * bf: [wg | wu]
    # columns)
    gate_up: Optional[MatmulPlan] = None


def swiglu_tile(m: int) -> Tuple[int, int, int]:
    """(rows, B columns, stages) of the tensor-core gate/up block: its B
    tile holds half its columns from wg and half from wu."""
    return (16, 128, 3) if m <= 16 else (64, 64, 3)


def _f32_gate_up_plan(m: int, d: int, f: int) -> MatmulPlan:
    """The f32 gate/up launch (csrc/swiglu.cu's ``with_f32_gate_up``):
    matmul's f32 arrangements but the cluster per output and the narrow
    tile, over B tiles of ``bn / 2`` columns of wg beside the same columns
    of wu, its grid (row tiles, F tiles) with the rows fastest."""
    if m <= F32_LANE_ROWS:
        bm = _pow2_rows(m)
        lanes = F32_LANES_MANY if d > F32_LANES * BMM_CHUNK else F32_LANES
        return MatmulPlan("cuda_core", bm, F32_LANE_COLS,
                          (-(-m // bm), -(-f // (F32_LANE_COLS // 2))), 0,
                          BMM_CHUNK, 0, False, "lanes",
                          lanes * F32_LANE_COLS // 4, 1, (bm, 4), lanes)
    tile = F32_L32X32 if m <= 32 else F32_L32X64
    bm, bn, _, stages, bk, smem, threads, tt, groups = \
        _f32_tile_plan(m, tile[1], tile)
    return MatmulPlan("cuda_core", bm, bn, (-(-m // bm), -(-f // (bn // 2))),
                      stages, bk, smem, False, "tile", threads, 1, tt, groups)


def swiglu_plan(m: int, d: int, f: int, do: int,
                dtype: torch.dtype) -> SwigluPlan:
    """How csrc/swiglu.cu launches ``silu(x (m, d) @ wg) * (x @ wu) @ wd
    (f, do)``: a gate/up kernel that writes h (m, f) to a workspace in
    x's dtype, then the down product as its programmatic dependent.  The
    gate/up kernel's B tiles hold ``bf`` columns of wg beside the same
    columns of wu.  16-bit up to WG_MIN_ROWS rows (or where d is not in
    whole 16-byte vectors): matmul's tensor-core mainloop, its grid
    walking the row tiles fastest, so the row tiles of one F tile share
    that tile's weight columns through L2, and the down product on the
    tensor-core tiles (``tc_matmul_plan(m, f, do)``).  16-bit above
    WG_MIN_ROWS rows: both launches on the wgmma mainloop, the gate/up's
    tile 64 F columns of each (``gate_up``, persistent blocks) and the
    down product matmul's wgmma launch (``matmul_plan(m, f, do)``).
    Either way g and u are each reduced in matmul's K order for ``d``.
    f32: ``gate_up``, f32_gemm.cuh's chunk lanes (at most 4 rows) or
    register tiles, so g and u are each summed in the one f32 order for
    ``d`` (:func:`f32_k_order`), and the down product matmul's f32 launch
    (``matmul_plan(m, f, do)``)."""
    if dtype == torch.float32:
        down = matmul_plan(m, f, do, dtype)
        gu = _f32_gate_up_plan(m, d, f)
        return SwigluPlan("cuda_core", gu.bm, gu.bn // 2, gu.grid, gu.stages,
                          gu.k_stage, gu.smem, False, down, gu)
    if m > WG_MIN_ROWS and d % 8 == 0:
        tiles = -(-m // WG_BM) * -(-f // WG_BOX_MN)
        # wg and wu evict first at every size, as matmul's B
        gu = MatmulPlan("wgmma", WG_BM, WG_BN, (wg_blocks(tiles), 1),
                        WG_STAGES, TC_KS, WG_SMEM, True, "persistent",
                        WG_THREADS)
        return SwigluPlan("wgmma", WG_BM, WG_BOX_MN, gu.grid, WG_STAGES,
                          TC_KS, WG_SMEM, True, matmul_plan(m, f, do, dtype),
                          gu)
    bm, bn, stages = swiglu_tile(m)
    bf = bn // 2
    return SwigluPlan("tensor_core", bm, bf, (-(-m // bm), -(-f // bf)),
                      stages, TC_KS, tc_smem_bytes(bm, bn, stages),
                      2 * d * f * dtype.itemsize <= TC_EVICT_FIRST_BYTES,
                      tc_matmul_plan(m, f, do, dtype))


def swiglu_supported(m: int, d: int, f: int, do: int,
                     dtype: torch.dtype) -> bool:
    """F and Do in whole 16-byte vectors (h's and out's rows, and wg's,
    wu's and wd's); D may be anything (the tensor-core mainloop reads an
    unaligned A element by element)."""
    return (dtype in KERNEL_DTYPES
            and _ok_dims(m, d, f, do, m * d, d * f, f * do, m * f, m * do)
            and f % vec(dtype) == 0 and do % vec(dtype) == 0)


# -- rmsnorm ------------------------------------------------------------------------
# mirrors csrc/rmsnorm.cu: one block per row; a thread holds 4 units of
# the row per round, a unit a 16-byte vector of x -- or, when d is no
# whole number of vectors, 4 x 16 bytes' worth of single elements -- in
# whole warps, at most 512 threads
NORM_VEC_UNITS, NORM_MAX_THREADS = 4, 512


class RMSNormPlan(NamedTuple):
    vector: bool      # units are 16-byte vectors
    units: int        # units per row
    per_thread: int   # units a thread holds per round
    threads: int      # threads per block (one block per row)
    rounds: int       # passes of threads x per_thread units over the row


def rmsnorm_plan(d: int, dtype: torch.dtype) -> RMSNormPlan:
    """How csrc/rmsnorm.cu launches rows of width ``d``: a function of
    ``d`` and the dtype alone, so the sum of squares has one order."""
    vector = d % vec(dtype) == 0
    units = d // vec(dtype) if vector else d
    per_thread = NORM_VEC_UNITS * (1 if vector else vec(dtype))
    want = -(-units // per_thread)
    threads = min(max(-(-want // 32) * 32, 32), NORM_MAX_THREADS)
    return RMSNormPlan(vector, units, per_thread, threads,
                       -(-units // (threads * per_thread)))


def rmsnorm_supported(shape: Sequence[int], dtype: torch.dtype,
                      w_dtype: torch.dtype) -> bool:
    if len(shape) < 1:
        return False
    d = int(shape[-1])
    rows = 1
    for s in shape[:-1]:
        rows *= int(s)
    return (dtype in KERNEL_DTYPES and w_dtype in KERNEL_DTYPES
            and _ok_dims(rows, d, rows * d))


# -- flash attention --------------------------------------------------------------
# mirrors csrc/flash_attention.cu: 128 threads (4 warps), a fixed KV tile
# of 64 keys, heads up to 256 wide
FLASH_BK = 64
FLASH_MAX_D = 256
FLASH_WARPS = 4
# the f32 route (CUDA cores): a warp owns 1, 2 or 4 consecutive block rows
# -- the most of FLASH_F32_WARP_ROWS that the call's rows fill and that
# leaves at least FLASH_F32_FILL blocks (one an SM of the H100's
# FLASH_SMS), else 1.  A stage is a 64-key K and V tile, each 32-key half
# a row of boxes of 32 keys x FLASH_F32_BOX floats (the TMA unit's copies,
# 128-byte swizzle), copied in FLASH_F32_GROUPS groups (K's keys 0-31, K's
# 32-63, V's 0-31, V's 32-63); as many stages as fit the SM's shared
# memory split between the blocks it will run (ceil(blocks / FLASH_SMS),
# at most 3), 1 to FLASH_F32_STAGES, at most the cache's tiles.  Before
# the ring: the mbarriers, Q, and FLASH_F32_ALIGN bytes of slack for the
# ring's alignment.
FLASH_SMS = 132
FLASH_F32_FILL = FLASH_SMS
FLASH_F32_WARP_ROWS = (4, 2)
FLASH_F32_STAGES = 4
FLASH_F32_GROUPS = 4
FLASH_F32_BARS = 128   # bytes of mbarriers (one a copy group) before Q
FLASH_F32_BOX = 32     # floats of a box row (128 bytes)
FLASH_F32_ALIGN = 1024   # the 128-byte swizzle's period
_SM_SMEM, _BLOCK_RESERVED = 233472, 1024
# the f32 order (flash_f32_order): partial dot products a score (d mod 4),
# the lanes a tile's keys lie on, the shuffle-xor distances of a row's sum
FLASH_F32_CHAINS = 4
FLASH_F32_LANES = 32
FLASH_F32_TREE = (16, 8, 4, 2, 1)
# the 16-bit order (flash_16_order): chunks of FLASH_CHUNK keys by
# absolute key index, merged in ascending order; a tile's row sum is the
# thread's 16 values, then the quad's shuffle-xor adds at FLASH_16_TREE
FLASH_CHUNK = 512
FLASH_16_TREE = (1, 2)
# the 16-bit routes: their codes in the C entry point
FLASH_ROUTES = {"tensor_core": 0, "wgmma": 1}
# the wgmma route (prefills of FLASH_WG_MIN_SQ rows and more): a producer
# warpgroup and 1-2 consumer warpgroups of 64 query rows; the head-width
# classes it serves as (boxes of 64 across Dk, across Dv) -> consumers
FLASH_WG_MIN_SQ = 256
FLASH_WG_CLASSES = {(1, 1): 2, (2, 1): 2, (2, 2): 2, (3, 2): 2, (4, 4): 1}
FLASH_WG_BOX = 64                  # elements of a box row (128 bytes)
FLASH_WG_BOX_BYTES = 64 * 128      # a box: 64 rows of 128 bytes
FLASH_WG_MAX_STAGES = 4
FLASH_WG_BARS = 8 * (4 + 2 * FLASH_WG_MAX_STAGES)


class FlashPlan(NamedTuple):
    route: str        # "tensor_core" (bf16, f16: mma.sync), "wgmma"
    # (bf16, f16 prefills of FLASH_WG_MIN_SQ rows and more) or "cuda_core"
    # (f32)
    bq: int           # query rows per block
    row_frags: int    # 16-row mma fragments per block (0: f32; wgmma:
    # 64-row consumer warpgroups)
    col_groups: int   # warps that split one fragment's output columns
    # (f32: 1, every warp computes all of its rows' columns)
    width: int        # head-width class sizing the registers (f32: the
    # output columns a warp holds per row, 128 or 256)
    grid: Tuple[int, int, int]   # (row tiles, heads, batch); the
    # tensor_core launch's x holds row tiles x ``chunks`` blocks
    stages: int       # K/V tiles in the cp.async ring
    smem: int         # dynamic shared-memory bytes per block
    packed: bool      # decode: the rows are the query heads of a kv head
    warp_rows: int = 0       # f32: block rows a warp owns
    copy_groups: int = 1     # cp.async groups a stage (f32: K, V halves)
    chunks: int = 1          # tensor_core: the chunks a row tile splits
    # into (a block each), merged by the combine launch where more than 1
    workspace: int = 0       # bytes of the chunk states (tensor_core)
    col_split: int = 1       # tensor_core, one fragment: blocks that split
    # a tile's output columns (a launch of few blocks)


def _round16(d: int) -> int:
    return -(-int(d) // 16) * 16


def flash_f32_boxes(d: int) -> int:
    """Boxes of FLASH_F32_BOX floats across a head width on the f32 route
    (columns past ``d`` land as zeros)."""
    return -(-int(d) // FLASH_F32_BOX)


def _flash_f32_plan(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, Dk: int,
                    Dv: int) -> FlashPlan:
    packed = Sq == 1
    nrows, heads = (Hq // Hkv, Hkv) if packed else (Sq, Hq)

    def blocks(r):
        return -(-nrows // (FLASH_WARPS * r)) * heads * B

    r = next((c for c in FLASH_F32_WARP_ROWS
              if FLASH_WARPS * c <= nrows and blocks(c) >= FLASH_F32_FILL),
             1)
    bq = FLASH_WARPS * r
    head = FLASH_F32_BARS + bq * Dk * 4 + FLASH_F32_ALIGN
    stage = (FLASH_BK * (flash_f32_boxes(Dk) + flash_f32_boxes(Dv))
             * FLASH_F32_BOX * 4)
    per_sm = min(3, max(1, -(-blocks(r) // FLASH_SMS)))
    budget = _SM_SMEM // per_sm - _BLOCK_RESERVED - head
    ns = max(1, min(FLASH_F32_STAGES, budget // stage))
    ns = min(ns, -(-Skv // FLASH_BK))
    while ns > 1 and head + ns * stage > _SMEM:
        ns -= 1
    return FlashPlan("cuda_core", bq, 0, 1, 128 if Dv <= 128 else 256,
                     (-(-nrows // bq), heads, B), ns, head + ns * stage,
                     packed, r, FLASH_F32_GROUPS)


def flash_plan(q_shape: Sequence[int], k_shape: Sequence[int],
               v_shape: Sequence[int], dtype: torch.dtype) -> FlashPlan:
    """How csrc/flash_attention.cu launches BHSD operands of these shapes.
    At decode (Sq 1) a block's rows are the query heads that share a kv
    head (``packed``), so K and V are read once for all of them.
    bf16/f16, both routes in the order :func:`flash_16_order` states:
    from FLASH_WG_MIN_SQ query rows up, where the head widths fall in
    FLASH_WG_CLASSES, the wgmma route (``row_frags`` consumer warpgroups
    of 64 rows, a TMA ring of 64-key K/V stages, the chunks merged inside
    the block); else mma.sync: 4 warps of 16 query rows (2 row fragments
    and 2 column halves past width 128), or -- for at most 16 rows --
    one fragment whose output columns the 4 warps split, a block per
    chunk of FLASH_CHUNK keys (``chunks``; their states go to a
    ``workspace`` and a combine launch merges them where more than one).
    A ring of up to 4 64-key K/V stages (3 past width 128, and for one
    fragment at width 128), all in flight at once, never more than the
    cache has tiles.  f32: the CUDA cores, 4 warps of ``warp_rows`` rows
    (1, 2 or 4: as many as still fill the card), lanes over a tile's keys
    for the scores and over the output columns for p.V, in the order
    :func:`flash_f32_order` states; a ring of 1-4 stages, each in
    ``copy_groups`` copy groups waited for one at a time."""
    B, Hq, Sq, Dk = (int(d) for d in q_shape)
    Hkv, Skv, Dv = int(k_shape[1]), int(k_shape[2]), int(v_shape[3])
    tiles = -(-Skv // FLASH_BK)
    if dtype == torch.float32:
        return _flash_f32_plan(B, Hq, Hkv, Sq, Skv, Dk, Dv)
    nbk, nbv = -(-Dk // FLASH_WG_BOX), -(-Dv // FLASH_WG_BOX)
    if Sq >= FLASH_WG_MIN_SQ and (nbk, nbv) in FLASH_WG_CLASSES:
        return _flash_wg_plan(B, Hq, Sq, Skv, nbk, nbv)
    dkp, dvp = _round16(Dk), _round16(Dv)
    w = max(dkp, dvp)
    width = 64 if w <= 64 else (128 if w <= 128 else 256)
    frags, stages = (2, 3) if width == 256 else (4, 4)
    packed = Sq == 1
    nrows = Hq // Hkv if packed else Sq
    if nrows <= 16:   # one fragment; two such blocks share an SM at 128
        frags, stages = 1, (3 if width >= 128 else 4)
    bq = 16 * frags
    ns = min(stages, tiles)
    smem = (bq * (dkp + 8) + ns * FLASH_BK * (dkp + 8 + dvp + 8)) * 2
    if frags == 1:   # the fragment's scores, exchanged between the warps
        smem += 16 * FLASH_BK * 4
    chunks = -(-Skv // FLASH_CHUNK)
    work = B * Hq * Sq * chunks * (Dv * 4 + 8) if chunks > 1 else 0
    heads = Hkv if packed else Hq
    split = 1
    if frags == 1:   # few blocks: 2 or 4 split each tile's columns
        blocks = heads * B * chunks
        split = (4 if width >= 256 and 4 * blocks <= FLASH_SMS else
                 2 if width >= 128 and 2 * blocks <= FLASH_SMS else 1)
    return FlashPlan("tensor_core", bq, frags, FLASH_WARPS // frags, width,
                     (-(-nrows // bq), heads, B), ns, smem, packed,
                     chunks=chunks, workspace=work, col_split=split)


def _flash_wg_plan(B: int, Hq: int, Sq: int, Skv: int, nbk: int,
                   nbv: int) -> FlashPlan:
    """The wgmma route's launch (csrc/flash_attention.cu:launch_wg): Q
    tiles, then as many K/V stages as fit beside them and -- where Skv
    spans more than one chunk -- the running accumulators."""
    nc = FLASH_WG_CLASSES[(nbk, nbv)]
    box = FLASH_WG_BOX_BYTES
    stage = (nbk + nbv) * box
    spill = nc * 128 * 32 * nbv * 4 if Skv > FLASH_CHUNK else 0
    qbuf = 2 if nc > 1 else 1   # persistent blocks: the next item's Q too
    head = 1024 + qbuf * nc * nbk * box + spill + FLASH_WG_BARS
    ns = max(1, min(FLASH_WG_MAX_STAGES, -(-Skv // FLASH_BK),
                    (_SMEM - head) // stage))
    bq = 64 * nc
    return FlashPlan("wgmma", bq, nc, 1, FLASH_WG_BOX * nbv,
                     (-(-Sq // bq), Hq, B), ns, head + ns * stage, False)


class FlashF32Order(NamedTuple):
    score_chains: Tuple[Tuple[int, ...], ...]   # each chain's d, in order
    tiles: Tuple[Tuple[int, int], ...]   # [first, end) keys of each tile
    lane_keys: Tuple[Tuple[int, int], ...]   # a lane's two keys in a tile
    tree: Tuple[int, ...]   # shuffle-xor distances of a row's sum, in order
    pv_keys: Tuple[int, ...]   # a tile's keys in p.V's fmaf order


def flash_f32_order(dk: int, skv: int) -> FlashF32Order:
    """The f32 route's reduction order for one query row, a function of
    Dk and Skv (and the mask, which only zeroes terms), never of B, Sq,
    the query tile, the row's place in it, GQA packing, the grid or the
    run.  Per row, with s in log2 units:

    - score of key j: one fmaf chain from +0 per tuple of
      ``score_chains`` (d = c mod 4, ascending), added as (c0 + c1) + (c2
      + c3), then times scale * log2(e) (masked: -1e30);
    - per tile in ``tiles`` order: mx = the tile's max; mn = max(m, mx);
      alpha = 1 where mn == m, else 2^(m - mn); p = 2^(s - ms) (ms = mn,
      or 0 while the row has seen no key); the tile's sum is each lane's
      p(a) + p(b) (``lane_keys``), then at each distance of ``tree`` in
      order the lane's sum plus its partner's; l = alpha * l + sum (a
      product, then an add); acc = acc * alpha, then fmaf(p_j, v_j, acc)
      for the keys of ``pv_keys`` in order;
    - out = acc / l (0 where l is 0).

    A tile, or a half of one, that the mask hides from the row is an
    exact no-op for it (alpha 1, p 0), whether it runs or is skipped."""
    half = FLASH_BK // 2
    return FlashF32Order(
        tuple(tuple(range(c, int(dk), FLASH_F32_CHAINS))
              for c in range(FLASH_F32_CHAINS)),
        tuple((t, min(t + FLASH_BK, int(skv)))
              for t in range(0, int(skv), FLASH_BK)),
        tuple((ln, ln + half) for ln in range(FLASH_F32_LANES)),
        FLASH_F32_TREE, tuple(range(FLASH_BK)))


class Flash16Order(NamedTuple):
    score_steps: Tuple[Tuple[int, int], ...]   # [first, end) d of each
    # k16 step of a score, in order
    chunks: Tuple[Tuple[int, int], ...]   # [first, end) keys of each chunk
    tiles: Tuple[Tuple[int, int], ...]    # [first, end) keys of each tile
    thread_keys: Tuple[int, ...]   # a thread's keys in a tile, in its sum's
    # order (the thread whose first key is 0; others add 2 q)
    tree: Tuple[int, ...]   # shuffle-xor distances of a row's sum, in order
    pv_steps: Tuple[Tuple[int, str], ...]   # (first key, "hi" or "lo") of
    # each k16 step of p.V over a tile, in order


def flash_16_order(dk: int, skv: int) -> Flash16Order:
    """The 16-bit routes' reduction order for one query row, a function
    of Dk and Skv (and the mask, which only zeroes terms), never of B,
    Sq, the query tile, the row's place in it, GQA packing, the route,
    the grid or the run.  Per row, with s in log2 units:

    - score of key j: mma k16 steps over d (``score_steps``, from +0; a
      route may add steps over zero columns past Dk, which add +0 to a
      sum that is never -0), times scale * log2(e) (masked: -1e30);
    - per chunk in ``chunks`` order, from the empty state (m -1e30, l 0,
      acc 0), per tile of the chunk in ``tiles`` order: mx = the tile's
      max; mn = max(m, mx); alpha = 1 where mn == m, else 2^(m - mn); p =
      2^(s - ms) (ms = mn, or 0 while the chunk has seen no key); the
      tile's sum over ``thread_keys`` in order, then at each distance of
      ``tree`` the sum plus its partner's; l = alpha * l + sum; acc = acc
      * alpha, then p.V's k16 steps in ``pv_steps`` order, each with p as
      hi = T(p) or lo = T(p - hi);
    - the chunk's (m, l, acc) merges into the running (M, L, A) in chunk
      order: a chunk with l 0 is a no-op; into L 0 it is a copy; else mn
      = max(M, m), fa = 2^(M - mn), fb = 2^(m - mn) (1 where the max is
      theirs), L = L fa + l fb, A = A fa + acc fb (each product rounded,
      then the sum);
    - out = A * (1 / L) (0 where L is 0).

    A tile or a chunk that the mask hides from the row is an exact no-op
    for it, whether it runs or is skipped; a row whose visible keys lie in
    one chunk gets the unchunked order's bits."""
    return Flash16Order(
        tuple((d, min(d + 16, int(dk))) for d in range(0, int(dk), 16)),
        tuple((c, min(c + FLASH_CHUNK, int(skv)))
              for c in range(0, int(skv), FLASH_CHUNK)),
        tuple((t, min(t + FLASH_BK, int(skv)))
              for t in range(0, int(skv), FLASH_BK)),
        tuple(8 * n + x for n in range(8) for x in range(2)),
        FLASH_16_TREE,
        tuple((k, h) for k in range(0, FLASH_BK, 16) for h in ("hi", "lo")))


def attention_supported(q_shape: Sequence[int], k_shape: Sequence[int],
                        v_shape: Sequence[int], dtype: torch.dtype) -> bool:
    """What the Hopper flash kernel can read: 4-D BHSD operands of one
    dtype, Hq a multiple of Hkv, head widths in whole 16-byte vectors up
    to 256, its tiles within one block's shared memory, and every
    operand within 32-bit indexing.  None of the TPU's 128-lane or
    Sq/Skv tiling rules: the kernel masks ragged edges itself."""
    if len(q_shape) != 4 or len(k_shape) != 4 or len(v_shape) != 4:
        return False
    B, Hq, Sq, Dk = (int(d) for d in q_shape)
    B2, Hkv, Skv, Dk2 = (int(d) for d in k_shape)
    B3, Hkv2, Skv2, Dv = (int(d) for d in v_shape)
    if dtype not in KERNEL_DTYPES or (B, Dk, Hkv, Skv) != (B2, Dk2, Hkv2,
                                                          Skv2) or B != B3:
        return False
    if not _ok_dims(B, Hq, Sq, Dk, Hkv, Skv, Dv) or Hq % Hkv:
        return False
    v_ = vec(dtype)
    if Dk % v_ or Dv % v_ or Dk > FLASH_MAX_D or Dv > FLASH_MAX_D:
        return False
    return (_ok_dims(B * Hq * Sq * Dk, B * Hkv * Skv * Dk,
                     B * Hkv * Skv * Dv, B * Hq * Sq * Dv)
            and flash_plan(q_shape, k_shape, v_shape, dtype).smem <= _SMEM)


# -- batched matmul -----------------------------------------------------------------
# mirrors csrc/batched_matmul.cu.  f32: the one f32 order (f32_k_order:
# chunks of 256 k, each in sub-chains of 32); register tiles sized by M
# and N (BMM_F32_TILES) with k tiles through a cp.async ring, and a
# cluster of BMM_SPLIT_CLUSTER blocks per output (the chunks in parallel,
# block 0 adding their sums in order) for at most 8192 outputs over K >=
# 2048.  bf16/f16: matmul's K order (tc_gemm.cuh), its lanes run in
# sequence in every warp over 32-deep k-tiles (BMM_SEQ_TILES), in a grid of
# (output tiles, batch blocks) whose blocks walk the batches past 65535;
# the training tiles (the last entry) take the wgmma mainloop where both
# operands are TMA-readable (:func:`bmm_wgmma`): two lanes a ring stage,
# persistent blocks over every batch's tiles.
BMM_CHUNK = 256
F32_SUB = 32   # k a sub-chain of the f32 order
# (most rows, (rows, columns, k tile, threads, stages)) in order; the
# last only where N > 64 too (else the one before it), and then at K of
# one chunk BMM_F32_ONE_WIDE: two stages, and each thread's chunk sums in
# shared memory (rows x columns floats), two blocks an SM
BMM_F32_TILES = ((1, (1, 64, 32, 64, 4)), (4, (4, 16, 32, 64, 4)),
                 (16, (16, 64, 32, 256, 3)), (64, (64, 64, 32, 256, 3)),
                 (None, (128, 128, 16, 256, 3)))
BMM_F32_ONE_WIDE = (128, 128, 16, 256, 2)
BMM_SPLIT_MAX_OUTPUTS = 8192
BMM_SPLIT_MIN_K = 8 * BMM_CHUNK
BMM_SPLIT_CLUSTER = 8     # blocks per output
BMM_SPLIT_ROUND = 32      # chunks a block stages at a time
BMM_SPLIT_SMEM = (2 * BMM_SPLIT_ROUND * (BMM_CHUNK + 1) + BMM_SPLIT_ROUND) * 4
BMM_BATCH_GRID = 65535
# the lanes in sequence: (most rows, (rows, columns, warps along m,
# stages, k-tiles a stage)) in order, after one lane (K <= 32: the paged
# write) on BMM_SEQ_ONE; a k-tile is one lane's 32 k at one stage of the
# order
BMM_SEQ_K = TC_WARP_K
BMM_SEQ_ONE = (128, 128, 2, 2, 1)
BMM_SEQ_TILES = ((16, (16, 128, 1, 3, 4)), (64, (64, 32, 4, 3, 4)),
                 (None, (128, 128, 2, 3, 4)))


def bmm_seq_smem(bm: int, bn: int, stages: int, kg: int, k: int,
                 out_f32: bool) -> int:
    """Dynamic shared memory of one launch of the lanes in sequence
    (csrc's ``seq_smem``): the stages its k-tiles fill, at most
    ``stages``, and at least the epilogue's staged tile (rows of ``bn``
    outputs and 16 bytes)."""
    tiles = (-(-k // TC_WARP_K) if k < TC_KS else _WARPS) * -(-k // TC_KS)
    ring = min(stages, -(-tiles // kg)) * kg * BMM_SEQ_K * (bm + bn) * 2
    osize = 4 if out_f32 else 2
    return max(ring, bm * (bn * osize + 16))


class BatchedMatmulPlan(NamedTuple):
    route: str        # "tensor_core" (both bf16 or both f16) or "cuda_core"
    bm: int           # rows per block
    bn: int           # columns per block
    grid: Tuple[int, int]   # (output tiles [x cluster], batch blocks)
    stages: int       # cp.async ring depth (0: none)
    k_stage: int      # the K order's stage (tensor cores) or the k tile
    smem: int         # dynamic shared-memory bytes per block
    a_copy: str       # A's copies: "rows", "columns" or "elements" (16-bit,
    b_copy: str       # see batched_matmul_copy), "vectors" or "elements"
    lanes: int        # partial sums per output, added in lane order
    lane_k: int       # consecutive k a lane takes per stage
    kernel: str = ""  # the device function (chip_smoke's KERNEL_FUNCS)
    ring_k: int = 0   # k per ring stage or shared-memory tile
    threads: int = _THREADS   # per block
    cluster: int = 1  # blocks per cluster


def batched_matmul_supported(batch: int, m: int, n: int, k: int,
                             a_dtype: torch.dtype,
                             b_dtype: torch.dtype) -> bool:
    """Every shape of the float types the kernels read (f32, bf16, f16,
    in any pair: a mixed pair runs in f32): any batch, M, N and K of at
    least 1 within 32-bit counts; strides are 64-bit and masked edges
    need no alignment.  Only other types are refused."""
    return (a_dtype in KERNEL_DTYPES and b_dtype in KERNEL_DTYPES
            and _ok_dims(batch, m, n, k))


def batched_matmul_copy(s_row: int, s_col: int, s_batch: int, n_row: int,
                        n_col: int, aligned: bool = True) -> str:
    """How the 16-bit route copies an operand (csrc's ``copy_mode``; A's
    row index is k, B's is n): ``"rows"`` (16-byte cp.async along the
    row index, where it is contiguous), ``"columns"`` (16-byte vectors
    along the other index: a transposed operand, A as (K, M) or B as (N,
    K)) or ``"elements"``.  A k-tile keeps the layout the copy reads,
    rows or columns, and ldmatrix or ldmatrix.trans takes each fragment
    from it, so no copy transposes in registers.  A vector needs a
    16-byte aligned start, batch stride and cross stride in whole
    8-element chunks, and an extent along it in whole chunks."""
    if not aligned or s_batch % 8:
        return "elements"
    if s_row == 1 and s_col % 8 == 0 and n_row % 8 == 0:
        return "rows"
    if s_col == 1 and s_row % 8 == 0 and n_col % 8 == 0:
        return "columns"
    return "elements"


def bmm_wgmma(m: int, k: int, a_copy: str, b_copy: str) -> bool:
    """Whether the 16-bit batched kernel takes the wgmma mainloop
    (csrc/wg_gemm.cuh) for the training tiles (more than 64 rows, more
    than one lane of k): where the TMA unit reads both operands, each in
    the "rows" or "columns" copy mode (a 16-byte aligned start, strides
    in whole 16 bytes).  Elsewhere ``bmm_seq_kernel``.  (csrc also keeps
    ``bmm_seq_kernel`` for several batches 0 apart, which no dense
    operand is.)"""
    return (m > BMM_SEQ_TILES[1][0] and k > BMM_SEQ_K
            and a_copy != "elements" and b_copy != "elements")


def batched_matmul_f32_copy(s_x: int, s_k: int, s_batch: int, n_x: int,
                            aligned: bool = True) -> str:
    """How the f32 tiles copy an operand's k tile into ``[k][x]`` (x is
    A's m or B's n): ``"vectors"`` (16-byte cp.async along a contiguous
    x, rows and batches on 16 bytes, an extent in whole vectors) or
    ``"elements"`` (4-byte cp.async, the threads along the contiguous
    index)."""
    if aligned and s_x == 1 and s_k % 4 == 0 and s_batch % 4 == 0 and \
            n_x % 4 == 0:
        return "vectors"
    return "elements"


def _f32_tile(m: int, n: int, k: int) -> Tuple[int, int, int, int, int]:
    for i, (most, tile) in enumerate(BMM_F32_TILES):
        if most is None:
            if n <= 64:
                return BMM_F32_TILES[i - 1][1]
            return BMM_F32_ONE_WIDE if k <= BMM_CHUNK else tile
        if m <= most:
            return tile
    raise AssertionError("unreachable")


def batched_matmul_plan(batch: int, m: int, n: int, k: int,
                        dtype: torch.dtype, a_trans: bool = False,
                        b_trans: bool = False,
                        out_f32: bool = True) -> BatchedMatmulPlan:
    """How csrc/batched_matmul.cu launches ``(batch, m, k) @ (batch, k,
    n)`` on dense operands (16-bit: ``bmm_seq_kernel``, or the wgmma
    mainloop ``wg_gemm_kernel`` where :func:`bmm_wgmma` says so), A given
    as (k, m) when ``a_trans`` and B as (n, k) when ``b_trans`` (read
    through strides, not copied), each
    16-byte aligned, into an f32 output (else the operands' 16-bit type).
    ``dtype`` is the operands' type (f32 for a mixed pair).  The K order
    (:func:`batched_matmul_k_order`) is a function of ``k`` and the route
    alone."""
    bb = min(batch, BMM_BATCH_GRID)
    if dtype == torch.float32:
        chunks = -(-k // BMM_CHUNK)
        if k >= BMM_SPLIT_MIN_K and batch * m * n <= BMM_SPLIT_MAX_OUTPUTS:
            return BatchedMatmulPlan(
                "cuda_core", 1, 1, (m * n * BMM_SPLIT_CLUSTER, bb), 0,
                BMM_CHUNK, BMM_SPLIT_SMEM, "elements", "elements", chunks,
                BMM_CHUNK, "bmm_f32_split_kernel", BMM_CHUNK, _THREADS,
                BMM_SPLIT_CLUSTER)
        tile = _f32_tile(m, n, k)
        bm, bn, bk, threads, stages = tile
        sums = bm * bn * 4 if tile == BMM_F32_ONE_WIDE else 0
        a_copy = batched_matmul_f32_copy(1 if a_trans else k,
                                         m if a_trans else 1, m * k, m)
        b_copy = batched_matmul_f32_copy(k if b_trans else 1,
                                         1 if b_trans else n, k * n, n)
        return BatchedMatmulPlan(
            "cuda_core", bm, bn, (-(-m // bm) * -(-n // bn), bb), stages, bk,
            stages * bk * (bm + bn + 8) * 4 + sums, a_copy, b_copy, chunks,
            BMM_CHUNK, "bmm_f32_kernel", bk, threads)
    a_copy = batched_matmul_copy(m if a_trans else 1, 1 if a_trans else k,
                                 m * k, k, m)
    b_copy = batched_matmul_copy(k if b_trans else 1, 1 if b_trans else n,
                                 k * n, n, k)
    if bmm_wgmma(m, k, a_copy, b_copy):
        tiles = batch * -(-m // WG_BM) * -(-n // WG_BN)
        return BatchedMatmulPlan(
            "tensor_core", WG_BM, WG_BN, (wg_blocks(tiles), 1), WG_STAGES,
            TC_KS, WG_SMEM, a_copy, b_copy, _WARPS, TC_WARP_K,
            "wg_gemm_kernel", WG_STAGE_K, WG_THREADS)
    bm, bn, _, stages, kg = BMM_SEQ_ONE if k <= BMM_SEQ_K else next(
        t for most, t in BMM_SEQ_TILES if most is None or m <= most)
    return BatchedMatmulPlan(
        "tensor_core", bm, bn, (-(-m // bm) * -(-n // bn), bb), stages,
        TC_KS, bmm_seq_smem(bm, bn, stages, kg, k, out_f32), a_copy, b_copy,
        _WARPS, TC_WARP_K, "bmm_seq_kernel", kg * BMM_SEQ_K)


def batched_matmul_k_order(plan: BatchedMatmulPlan, k: int) -> tuple:
    """The order in which the kernel sums one output over ``k``.  CUDA
    cores: :func:`f32_k_order` (chunk c is k in [c * 256, (c + 1) * 256),
    in sub-chains of 32).  Tensor cores: one tuple per partial sum (lane),
    each listing its k in accumulation order, the lanes added in tuple
    order: lane (warp) w takes k in [s * k_stage + w * lane_k, s * k_stage
    + (w + 1) * lane_k) over the stages s in order.  Nothing here reads
    the plan's tile or grid."""
    if plan.route == "cuda_core":
        return f32_k_order(k)
    return tuple(
        tuple(kk for s in range(0, k, plan.k_stage)
              for kk in range(s + w * plan.lane_k,
                              min(s + (w + 1) * plan.lane_k, k)))
        for w in range(plan.lanes))
