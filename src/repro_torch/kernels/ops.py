"""Shape predicates of the port's Hopper kernels (the kernel-selection
surface the torch emitter consults, as the JAX emitter consults
``repro/kernels/ops.py``).

The TPU kernels needed (8, 128)-tiled shapes: rows a multiple of 8 or
128, widths of 128.  The Hopper kernels mask their ragged edges instead,
so any row count M >= 1 is taken -- decode's 4 slots, a 64-row prefill
chunk, the 1-row unembed of a prefill's last position.  What they do
need is that each weight row splits into 16-byte vectors (the output
width N a multiple of 16 / itemsize) and, for the fused norm, that a
normalized row fits in shared memory.
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


def row_tile(m: int) -> int:
    """Row-tile height the GEMM kernels are instantiated for (mirrors
    ``pick_bm`` in csrc/common.cuh)."""
    return 1 if m <= 1 else (4 if m <= 4 else 16)


# -- matmul --------------------------------------------------------------------
def matmul_supported(m: int, k: int, n: int, dtype: torch.dtype) -> bool:
    return (dtype in KERNEL_DTYPES and _ok_dims(m, k, n, m * k, k * n, m * n)
            and n % vec(dtype) == 0)


# mirrors csrc/tc_gemm.cuh and csrc/matmul.cu: stages of 256 k, each
# warp a fixed 32-wide k slice of every stage, the warps summed in order
TC_KS = 256
TC_WARP_K = TC_KS // _WARPS
TC_EVICT_FIRST_BYTES = 256 << 20


class MatmulPlan(NamedTuple):
    route: str        # "tensor_core" (bf16, f16) or "cuda_core" (f32)
    bm: int           # rows per block
    bn: int           # columns per block
    grid: Tuple[int, int]   # (column tiles, row tiles)
    stages: int       # cp.async ring depth (0: no ring)
    k_stage: int      # k per stage
    smem: int         # dynamic shared-memory bytes per block
    b_evict_first: bool     # B's copies carry L2's evict-first policy


def tc_tile(m: int, n: int) -> Tuple[int, int, int]:
    """(rows, columns, stages) of the tensor-core block for ``m`` rows of
    output ``n`` wide."""
    if m <= 16:
        return (16, 128, 3) if n >= 8192 else (16, 32, 4)
    return (64, 32, 4) if m <= 64 else (64, 64, 3)


def tc_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """The ring of 16-bit B and A stages, or the epilogue's f32 warp
    partials that reuse it (``tc::Tile::SMEM``)."""
    ring = stages * (TC_KS * bn + bm * TC_KS) * 2
    return max(ring, _WARPS * bm * (bn + 8) * 4)


def matmul_plan(m: int, k: int, n: int, dtype: torch.dtype) -> MatmulPlan:
    """How csrc/matmul.cu launches ``(m, k) @ (k, n)``.  The K order of
    the tensor-core route -- warp ``k // TC_WARP_K % 8`` of stage
    ``k // TC_KS``, stages in order, then the warps in order -- is a
    function of ``k`` alone; ``m`` and ``n`` pick only the tile."""
    if dtype == torch.float32:
        bm, bn = row_tile(m), 4 * vec(dtype)
        return MatmulPlan("cuda_core", bm, bn, (-(-n // bn), -(-m // bm)),
                          0, 0, 0, False)
    bm, bn, stages = tc_tile(m, n)
    return MatmulPlan("tensor_core", bm, bn, (-(-n // bn), -(-m // bm)),
                      stages, TC_KS, tc_smem_bytes(bm, bn, stages),
                      k * n * dtype.itemsize <= TC_EVICT_FIRST_BYTES)


# -- fused norm + matmul ----------------------------------------------------------
def norm_matmul_tile(m: int, d: int, dtype: torch.dtype) -> Optional[int]:
    """Row-tile height for the fused norm: the GEMM tile for ``m``,
    lowered until ``tile`` normalized rows of width ``d`` plus the
    block's reduction scratch fit in shared memory; None if one row
    does not fit."""
    size = torch.empty((), dtype=dtype).element_size()
    bn = 4 * vec(dtype)
    for bm in (16, 4, 1):
        if bm > row_tile(m):
            continue
        static = _WARPS * bm * bn * 4 + bm * 4
        if bm * d * size + static <= _SMEM:
            return bm
    return None


def norm_matmul_supported(m: int, d: int, n: int, dtype: torch.dtype) -> bool:
    return (matmul_supported(m, d, n, dtype)
            and norm_matmul_tile(m, d, dtype) is not None)


# -- fused swiglu -----------------------------------------------------------------
def swiglu_slices(f: int, dtype: torch.dtype) -> int:
    """F slices the fused MLP splits its hidden width into (one block
    each; 8 column vectors per slice, as csrc/swiglu.cu)."""
    bf = 8 * vec(dtype)
    return -(-int(f) // bf)


def swiglu_supported(m: int, d: int, f: int, do: int,
                     dtype: torch.dtype) -> bool:
    return (dtype in KERNEL_DTYPES
            and _ok_dims(m, d, f, do, m * d, d * f, f * do, m * do,
                         swiglu_slices(f, dtype) * m * do)
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
# mirrors csrc/flash_attention.cu: 128 threads, a fixed KV tile of 64
# keys, K and V tiles in shared memory in their own dtype (rows padded by
# one 16-byte vector), the Q tile and the scores in f32
FLASH_BK = 64
FLASH_MAX_D = 256


def flash_q_tile(sq: int) -> int:
    """Query rows per block: 1 for decode, 4 for a few rows, else 16."""
    return 1 if sq <= 1 else (4 if sq <= 4 else 16)


def flash_smem_bytes(sq: int, dk: int, dv: int, dtype: torch.dtype) -> int:
    size = dtype.itemsize
    bq, pad = flash_q_tile(sq), vec(dtype)
    return (FLASH_BK * (dk + pad) * size + FLASH_BK * (dv + pad) * size
            + bq * dk * 4 + bq * FLASH_BK * 4 + 3 * bq * 4)


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
            and flash_smem_bytes(Sq, Dk, Dv, dtype) <= _SMEM)
