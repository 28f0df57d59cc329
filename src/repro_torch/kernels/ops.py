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

from typing import Optional, Sequence

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
    return 16 // torch.empty((), dtype=dtype).element_size()


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
