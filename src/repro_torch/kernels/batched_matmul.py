"""Batched matmul with one fixed summation order: (batch, M, K) @ (batch,
K, N), f32 accumulation, out in f32 or the operands' 16-bit type.

Replaces no TPU kernel: in the reference these are XLA's
``lax.dot_general`` products, which the port's emitter ran as
``torch.einsum``, a cuBLAS GEMM whose algorithm on the card follows the
shape.  This kernel (``csrc/batched_matmul.cu``) sums each output in one
order fixed by K alone (:func:`ops.batched_matmul_k_order`), so a
request's attention gives the same bits at any slot count and prefill
chunk.  Operands are read through their strides: a transposed view is no
copy.  On a CPU tensor the wrapper runs the plain version
(:func:`ref.batched_matmul_ref`); on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, ops
from .ref import batched_matmul_ref

launches = 0   # kernel launches (CUDA only)
rejected = 0   # CUDA calls whose types the predicate refused


def supported(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The kernel's predicate for ``a (batch, M, K) @ b (batch, K, N)``;
    a refusal of a CUDA operand is counted in :data:`rejected`."""
    global rejected
    # a dimension of size 0 launches nothing (batched_matmul)
    ok = a.ndim == b.ndim == 3 and ops.batched_matmul_supported(
        *(max(int(d), 1) for d in (a.shape[0], a.shape[1], b.shape[2],
                                   a.shape[2])), a.dtype, b.dtype)
    if not ok and a.is_cuda:
        rejected += 1
    return ok


def batched_matmul(a: torch.Tensor, b: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` per batch, accumulated in f32 and cast to ``out_dtype``
    (default: the operands' type when they share one, else f32).  Both
    16-bit operands of one type take the tensor cores; f32 and mixed
    pairs (upcast here) the CUDA cores.  A dimension of size 0 gives an
    empty or zero result without a launch."""
    global launches
    if out_dtype is None:
        out_dtype = a.dtype if a.dtype == b.dtype else torch.float32
    if a.device.type == "cpu":
        return batched_matmul_ref(a, b, out_dtype)
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] or \
            a.shape[2] != b.shape[1]:
        raise ValueError(f"batched_matmul: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    batch, M, K = a.shape
    N = b.shape[2]
    if not ops.batched_matmul_supported(max(batch, 1), max(M, 1), max(N, 1),
                                        max(K, 1), a.dtype, b.dtype):
        raise ValueError(f"batched_matmul kernel does not take {a.dtype} @ "
                         f"{b.dtype} at batch={batch} M={M} N={N} K={K}")
    if b.device != a.device:
        raise ValueError(f"batched_matmul: operands on {a.device} and "
                         f"{b.device}")
    if batch * M * N == 0 or K == 0:
        return torch.zeros((batch, M, N), dtype=out_dtype, device=a.device)
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    tc = a.dtype != torch.float32
    out = torch.empty((batch, M, N), device=a.device,
                      dtype=a.dtype if tc and out_dtype == a.dtype
                      else torch.float32)
    _build.launch(
        "repro_batched_matmul", a.device, a.data_ptr(), b.data_ptr(),
        out.data_ptr(), batch, M, N, K, *a.stride(), *b.stride(),
        _build.dtype_code(a, "batched_matmul"),
        int(out.dtype == torch.float32), _build.stream(a))
    launches += 1
    return out if out.dtype == out_dtype else out.to(out_dtype)


def dot_operands(a: torch.Tensor, b: torch.Tensor, contracting, batch):
    """``lax.dot_general``'s dimension groups as the kernel's operands:
    ``(a3 (batch, M, K), b3 (batch, K, N), out_shape)``, where batch, M,
    K and N are the products of the batch, a's free, the contracting and
    b's free dimensions, and ``out_shape`` is dot_general's (batch, a's
    free, b's free).  A permuted view is reshaped without a copy where
    each group collapses to one stride, and copied where it does not, as
    ``torch.einsum`` does."""
    (lc, rc), (lb, rb) = contracting, batch
    a_free = [i for i in range(a.ndim) if i not in lc and i not in lb]
    b_free = [i for i in range(b.ndim) if i not in rc and i not in rb]
    bt, m, k, n = (math.prod(int(t.shape[d]) for d in dims)
                   for t, dims in ((a, lb), (a, a_free), (a, lc),
                                   (b, b_free)))
    a3 = a.permute(*lb, *a_free, *lc).reshape(bt, m, k)
    b3 = b.permute(*rb, *rc, *b_free).reshape(bt, k, n)
    shape = tuple(a.shape[i] for i in (*lb, *a_free)) + \
        tuple(b.shape[i] for i in b_free)
    return a3, b3, shape

