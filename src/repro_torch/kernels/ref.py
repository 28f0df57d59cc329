"""Plain PyTorch versions of the port's kernels, mirroring the JAX
package's oracles (``repro/kernels/ref.py``): f32 accumulation for every
product, the result cast back to the input's dtype between fused stages.

The wrappers run these for tensors that lie on the CPU; on the card they
are the yardstick each kernel is held against.
"""
from __future__ import annotations

import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = _f32(x)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * _f32(w)).to(x.dtype)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_f32(a), _f32(b)).to(a.dtype)


def swiglu_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """matmul(silu(x @ w_gate) * (x @ w_up), w_down), f32 accumulate;
    silu as ``jax.nn.silu`` computes it under XLA: g / (1 + exp(-g)) as
    g * (1 / (1 + exp(-g))), each op rounded to x's dtype."""
    g = matmul_ref(x, w_gate)
    g = g * torch.reciprocal(torch.exp(-g) + 1)
    u = matmul_ref(x, w_up)
    return matmul_ref((g * u).to(x.dtype), w_down)


def norm_matmul_ref(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    return matmul_ref(rmsnorm_ref(x, g, eps=eps), w)
