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


def batched_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """(batch, M, K) @ (batch, K, N) in f32 (16-bit operands upcast, as
    ``lax.dot_general(..., preferred_element_type=f32)``), cast to
    ``out_dtype``."""
    return torch.matmul(_f32(a), _f32(b)).to(out_dtype)


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


NEG_INF = -1e30


def attention_mask(sq: int, skv: int, *, causal: bool, window, q_offset,
                   device) -> torch.Tensor:
    """(Sq, Skv) visibility on absolute positions: query i sits at
    ``i + q_offset`` (an int, or a 0-d/1-element tensor read on the
    device -- never on the host), key j at ``j``."""
    qpos = torch.arange(sq, device=device)[:, None]
    if q_offset is not None:
        off = q_offset.reshape(()).to(device=device, dtype=torch.int64) \
            if isinstance(q_offset, torch.Tensor) else int(q_offset)
        qpos = qpos + off
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window=None, scale=None,
                        q_offset=None) -> torch.Tensor:
    """The function of the Pallas flash kernel
    (``repro/kernels/flash_attention.py:_flash_kernel``) in one pass:
    q (B, Hq, Sq, Dk), k (B, Hkv, Skv, Dk), v (B, Hkv, Skv, Dv); query
    head h reads kv head ``h // (Hq // Hkv)``.  Scores ``q.k * scale``
    in f32, masked to -1e30, f32 softmax and f32 ``p.V`` (unlike
    ``attention_ref``, which rounds p to v's dtype first); a row that
    sees no key gives exactly 0.  Out in q's dtype."""
    B, Hq, Sq, Dk = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if scale is None:
        scale = 1.0 / (Dk ** 0.5)
    rep = Hq // Hkv
    qg = _f32(q).reshape(B, Hkv, rep, Sq, Dk)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, _f32(k)) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, torch.zeros((), device=q.device), m)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=q.device))
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum("bgrqk,bgkd->bgrqd", p, _f32(v))
    out = acc / torch.where(l == 0, torch.ones((), device=q.device), l)
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)
