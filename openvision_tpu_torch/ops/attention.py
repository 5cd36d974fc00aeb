"""Eager einsum attention over ``(batch, length, heads, head_dim)`` tensors.

Counterpart of ``openvision_tpu/ops/attention.py:xla_attention``: the
numerics reference, with the softmax taken in f32. Inference only, so the
dropout arguments of the JAX function are left out. The blockwise and flash
paths of the JAX module are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    sm_scale: float | None = None,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Einsum attention. `mask` broadcasts to (B, H, Lq, Lk); True = keep."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if dtype is not None:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q * sm_scale, k)
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        causal_mask = torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril()
        mask = causal_mask if mask is None else (mask & causal_mask)
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
