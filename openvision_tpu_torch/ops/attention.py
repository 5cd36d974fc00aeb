"""Attention over ``(batch, length, heads, head_dim)`` tensors and its dispatcher.

Counterpart of ``openvision_tpu/ops/attention.py``:

- :func:`xla_attention`: eager einsum attention, the numerics reference,
  with the softmax taken in f32;
- :func:`dispatch_attention`: routes by name. ``xla`` runs
  :func:`xla_attention`; ``flash`` runs the flash kernel
  (``ops/flash_attention.py``); ``scan`` (the JAX package's blockwise
  online-softmax scan, the same function) runs ``flash`` too. ``ring``
  (sequence-parallel attention) is not ported yet and raises.

:func:`xla_attention` takes the JAX function's attention dropout (:50-54):
one (Lq, Lk) keep mask, broadcast over batch and heads, drawn from a given
``torch.Generator``; the flash route takes none, as in the JAX dispatcher.
:func:`prefix_lm_mask` is the port's copy of
``openvision_tpu/models/encoder.py:prefix_lm_mask``.
"""

from __future__ import annotations

from typing import Optional

import torch

from openvision_tpu_torch.ops.flash_attention import flash_attention


def prefix_lm_mask(batch: int, length: int, prefix_len: int, device=None) -> torch.Tensor:
    """(B, 1, L, L) mask: prefix rows see the prefix; suffix rows are causal.

    Column j is allowed from row i iff j <= max(i, prefix_len - 1).
    """
    rows = torch.arange(length, device=device)[:, None]
    cols = torch.arange(length, device=device)[None, :]
    mask = cols <= torch.clamp(rows, min=prefix_len - 1)
    return mask[None, None].expand(batch, 1, length, length)


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    prefix_len: int = 0,
    sm_scale: float | None = None,
    dtype: torch.dtype | None = None,
    dropout_rate: float = 0.0,
    dropout_gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Einsum attention. `mask` broadcasts to (B, H, Lq, Lk); True = keep.

    ``causal`` with ``prefix_len > 0`` is the prefix-LM mask (the JAX
    dispatcher builds it with ``prefix_lm_mask`` for this path). With
    `dropout_gen` and a rate > 0 the probabilities take a dropout mask.
    """
    if causal and prefix_len > 0:
        pmask = prefix_lm_mask(q.shape[0], q.shape[1], prefix_len, q.device)
        mask = pmask if mask is None else (mask & pmask)
        causal = False
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
    if dropout_rate > 0.0 and dropout_gen is not None:
        u = torch.rand(p.shape[-2:], generator=dropout_gen, device=dropout_gen.device)
        p = p * (u < 1.0 - dropout_rate).to(p.device, p.dtype) / (1.0 - dropout_rate)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def dispatch_attention(
    impl: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    prefix_len: int = 0,
    sm_scale: float | None = None,
    dtype: torch.dtype | None = None,
    dropout_rate: float = 0.0,
    dropout_gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Routes to an attention implementation by name: "xla" | "flash" |
    "scan" (runs flash). Arbitrary masks and the dropout only on "xla";
    "flash" takes the causal and prefix-LM masks natively."""
    if impl == "xla":
        return xla_attention(q, k, v, mask=mask, causal=causal, prefix_len=prefix_len,
                             sm_scale=sm_scale, dtype=dtype, dropout_rate=dropout_rate,
                             dropout_gen=dropout_gen)
    if impl == "ring":
        raise NotImplementedError(
            "attention impl 'ring' (sequence-parallel ring attention) is not ported yet")
    if impl not in ("flash", "scan"):
        raise ValueError(f"Unknown attention impl: {impl!r}")
    if mask is not None:
        raise NotImplementedError(
            f"attention impl {impl!r} supports only causal masks; use impl='xla'")
    if dtype is not None:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    return flash_attention(q, k, v, causal=causal, prefix_len=prefix_len, sm_scale=sm_scale)
