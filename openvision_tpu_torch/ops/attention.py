"""Attention over ``(batch, length, heads, head_dim)`` tensors and its dispatcher.

Counterpart of ``openvision_tpu/ops/attention.py``:

- :func:`xla_attention`: eager einsum attention, the numerics reference,
  with the softmax taken in f32;
- :func:`dispatch_attention`: routes by name. ``xla`` runs
  :func:`xla_attention`; ``flash`` runs the flash kernel
  (``ops/flash_attention.py``); ``scan`` (the JAX package's blockwise
  online-softmax scan, the same function) runs ``flash`` too. ``ring``
  runs :func:`xla_attention` with no active mesh or a mesh with seq = 1
  (:203-217), and the ring over the ``seq`` axis otherwise:
  ``ops/ring_attention.py:ring_attention_sharded`` on this rank's chunks
  inside a stack whose tokens stay sharded over seq (``seq_chunk``), else
  ``ring_attention_whole`` on whole tokens. JAX's ring route drops the mask, the
  prefix-LM mask and the attention dropout without a word (:216 passes
  only ``causal`` and ``sm_scale``; with no seq axis it drops
  ``prefix_len`` too); the port passes all of them to ``xla`` and raises by
  name for each under seq > 1, where the ring cannot honour them.

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
from openvision_tpu_torch.ops.ring_attention import ring_attention_sharded, ring_attention_whole
from openvision_tpu_torch.parallel.mesh import active_mesh


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
    seq_chunk=None,
) -> torch.Tensor:
    """Routes to an attention implementation by name: "xla" | "flash" |
    "scan" (runs flash) | "ring". Arbitrary masks and the dropout only on
    "xla"; "flash" takes the causal and prefix-LM masks natively; "ring" is
    "xla" without a seq axis and takes the causal mask alone over one.
    `seq_chunk` (a ``parallel.SeqChunk``): q, k and v are this rank's
    chunks of a sequence-sharded stack ("ring" only), else whole."""
    if impl == "xla":
        return xla_attention(q, k, v, mask=mask, causal=causal, prefix_len=prefix_len,
                             sm_scale=sm_scale, dtype=dtype, dropout_rate=dropout_rate,
                             dropout_gen=dropout_gen)
    if impl == "ring":
        mesh = active_mesh()
        if seq_chunk is None and (mesh is None or mesh.seq <= 1):  # plain attention
            return xla_attention(q, k, v, mask=mask, causal=causal, prefix_len=prefix_len,
                                 sm_scale=sm_scale, dtype=dtype, dropout_rate=dropout_rate,
                                 dropout_gen=dropout_gen)
        for name, given in (("a mask", mask is not None),
                            ("a prefix-LM mask (prefix_len > 0)", prefix_len > 0),
                            ("attention dropout", dropout_rate > 0.0 and dropout_gen is not None)):
            if given:
                raise NotImplementedError(
                    f"attention impl 'ring' over seq={mesh.seq} does not take {name} (the ring "
                    "masks causally or not at all); use impl='xla' or seq=1")
        if dtype is not None:
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        if seq_chunk is not None:  # this rank's chunk of a sequence-sharded stack
            return ring_attention_sharded(q, k, v, mesh, length=seq_chunk.length,
                                          seq_axis="seq", causal=causal, sm_scale=sm_scale)
        return ring_attention_whole(q, k, v, mesh, seq_axis="seq", causal=causal,
                                    sm_scale=sm_scale)
    if impl not in ("flash", "scan"):
        raise ValueError(f"Unknown attention impl: {impl!r}")
    if mask is not None:
        raise NotImplementedError(
            f"attention impl {impl!r} supports only causal masks; use impl='xla'")
    if dtype is not None:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    return flash_attention(q, k, v, causal=causal, prefix_len=prefix_len, sm_scale=sm_scale)
