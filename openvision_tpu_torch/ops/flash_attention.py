"""Flash-attention forward on a hand-written Hopper kernel.

Counterpart of ``openvision_tpu/ops/flash_attention.py:flash_attention`` over
(B, L, H, head_dim) q, k and v, forward only: the Pallas kernels
``_fwd_kernel`` (:133) and ``_fwd_kernel_single_k(_nolse)`` (:76, :85) run
here as ``csrc/attention.cu`` (``ovt_flash_attention``), which reads q, k
and v by base pointer and strides, takes Lq != Lk, the unmasked, causal and
prefix-LM masks (key j visible to query i iff j <= max(i, prefix_len - 1);
``_band_mask`` :46), skips key tiles no query of a tile can see (``_live``
:61), and writes the f32 logsumexp when asked.

The Pallas wrapper picks one of two rounding orders by its default block
plan (``_plan`` :294): with a single k block (Lk padded to 128 is at most
768) q is scaled in the input dtype before q.k^T (:335-337); with several
the f32 scores are scaled (:155). The CUDA kernel tiles keys by 64 either
way and follows the order that plan takes for Lk; at head_dim 64 the two
agree exactly (the scale is 2**-3).

:func:`flash_attention_plain` is the f32 counterpart (o and lse).

Under autograd the call runs as a ``torch.autograd.Function`` (the JAX
package's ``jax.custom_vjp`` ``_flash``, :467-493): the forward saves q, k,
v, o and the f32 logsumexp, and the backward runs the Pallas backward
kernels ``_dq_kernel`` and ``_dkv_kernel`` (:207, :245, through ``_bwd_impl``
:388) as ``ops/grad_kernels.py:attention_bwd``: delta = rowsum(do * o), P
recomputed from the logsumexp with the unscaled q.k^T times the scale
(``_recompute_p`` :201), the same masks, Lq != Lk and dead-tile skipping as
the forward. On the CPU both passes run their plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from openvision_tpu_torch.ops import kernels
from openvision_tpu_torch.ops.fused_encoder import attend_plain
from openvision_tpu_torch.ops.grad_kernels import attention_bwd

LANES = 128  # the Pallas plan's alignment of a block


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def single_k(lk: int) -> bool:
    """Whether the default Pallas plan (``_plan``) puts all keys in one k
    block: Lk padded to 128 lanes is at most 768."""
    return _ceil_to(lk, LANES) <= 768


@functools.lru_cache(maxsize=64)
def _cast(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=dtype))


def _order(q, lk, sm_scale):
    """(scale, prescale) in the Pallas order: the single-k path multiplies q
    by the scale cast to q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if single_k(lk):
        return _cast(float(sm_scale), q.dtype), True
    return float(sm_scale), False


def flash_attention_plain(q, k, v, *, causal: bool = False, prefix_len: int = 0,
                          sm_scale: float | None = None, nomax: bool = False):
    """(o, lse): o (B, Lq, H, hd) in q.dtype, lse (B, H, Lq) f32 (log(l)
    under ``nomax``, the fused_t softmax's exp(min(s, 80)))."""
    if prefix_len and not causal:
        prefix_len = 0  # dense attention already sees everything
    scale, prescale = _order(q, k.shape[1], sm_scale)
    return attend_plain(q, k, v, scale=scale, prescale=prescale, causal=causal,
                        prefix_len=prefix_len, nomax=nomax)


class _Flash(torch.autograd.Function):
    """The flash forward (kernel or plain by device) with the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, prefix_len, sm_scale):
        o, lse = _forward(q, k, v, causal=causal, prefix_len=prefix_len, sm_scale=sm_scale,
                          return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, prefix_len, q.shape[-1] ** -0.5 if sm_scale is None else sm_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, prefix_len, scale = ctx.cfg
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do.contiguous(), scale=float(scale),
                                   causal=causal, prefix_len=prefix_len if causal else 0)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, prefix_len: int = 0,
                    sm_scale: float | None = None, return_lse: bool = False):
    """Flash attention over (batch, length, heads, head_dim) inputs.

    q: (B, Lq, H, 64), k and v: (B, Lk, H, 64), bf16 on CUDA with unit
    stride in head_dim (any other strides that are multiples of 8); returns
    o (B, Lq, H, 64) bf16, and lse (B, H, Lq) f32 with ``return_lse``. On the
    CPU the plain version runs. When autograd records (grad enabled and an
    input requires grad) the call is differentiable through the backward
    kernels; it then returns o only.
    """
    if q.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"expected q (B, Lq, H, D) and k, v (B, Lk, H, D), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if return_lse:
            raise ValueError("flash_attention: return_lse is for calls autograd does not record")
        return _Flash.apply(q, k, v, causal, prefix_len, sm_scale)
    return _forward(q, k, v, causal=causal, prefix_len=prefix_len, sm_scale=sm_scale,
                    return_lse=return_lse)


def _forward(q, k, v, *, causal: bool, prefix_len: int, sm_scale, return_lse: bool,
             nomax: bool = False):
    """The forward: the plain version on the CPU, the kernel on CUDA.
    ``nomax`` (exp(min(s, 80)), lse = log(l)) serves the fused_t backward's
    recompute (``_mhsa_t_bwd_kernel``); the flash path itself has none."""
    if kernels.on_cpu(q, k, v):
        o, lse = flash_attention_plain(q, k, v, causal=causal, prefix_len=prefix_len,
                                       sm_scale=sm_scale, nomax=nomax)
        return (o, lse) if return_lse else o
    b, lq, h, hd = q.shape
    lk = k.shape[1]
    if hd != 64:
        raise ValueError(f"flash_attention: the kernel takes head_dim 64, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        kernels.check_operand(f"flash_attention {name}", t, torch.bfloat16, contiguous=False)
        if t.shape[1] * t.stride(1) + t.shape[2] * t.stride(2) >= 2**31:
            raise ValueError(f"flash_attention {name}: offsets inside one batch item must "
                             "stay below 2**31 elements")
    if prefix_len and not causal:
        prefix_len = 0
    scale, prescale = _order(q, lk, sm_scale)
    out = torch.empty(b, lq, h, hd, dtype=torch.bfloat16, device=q.device)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device) if return_lse else None
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    rc = kernels.lib().ovt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), strides, b, lq, lk, h, hd, scale,
        int(prescale), int(causal), int(prefix_len), int(nomax), kernels.stream(q))
    kernels.raise_on(rc, "flash_attention")
    kernels.count("flash_attention")
    return (out, lse) if return_lse else out
