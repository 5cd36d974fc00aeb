"""The natural-layout attention sub-block on hand-written Hopper kernels.

Counterpart of ``openvision_tpu/ops/fused_attention.py:fused_mhsa_block``,
whose Pallas kernel ``_block_kernel`` (:440) computes one pre-LN attention
sub-block per image, x + OutProj(MHA(LN(x))), in the natural (B, L, D)
layout, unmasked, causal or prefix-LM (key j visible to query i iff
j <= max(i, prefix_len - 1)). The port composes it from the kernels of
``ops/fused_encoder.py``, as it composes ``_mhsa_t_kernel``:

    layernorm -> gemm_bias_act (QKV) -> attention -> gemm_bias_act (out-proj
    + bo, then the residual)

and keeps the numerics of ``_block_kernel`` / ``_block_fwd_impl``:

- the softmax scale: the Pallas wrapper folds it into wq (rounded to the
  compute dtype, ``(wq * sm_scale).astype(x.dtype)`` at :541) and into bq
  in f32 (:542). The kernels take head_dim 64, where the scale is 2**-3, and
  scaling by a power of two commutes with every rounding on the way, so the
  kernel path leaves the weights as they are and has the attention kernel
  scale q (rounded to the compute dtype) by it instead: the same bits, and
  no copy of the QKV weight per call. The plain version folds, as Pallas;
- f32 scores, the max-subtracted softmax with masked keys dropped and a row
  sum of 0 taken as 1, p rounded to the compute dtype for p.v, and
  o = (p.v) / l rounded to the compute dtype;
- out-proj + bo in f32, rounded, then the residual added and rounded again
  (:500-503).

The LayerNorm variance is the two-pass one of ``_block_reference`` (:506,
``jnp.var``) and of the ``layernorm`` kernel; the Pallas kernel takes
E[x^2] - mean^2, which differs by f32 rounding only.

Weights are in torch's (out, in) layout: ``w_qkv`` (3D, D) is the query,
key and value kernels transposed and stacked (``in_proj_weight``), ``w_o``
(D, D) the out kernel transposed. LayerNorm parameters and biases are f32.
The tensor-parallel variant (``_block_partial_kernel``) and the backward
kernel are not ported yet: a CUDA tensor that requires grad raises.
"""

from __future__ import annotations

import math

import torch

from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import kernels


def fused_mhsa_block_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, *, num_heads: int,
                           sm_scale: float | None = None, causal: bool = False,
                           prefix_len: int = 0, eps: float = 1e-6):
    """x + OutProj(MHA(LN(x))) in f32 math, rounded where the kernels round;
    the counterpart of ``_block_reference``. x: (B, L, D)."""
    d = x.shape[-1]
    if sm_scale is None:
        sm_scale = (d // num_heads) ** -0.5
    w = torch.cat([w_qkv[:d] * sm_scale, w_qkv[d:]])
    b = torch.cat([b_qkv[:d].float() * sm_scale, b_qkv[d:].float()])
    y = fe.layernorm_plain(x, ln_w, ln_b, eps)
    qkv = fe.linear_plain(y, w, b)
    o = fe.attention_plain(qkv, num_heads, causal=causal,
                           prefix_len=prefix_len if causal else 0, scale=1.0)
    return fe.linear_plain(o, w_o, b_o, residual=x)


def fused_mhsa_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, *, num_heads: int,
                     sm_scale: float | None = None, causal: bool = False,
                     prefix_len: int = 0, eps: float = 1e-6):
    """``_block_kernel`` as 4 launches: layernorm, QKV, attention (masked,
    q scaled by `sm_scale`), out-proj + residual. x: (B, L, D) bf16 on CUDA;
    on the CPU the plain version runs. A scale that is not a power of two
    raises on CUDA: only a power of two gives the folded weights' bits."""
    if kernels.on_cpu(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o):
        return fused_mhsa_block_plain(
            x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, num_heads=num_heads, sm_scale=sm_scale,
            causal=causal, prefix_len=prefix_len, eps=eps)
    if sm_scale is None:
        sm_scale = (x.shape[-1] // num_heads) ** -0.5
    if math.frexp(sm_scale)[0] != 0.5:
        raise ValueError(f"fused_mhsa_block: the kernel path takes a power-of-two softmax "
                         f"scale, got {sm_scale}")
    y = fe.layernorm(x, ln_w, ln_b, eps)
    qkv = fe.gemm_bias_act(y, w_qkv, b_qkv)
    o = fe.attention(qkv, num_heads, causal=causal, prefix_len=prefix_len if causal else 0,
                     scale=sm_scale)
    return fe.gemm_bias_act(o, w_o, b_o, residual=x)
