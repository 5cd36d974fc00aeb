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
  compute dtype, ``(wq * sm_scale).astype(x.dtype)`` at :541, the bf16 wq
  times the scale cast to bf16) and into bq in f32 (:542). Scaling by a
  power of two (2**-3 at head_dim 64, 2**-2 at 16) commutes with every
  rounding on the way, so there the kernel path leaves the weights as they
  are and has the attention kernel scale q instead: the same bits, and no
  copy of the QKV weight per call. At any other scale (head_dim 72, 80, ...)
  it folds, as Pallas, into a copy of wq a call. The plain version folds;
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

Tensor parallelism (the JAX ``_tp_block`` / ``_tp_qkv``, :910-1439): with
the heads sharded over the active mesh's tensor axis t, a rank holds
``w_qkv`` (3 D/t, D) (the q, k and v rows of its num_heads/t heads) and
``w_o`` (D, D/t). :func:`block_partial` is ``_block_partial_kernel`` (#11,
:938): the same chain with rectangular weights, ending in the out-projection
with no bias and no residual; :func:`block_partial_bwd` is
``_block_partial_bwd_kernel`` (#12, :1057): #10's chain with rectangular
weights, no residual in dx and no db_o. :func:`fused_mhsa_block_tp` sums
the shards' bf16 partials over tensor and adds x and bo (``_TPBlock``);
:func:`fused_qkv_attention_tp` runs #7/#8 on the shard's heads with dy
summed over tensor. The existing kernels take the shard's shapes (N and K
need only be multiples of 8; the attention kernels read q, k, v by stride),
so the two ports add no CUDA source.

:func:`fused_qkv_attention` is the Pallas ``_kernel`` (:92), the QKV
projection and attention without LayerNorm and out-projection, which the
attention module runs where the whole-sub-block path is not eligible
(LayerScale, or drop-path > 0 with dropout 0, in training): the QKV
``gemm_bias_act`` and the ``attention`` kernel forward, and under autograd
the backward of ``_qkv_bwd_kernel`` (:215) in 7 launches.

Under autograd the block is a ``torch.autograd.Function``, the JAX
package's ``jax.custom_vjp`` ``_fused_block`` (:569-592): the forward saves
x and the parameters only, and the backward computes what the Pallas
backward ``_block_bwd_kernel`` (:698-855) computes, recomputing the forward
from x. On the card that is a sequence of launches: layernorm, QKV
gemm_bias_act (q scaled after the bias in its epilogue, as Pallas scales
it) and the flash forward at scale 1 (o and its logsumexp) recompute the
forward; ``gemm_nn`` gives do = g . Wo; ``attention_bwd`` writes dq (its
rounded sum times the softmax scale), dk and dv into one (B, L, 3D) dqkv
buffer; ``gemm_tn``
gives dWo = g^T o and dW_qkv = dqkv^T y; ``gemm_nn`` gives dy = dqkv . W_qkv
in f32; ``layernorm_bwd`` gives dx (plus the residual g) and the LayerNorm
grads; ``colsum`` the bias grads (ops/grad_kernels.py). As the Pallas
wrapper (:906-907), the weight grads come back in the dtype of the weights
given, the f32 sums rounded once (the encoder passes bf16 casts of f32
master weights), and the LayerNorm and bias grads in f32.
:func:`fused_mhsa_block_bwd_plain` mirrors the Pallas kernel's roundings; the
kernel path differs from it only in f32 summation order and in taking o and
delta from the flash forward (p rounded before p.v, delta = rowsum(do . o))
where the Pallas kernel forms o from the rounded normalized probabilities
and delta as rowsum(dp * a).
"""

from __future__ import annotations

import math

import torch

from openvision_tpu_torch.ops import flash_attention as fl
from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops import grad_kernels as gk
from openvision_tpu_torch.ops import kernels
from openvision_tpu_torch.parallel import active_mesh, all_reduce, copy_to_tensor


def _folded(w_qkv, b_qkv, sm_scale: float):
    """The Pallas wrapper's fold of the softmax scale into wq (times the
    scale cast to the weight's dtype, rounded to it) and bq (f32), :157-162
    (:1005-1006 for a shard's (3 D/t, D) weight)."""
    d = w_qkv.shape[0] // 3
    return (torch.cat([w_qkv[:d] * kernels.cast_scalar(sm_scale, w_qkv.dtype), w_qkv[d:]]),
            torch.cat([b_qkv[:d].float() * sm_scale, b_qkv[d:].float()]))


def _head_dim(w_qkv, num_heads: int) -> int:
    return w_qkv.shape[0] // 3 // num_heads


def fused_mhsa_block_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, *, num_heads: int,
                           sm_scale: float | None = None, causal: bool = False,
                           prefix_len: int = 0, eps: float = 1e-6, partial: bool = False):
    """x + OutProj(MHA(LN(x))) in f32 math, rounded where the kernels round;
    the counterpart of ``_block_reference``. x: (B, L, D). With ``partial``
    (and b_o None) it is :func:`block_partial_plain`."""
    if sm_scale is None:
        sm_scale = _head_dim(w_qkv, num_heads) ** -0.5
    w, b = _folded(w_qkv, b_qkv, sm_scale)
    y = fe.layernorm_plain(x, ln_w, ln_b, eps)
    qkv = fe.linear_plain(y, w, b)
    o = fe.attention_plain(qkv, num_heads, causal=causal,
                           prefix_len=prefix_len if causal else 0, scale=1.0)
    return fe.linear_plain(o, w_o, b_o, residual=None if partial else x)


def fused_mhsa_block_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, g, *, num_heads: int,
                               sm_scale: float | None = None, causal: bool = False,
                               prefix_len: int = 0, eps: float = 1e-6):
    """(dx, dln_w, dln_b, dw_qkv, db_qkv, dw_o, db_o) of the block for the
    output gradient g, in f32 math with the roundings of ``_block_bwd_kernel``
    (openvision_tpu/ops/fused_attention.py:698-855) to x's dtype (the compute
    dtype): y; q (scaled after the bias), k and v; do = g . Wo; the
    normalized probabilities a for o = a v and dv = a^T do; ds for dq and dk;
    dq (times the scale), dk and dv before the products that consume them;
    each image's bias-gradient sum over dq, dk and dv. dx is in x's dtype,
    the weight grads in their weights' dtype, the rest f32
    (``fused_encoder.attn_block_bwd_plain``)."""
    return fe.attn_block_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, g,
                                   num_heads=num_heads, sm_scale=sm_scale, causal=causal,
                                   prefix_len=prefix_len, eps=eps)


def _qkv_scaled(y, w_qkv, b_qkv, num_heads: int, sm_scale, causal: bool, prefix_len: int):
    """The forward's QKV projection and attention with the softmax scale as
    the Pallas kernels fold it (see the module doc): a power of two scales q
    in the attention kernel, any other is folded into a copy of wq and bq."""
    sm_scale = _scale(w_qkv, num_heads, sm_scale)
    if math.frexp(sm_scale)[0] == 0.5:
        w, b, scale = w_qkv, b_qkv, sm_scale
    else:
        (w, b), scale = _folded(w_qkv, b_qkv, sm_scale), 1.0
    qkv = fe.gemm_bias_act(y, w, b)
    return fe.attention(qkv, num_heads, causal=causal, prefix_len=prefix_len if causal else 0,
                        scale=scale)


def _scale(w_qkv, num_heads: int, sm_scale):
    return _head_dim(w_qkv, num_heads) ** -0.5 if sm_scale is None else float(sm_scale)


def _recompute_qkv(y, w_qkv, b_qkv, sm_scale: float, mhsa_t: bool):
    """The backward recompute's QKV with q scaled as the Pallas backwards
    scale it after the bias: in f32 (``_block_bwd_kernel`` :742,
    ``_qkv_bwd_kernel`` :248), or on the rounded projection by the scale
    cast to bf16 (``_mhsa_t_bwd_kernel``, fused_encoder.py:278)."""
    d = w_qkv.shape[0] // 3
    if mhsa_t:
        scale_bf16 = kernels.cast_scalar(sm_scale, torch.bfloat16)
        return fe.gemm_bias_act(y, w_qkv, b_qkv, q_scale=scale_bf16, q_cols=d, q_round=True)
    return fe.gemm_bias_act(y, w_qkv, b_qkv, q_scale=sm_scale, q_cols=d)


def _dq_factor(sm_scale: float, mhsa_t: bool) -> dict:
    """dq's scale in the Pallas backwards: on the f32 sum (``_mhsa_t_bwd_kernel``
    :356) or on its bf16 rounding, by the scale cast to bf16
    (``_block_bwd_kernel`` :802, ``_qkv_bwd_kernel`` :295)."""
    if mhsa_t:
        return dict(dq_scale=sm_scale)
    return dict(dq_scale=kernels.cast_scalar(sm_scale, torch.bfloat16), dq_round=True)


def _forward_kernels(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, *, num_heads, sm_scale, causal,
                     prefix_len, eps, partial=False):
    """``_block_kernel`` as 4 launches: layernorm, QKV, attention (masked, q
    scaled by `sm_scale` or the scale folded), out-proj + residual;
    ``partial`` (a shard's weights, b_o None) ends in the out-proj alone,
    ``_block_partial_kernel``."""
    y = fe.layernorm(x, ln_w, ln_b, eps)
    o = _qkv_scaled(y, w_qkv, b_qkv, num_heads, sm_scale, causal, prefix_len)
    return fe.gemm_bias_act(o, w_o, b_o, residual=None if partial else x)


def _backward_kernels(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, g, *, num_heads, sm_scale, causal,
                      prefix_len, eps, nomax=False, mhsa_t=False, partial=False):
    """The backward on the card (see the module doc): 12 launches. The QKV
    recompute scales q (:func:`_recompute_qkv`), so the flash forward and
    ``attention_bwd`` run at scale 1 and dq takes the scale at its store. It
    also serves ``_mhsa_t_bwd_kernel`` (``fused_encoder.mhsa_block``'s
    backward, ``mhsa_t``: its orders of scaling q and dq, ``nomax``
    recomputes the probabilities as exp(min(s, 80)) / l, and the QKV bias
    gradient is summed in f32 over every row); and
    ``_block_partial_bwd_kernel`` with ``partial`` (a shard's rectangular
    weights): the LayerNorm backward adds no g and no db_o is summed, 11
    launches."""
    sm_scale = _scale(w_qkv, num_heads, sm_scale)
    b, l, _ = x.shape
    d = w_qkv.shape[0] // 3
    hd = d // num_heads
    prefix = prefix_len if causal else 0
    if w_qkv.dtype != torch.bfloat16 or w_o.dtype != torch.bfloat16:
        raise TypeError("fused_mhsa_block backward: the kernels take bf16 weights")
    y = fe.layernorm(x, ln_w, ln_b, eps)
    qkv = _recompute_qkv(y, w_qkv, b_qkv, sm_scale, mhsa_t)
    heads = [qkv[..., i * d:(i + 1) * d].view(b, l, num_heads, hd) for i in range(3)]
    o, lse = fl._forward(*heads, causal=causal, prefix_len=prefix, sm_scale=1.0,
                         return_lse=True, nomax=nomax)
    do = gk.gemm_nn(g, w_o)
    dqkv = torch.empty(b, l, 3 * d, dtype=torch.bfloat16, device=x.device)
    dq, dk, dv = (dqkv[..., i * d:(i + 1) * d].view(b, l, num_heads, hd) for i in range(3))
    gk.attention_bwd(*heads, o, lse, do.view(b, l, num_heads, hd), scale=1.0,
                     causal=causal, prefix_len=prefix, nomax=nomax, dq=dq, dk=dk, dv=dv,
                     **_dq_factor(sm_scale, mhsa_t))
    o = o.reshape(b, l, d)
    dw_o = gk.gemm_tn(g, o)
    dw_qkv = gk.gemm_tn(dqkv, y)
    dy = gk.gemm_nn(dqkv, w_qkv, torch.float32)
    dx, dvec = gk.layernorm_bwd(x, ln_w, dy, None if partial else g, eps=eps)
    # per-image sums (rounded to bf16 for #10 and #12), then their f32 sum
    db_qkv = gk.colsum(dqkv, seg_len=l, round_bf16=not mhsa_t)
    if partial:
        return dx, dvec[0], dvec[1], dw_qkv, db_qkv, dw_o
    db_o = gk.colsum(g, seg_len=l)
    return dx, dvec[0], dvec[1], dw_qkv, db_qkv, dw_o, db_o


class _FusedBlock(torch.autograd.Function):
    """The block with its backward; each pass takes the kernels on CUDA and
    the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, num_heads, sm_scale, causal,
                prefix_len, eps):
        kw = dict(num_heads=num_heads, sm_scale=sm_scale, causal=causal, prefix_len=prefix_len,
                  eps=eps)
        ctx.save_for_backward(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o)
        ctx.kw = kw
        if kernels.on_cpu(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o):
            return fused_mhsa_block_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, **kw)
        return _forward_kernels(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, **kw)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        g = g.contiguous()
        if kernels.on_cpu(*saved, g):
            grads = fused_mhsa_block_bwd_plain(*saved, g, **ctx.kw)
        else:
            grads = _backward_kernels(*saved, g, **ctx.kw)
        return (*grads, None, None, None, None, None)


def fused_mhsa_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, *, num_heads: int,
                     sm_scale: float | None = None, causal: bool = False,
                     prefix_len: int = 0, eps: float = 1e-6):
    """``_block_kernel`` as 4 launches: layernorm, QKV, attention (masked,
    q scaled by `sm_scale`), out-proj + residual. x: (B, L, D) bf16 on CUDA;
    on the CPU the plain version runs. A scale that is not a power of two
    is folded into a copy of the q weights, as Pallas folds it. When
    autograd records (grad enabled and an input requires grad) the call is
    differentiable through the backward of ``_block_bwd_kernel``."""
    kw = dict(num_heads=num_heads, sm_scale=sm_scale, causal=causal, prefix_len=prefix_len,
              eps=eps)
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedBlock.apply(*args, num_heads, sm_scale, causal, prefix_len, eps)
    if kernels.on_cpu(*args):
        return fused_mhsa_block_plain(*args, **kw)
    return _forward_kernels(*args, **kw)


# ---------------------------------------------------------------------------
# fused_qkv_attention: QKV projection + MHA (_kernel, _qkv_bwd_kernel)
# ---------------------------------------------------------------------------


def fused_qkv_attention_plain(y, w_qkv, b_qkv, *, num_heads: int,
                              sm_scale: float | None = None, causal: bool = False,
                              prefix_len: int = 0):
    """softmax(q k^T) v of the QKV projection of y, (B, L, D) in y's dtype:
    the counterpart of ``_reference`` (:185-198) in ``_kernel``'s roundings
    (:92-143): q, k, v rounded to the compute dtype after the bias (q with
    the folded scale), f32 scores, the masked max-subtracted softmax with a
    row sum of 0 taken as 1, p rounded for p.v, then divided by l."""
    if sm_scale is None:
        sm_scale = _head_dim(w_qkv, num_heads) ** -0.5
    w, b = _folded(w_qkv, b_qkv, sm_scale)
    qkv = fe.linear_plain(y, w, b)
    return fe.attention_plain(qkv, num_heads, causal=causal,
                              prefix_len=prefix_len if causal else 0, scale=1.0)


def fused_qkv_attention_bwd_plain(y, w_qkv, b_qkv, g, *, num_heads: int,
                                  sm_scale: float | None = None, causal: bool = False,
                                  prefix_len: int = 0):
    """(dy, dw_qkv, db_qkv) for the output gradient g (B, L, D), in the
    roundings of ``_qkv_bwd_kernel`` (:215-329): q (times the scale), k, v
    and do = g rounded to the compute dtype, the attention gradients of
    ``fused_encoder.attention_grads_plain``; dy = dqkv . W_qkv in f32,
    returned in y's dtype (:377-379); dW_qkv = dqkv^T y in f32, returned in
    the weight's dtype; db_qkv each image's sum of the rounded dq, dk, dv in
    the compute dtype, then f32 (:313-320)."""
    cdt = y.dtype

    def r(t):
        return t.to(cdt).float()

    b, l, _ = y.shape
    d = w_qkv.shape[0] // 3  # D, or D/t on a tensor shard
    hd = d // num_heads
    scale = hd ** -0.5 if sm_scale is None else sm_scale
    yf = y.float()
    qkv = yf @ w_qkv.float().t() + b_qkv.float()
    heads = lambda t: t.reshape(b, l, num_heads, hd)
    q = heads(r(qkv[..., :d] * scale))
    k, v = heads(r(qkv[..., d:2 * d])), heads(r(qkv[..., 2 * d:]))
    _, dq, dk, dv = fe.attention_grads_plain(q, k, v, heads(g.to(cdt)), scale=scale,
                                             causal=causal, prefix_len=prefix_len,
                                             dq_round=True)
    dqkv = torch.cat([t.reshape(b, l, d) for t in (dq, dk, dv)], dim=-1)
    dy = (dqkv @ w_qkv.float()).to(cdt)
    dw_qkv = (dqkv.reshape(-1, 3 * d).t() @ yf.reshape(-1, y.shape[-1])).to(w_qkv.dtype)
    return dy, dw_qkv, r(dqkv.sum(1)).sum(0)


def _qkv_forward_kernels(y, w_qkv, b_qkv, *, num_heads, sm_scale, causal, prefix_len):
    """``_kernel`` as 2 launches: the QKV gemm_bias_act and the attention
    kernel (masked; a power-of-two `sm_scale` scales q in the kernel, the
    bits of the folded weights, as the module doc argues; any other is
    folded)."""
    return _qkv_scaled(y, w_qkv, b_qkv, num_heads, sm_scale, causal, prefix_len)


def _qkv_backward_kernels(y, w_qkv, b_qkv, g, *, num_heads, sm_scale, causal, prefix_len):
    """``_qkv_bwd_kernel`` on the card: 7 launches. The QKV projection and
    the flash forward (o and its logsumexp) recompute the forward;
    ``attention_bwd`` writes dq (times the scale), dk and dv into one dqkv
    buffer; ``gemm_tn`` gives dW_qkv = dqkv^T y, ``gemm_nn`` dy = dqkv . W_qkv
    in y's dtype, ``colsum`` each image's bias sums, rounded, then f32."""
    sm_scale = _scale(w_qkv, num_heads, sm_scale)
    b, l, _ = y.shape
    d = w_qkv.shape[0] // 3
    hd = d // num_heads
    prefix = prefix_len if causal else 0
    if w_qkv.dtype != torch.bfloat16:
        raise TypeError("fused_qkv_attention backward: the kernels take bf16 weights")
    qkv = _recompute_qkv(y, w_qkv, b_qkv, sm_scale, False)
    heads = [qkv[..., i * d:(i + 1) * d].view(b, l, num_heads, hd) for i in range(3)]
    o, lse = fl._forward(*heads, causal=causal, prefix_len=prefix, sm_scale=1.0,
                         return_lse=True)
    dqkv = torch.empty(b, l, 3 * d, dtype=torch.bfloat16, device=y.device)
    dq, dk, dv = (dqkv[..., i * d:(i + 1) * d].view(b, l, num_heads, hd) for i in range(3))
    gk.attention_bwd(*heads, o, lse, g.view(b, l, num_heads, hd), scale=1.0,
                     causal=causal, prefix_len=prefix, dq=dq, dk=dk, dv=dv,
                     **_dq_factor(sm_scale, False))
    dw_qkv = gk.gemm_tn(dqkv, y)
    dy = gk.gemm_nn(dqkv, w_qkv)
    return dy, dw_qkv, gk.colsum(dqkv, seg_len=l, round_bf16=True)


class _FusedQKV(torch.autograd.Function):
    """fused_qkv_attention with the backward of ``_qkv_bwd_kernel``."""

    @staticmethod
    def forward(ctx, y, w_qkv, b_qkv, num_heads, sm_scale, causal, prefix_len):
        kw = dict(num_heads=num_heads, sm_scale=sm_scale, causal=causal, prefix_len=prefix_len)
        ctx.save_for_backward(y, w_qkv, b_qkv)
        ctx.kw = kw
        if kernels.on_cpu(y, w_qkv, b_qkv):
            return fused_qkv_attention_plain(y, w_qkv, b_qkv, **kw)
        return _qkv_forward_kernels(y, w_qkv, b_qkv, **kw)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        g = g.contiguous()
        if kernels.on_cpu(*saved, g):
            grads = fused_qkv_attention_bwd_plain(*saved, g, **ctx.kw)
        else:
            grads = _qkv_backward_kernels(*saved, g, **ctx.kw)
        return (*grads, None, None, None, None)


def fused_qkv_attention(y, w_qkv, b_qkv, *, num_heads: int, sm_scale: float | None = None,
                        causal: bool = False, prefix_len: int = 0):
    """QKV projection + multi-head attention, the Pallas ``_kernel``
    (openvision_tpu/ops/fused_attention.py:92, via ``fused_qkv_attention``
    :391): the pre-out-projection attention output (B, L, D) of y (B, L, D).
    ``w_qkv`` (3D, D) is the query, key and value kernels transposed and
    stacked (torch's (out, in) layout), ``b_qkv`` (3D,) f32. Masks: none,
    causal, prefix-LM (key j visible to query i iff j <= max(i, prefix - 1)).
    On CUDA (bf16) 2 launches; on the CPU the plain version. When autograd
    records, the call is differentiable through the backward of
    ``_qkv_bwd_kernel`` (:215). A scale that is not a power of two is
    folded, as for :func:`fused_mhsa_block`."""
    kw = dict(num_heads=num_heads, sm_scale=sm_scale, causal=causal, prefix_len=prefix_len)
    args = (y, w_qkv, b_qkv)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedQKV.apply(*args, num_heads, sm_scale, causal, prefix_len)
    if kernels.on_cpu(*args):
        return fused_qkv_attention_plain(*args, **kw)
    return _qkv_forward_kernels(*args, **kw)


# ---------------------------------------------------------------------------
# Tensor parallelism: heads sharded over the mesh's tensor axis
# (_block_partial_kernel, _block_partial_bwd_kernel, _tp_block, _tp_qkv)
# ---------------------------------------------------------------------------


def block_partial_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, *, num_heads: int,
                        sm_scale: float | None = None, causal: bool = False,
                        prefix_len: int = 0, eps: float = 1e-6):
    """One tensor shard's OutProj_local(MHA_local(LN(x))), no residual and no
    bo, in f32 math with the roundings of ``_block_partial_kernel``
    (openvision_tpu/ops/fused_attention.py:938; twin of
    ``_block_partial_reference`` :1034): y, q (the folded scale), k, v and o
    rounded to x's dtype, the masked max-subtracted softmax with a row sum
    of 0 taken as 1, the out-projection summed in f32 and rounded once.
    x (B, L, D); w_qkv (3 D/t, D) the shard's q|k|v rows; b_qkv (3 D/t,)
    f32; w_o (D, D/t); num_heads the shard's heads (num_heads / t)."""
    return fused_mhsa_block_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, None, num_heads=num_heads,
                                  sm_scale=sm_scale, causal=causal, prefix_len=prefix_len,
                                  eps=eps, partial=True)


def block_partial_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, *, num_heads: int,
                            sm_scale: float | None = None, causal: bool = False,
                            prefix_len: int = 0, eps: float = 1e-6):
    """(dx, dln_w, dln_b, dw_qkv, db_qkv, dw_o) of :func:`block_partial_plain`
    for the output gradient g, in the roundings of
    ``_block_partial_bwd_kernel`` (:1057-1196): the #10 backward's
    (:func:`fused_mhsa_block_bwd_plain`) on the shard's heads, with the
    max-subtracted recompute, dx the LayerNorm path's alone (the caller sums
    it over tensor and adds g) and no db_o. The weight grads come in their
    weights' dtype (the f32 sums rounded once, the wrapper's cast
    :1303-1306), the LayerNorm and bias grads in f32; the bias grads sum
    each image's rounded dq, dk, dv (Pallas sums a bf16 array per grid
    step, :1186-1190)."""
    return fe.attn_block_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, None, g,
                                   num_heads=num_heads, sm_scale=sm_scale, causal=causal,
                                   prefix_len=prefix_len, eps=eps, partial=True)


def block_partial(x, ln_w, ln_b, w_qkv, b_qkv, w_o, *, num_heads: int,
                  sm_scale: float | None = None, causal: bool = False, prefix_len: int = 0,
                  eps: float = 1e-6):
    """``_block_partial_kernel`` (#11) on the card: 4 launches, layernorm ->
    QKV ``gemm_bias_act`` with the shard's (3 D/t, D) weight -> the
    ``attention`` kernel over the shard's heads (q scaled by the power-of-two
    scale) -> the out-projection ``gemm_bias_act`` with K = D/t, no bias and
    no residual (bf16 out). On the CPU the plain version runs."""
    kw = dict(num_heads=num_heads, sm_scale=sm_scale, causal=causal, prefix_len=prefix_len,
              eps=eps)
    if kernels.on_cpu(x, ln_w, ln_b, w_qkv, b_qkv, w_o):
        return block_partial_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, **kw)
    return _forward_kernels(x, ln_w, ln_b, w_qkv, b_qkv, w_o, None, partial=True, **kw)


def block_partial_bwd(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, *, num_heads: int,
                      sm_scale: float | None = None, causal: bool = False, prefix_len: int = 0,
                      eps: float = 1e-6):
    """``_block_partial_bwd_kernel`` (#12) on the card: #10's chain on the
    shard's rectangular weights in 11 launches (layernorm, QKV, the flash
    forward with its logsumexp, do = g . Wo, ``attention_bwd`` dq and dk/dv,
    two ``gemm_tn``, dy = dqkv . W_qkv in f32, ``layernorm_bwd`` without g,
    one ``colsum``). Returns what :func:`block_partial_bwd_plain` returns;
    on the CPU the plain version runs."""
    kw = dict(num_heads=num_heads, sm_scale=sm_scale, causal=causal, prefix_len=prefix_len,
              eps=eps)
    if kernels.on_cpu(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g):
        return block_partial_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, g, **kw)
    return _backward_kernels(x, ln_w, ln_b, w_qkv, b_qkv, w_o, None, g, partial=True, **kw)


def _tp_info(num_heads: int):
    """(mesh, t) when head-sharded tensor parallelism applies (``_tp_info``
    :924-935: an active mesh with tensor > 1 that divides the heads), else None."""
    mesh = active_mesh()
    if mesh is None or mesh.tensor <= 1 or num_heads % mesh.tensor:
        return None
    return mesh, mesh.tensor


class _TPBlock(torch.autograd.Function):
    """``_tp_block`` (:1253-1333): the shard's #11, the bf16 partials summed
    over tensor, then x + out + bo (two roundings, :1274); the backward runs
    #12 on the shard's heads, sums dx over tensor and adds g, sums the
    LayerNorm grads over tensor, and forms dbo = sum g in f32, rounded to g's
    dtype (:1329). The sums over the batch axes (the weight, bias and
    LayerNorm grads of every rank's rows) are the step's gradient reduction,
    which sums every parameter's gradient over data x fsdp once."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, mesh, kw):
        ctx.save_for_backward(x, ln_w, ln_b, w_qkv, b_qkv, w_o)
        ctx.mesh, ctx.kw = mesh, kw
        part = block_partial(x, ln_w, ln_b, w_qkv, b_qkv, w_o, **kw)
        return (x + all_reduce(part, mesh.tensor_group)) + b_o

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        g = g.contiguous()
        dx, dln_w, dln_b, dw_qkv, db_qkv, dw_o = block_partial_bwd(*saved, g, **ctx.kw)
        group = ctx.mesh.tensor_group
        dln = all_reduce(torch.stack([dln_w, dln_b]), group)
        dbo = g.float().sum((0, 1)).to(g.dtype)
        return g + all_reduce(dx, group), dln[0], dln[1], dw_qkv, db_qkv, dw_o, dbo, None, None


def fused_mhsa_block_tp(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, *, num_heads: int,
                        sm_scale: float | None = None, causal: bool = False,
                        prefix_len: int = 0, eps: float = 1e-6):
    """Tensor-parallel x + OutProj(MHA(LN(x))) with the heads sharded over
    the active mesh's tensor axis (JAX :1336-1364): None when that does not
    apply (no mesh, tensor 1, or heads that tensor does not divide), so the
    caller runs :func:`fused_mhsa_block` on its batch rows.

    x (B, L, D) is this rank's batch rows; w_qkv (3 D/t, D), b_qkv (3 D/t,)
    and w_o (D, D/t) its shard (the q, k, v rows of its heads, the matching
    columns of the out-projection); num_heads the model's (all shards').
    b_o is taken in x's dtype, as the JAX wrapper casts it. Differentiable
    when autograd records (``_TPBlock``)."""
    info = _tp_info(num_heads)
    if info is None:
        return None
    mesh, t = info
    d = x.shape[-1]
    if tuple(w_qkv.shape) != (3 * d // t, d) or tuple(w_o.shape) != (d, d // t):
        raise ValueError(f"fused_mhsa_block_tp: tensor={t} takes the shard's weights, w_qkv "
                         f"({3 * d // t}, {d}) and w_o ({d}, {d // t}); got "
                         f"{tuple(w_qkv.shape)} and {tuple(w_o.shape)}")
    kw = dict(num_heads=num_heads // t, sm_scale=(d // num_heads) ** -0.5 if sm_scale is None
              else sm_scale, causal=causal, prefix_len=prefix_len if causal else 0, eps=eps)
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o.to(x.dtype))
    return _TPBlock.apply(*args, mesh, kw)


def fused_qkv_attention_tp(y, w_qkv, b_qkv, *, num_heads: int, sm_scale: float | None = None,
                           causal: bool = False, prefix_len: int = 0):
    """``_tp_qkv`` (:1376-1439): :func:`fused_qkv_attention` (#7, and #8
    under autograd) on this shard's heads, the shard's columns of the
    attention output (B, L, D/t) in head order; y's gradient is summed over
    tensor (``parallel.copy_to_tensor``), the weight grads stay the shard's.
    None when tensor parallelism does not apply (see
    :func:`fused_mhsa_block_tp`)."""
    info = _tp_info(num_heads)
    if info is None:
        return None
    mesh, t = info
    d = y.shape[-1]
    return fused_qkv_attention(
        copy_to_tensor(y, mesh), w_qkv, b_qkv, num_heads=num_heads // t,
        sm_scale=(d // num_heads) ** -0.5 if sm_scale is None else sm_scale, causal=causal,
        prefix_len=prefix_len)
