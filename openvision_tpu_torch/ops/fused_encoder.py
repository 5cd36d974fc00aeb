"""The encoder block's two sub-blocks on hand-written Hopper kernels.

Counterpart of ``openvision_tpu/ops/fused_encoder.py``, whose two Pallas
kernels compute one pre-LN ViT block on the TPU:

- ``_mhsa_t_kernel`` (:71): LN1 -> QKV + bias -> softmax attention ->
  out-proj + bo -> residual;
- ``_mlp_t_kernel`` (:502): LN2 -> fc1 + b1 -> tanh-GELU -> fc2 + b2 ->
  residual.

What they compute is ``_tblock_reference`` (:782) in the natural
``(B, 1+P, D)`` layout with the cls token first. The transposed
``(B, D, Ppad)`` stream, the cls row split out to XLA, the 128-lane padding
and two images per grid step exist for TPU tiling and are not carried over.
Here the two sub-blocks run as three CUDA kernels (``csrc/``):

- :func:`layernorm` -- row LayerNorm, f32 statistics;
- :func:`gemm_bias_act` -- ``A . W^T + b`` with optional tanh-GELU and
  residual in the epilogue; it serves QKV, out-proj + residual, fc1 + GELU
  and fc2 + residual;
- :func:`attention` -- online-softmax attention straight off the QKV buffer.

Each has a plain PyTorch version beside it (``*_plain``, f32 math) and a
launch counter in ``kernels.LAUNCHES``. A wrapper takes the plain version only
for tensors on the CPU; for CUDA tensors it launches its kernel or raises.
The forward's bf16 4D MLP hidden goes through device memory (fc2's
accumulator for a 128-row tile would be 128 x D f32, far past a block's
shared memory and registers), where the Pallas kernel keeps it in VMEM.

Under autograd each sub-block is a ``torch.autograd.Function``, the
counterpart of the JAX custom VJPs ``_mhsa_t`` (:466-494) and ``_mlp_t``
(:699-717): the forward saves x and the parameters only, and the backward
recomputes the forward from x, as the Pallas backwards do:

- ``_mhsa_t_bwd_kernel`` (:215-417) is the natural-layout block backward of
  ``ops/fused_attention.py`` (12 launches) with the ``nomax`` recompute of
  the probabilities (flash forward and ``attention_bwd``) and the QKV bias
  gradient summed in f32 over every row (:388-389);
- ``_mlp_t_bwd_kernel`` (:593-662) is 8 launches: layernorm,
  ``mlp_bwd_dual`` (the fc1 recompute h = y W1^T + b1 and dh = (g . W2)
  gelu'(h) as two accumulators of one kernel: gact and dh in bf16, f32
  column partials; the f32 h stays in registers), ``gemm_tn`` (dW2 =
  g^T gact), ``gemm_tn`` (dW1 = dh^T y), ``gemm_nn`` (dy = dh . W1, f32),
  ``layernorm_bwd`` (dx + g and the LN grads) and two ``colsum`` (db1 from
  the partials, db2 from g).

:func:`mhsa_block_bwd_plain` and :func:`mlp_block_bwd_plain` follow the
Pallas kernels' roundings. The cls row, which the transposed stream splits
out to XLA (:740-779), is one more row here, as in the forward. Weight
gradients come back in the weights' dtype (the f32 sums rounded once), the
LayerNorm and bias gradients in f32, dx in x's dtype.
"""

from __future__ import annotations

import torch

from openvision_tpu_torch.ops import grad_kernels as gk
from openvision_tpu_torch.ops import kernels


def _gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h * h * h)))


# ---------------------------------------------------------------------------
# layernorm
# ---------------------------------------------------------------------------


def layernorm_plain(x, weight, bias, eps: float):
    """LayerNorm over the last dim with f32 statistics; output in x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def layernorm(x, weight, bias, eps: float):
    """Kernel ``csrc/layernorm.cu``: bf16 x, f32 weight and bias, bf16 out.

    Replaces the LN prologue of ``_mhsa_t_kernel`` and ``_mlp_t_kernel``
    (openvision_tpu/ops/fused_encoder.py:91-95, :525-529). Bound by device
    memory (one read, one write of x): a persistent row stream, tiles of 16
    rows brought into a shared-memory ring by bulk copies, one warp a row
    computing from registers and storing 16 bytes a lane. Takes a width
    divisible by 8 and at most 2048.
    """
    if kernels.on_cpu(x, weight, bias):
        return layernorm_plain(x, weight, bias, eps)
    d = x.shape[-1]
    if d % 8 or d > 2048:
        raise ValueError(f"layernorm: the kernel takes a width divisible by 8 and at most 2048, "
                         f"got {d}")
    kernels.check_operand("layernorm x", x, torch.bfloat16)
    kernels.check_operand("layernorm weight", weight, torch.float32, (d,))
    kernels.check_operand("layernorm bias", bias, torch.float32, (d,))
    y = torch.empty_like(x)
    rc = kernels.lib().ovt_layernorm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        x.numel() // d, d, eps, kernels.stream(x))
    kernels.raise_on(rc, "layernorm")
    kernels.count("layernorm")
    return y


# ---------------------------------------------------------------------------
# gemm_bias_act
# ---------------------------------------------------------------------------


def linear_plain(x, weight, bias=None, *, gelu: bool = False, residual=None):
    """``x . weight^T + bias`` in f32 math, optional tanh-GELU, rounded to
    x.dtype, then optional ``+ residual`` rounded again (the Pallas kernels
    add the residual to the rounded projection)."""
    h = x.float() @ weight.float().t()
    if bias is not None:
        h = h + bias.float()
    y = (_gelu_tanh(h) if gelu else h).to(x.dtype)
    if residual is not None:
        y = (y.float() + residual.float()).to(x.dtype)
    return y


def gemm_bias_act(x, weight, bias=None, *, gelu: bool = False, residual=None):
    """Kernel ``csrc/gemm_bias_act.cu``: the projections of both sub-blocks.

    x: (..., K) bf16; weight: (N, K) bf16 in torch's (out, in) layout;
    bias: (N,) f32 or None; residual: x-shaped (..., N) bf16 or None.
    Replaces the in-kernel products of ``_mhsa_t_kernel`` (QKV :98-101,
    out-proj :162-168) and ``_mlp_t_kernel`` (fc1 :535-542, fc2 :543-550).
    Bound by the tensor cores at ViT shapes: the warp-specialised,
    persistent TMA + wgmma mainloop of ``csrc/hopper.cuh``, epilogue fused.
    """
    if kernels.on_cpu(x, weight, bias, residual):
        return linear_plain(x, weight, bias, gelu=gelu, residual=residual)
    n, k = weight.shape
    if n % 8 or k % 8:
        raise ValueError(f"gemm_bias_act: N and K must be multiples of 8, got N={n} K={k}")
    if x.shape[-1] != k:
        raise ValueError(f"gemm_bias_act: x has K={x.shape[-1]}, weight has K={k}")
    m = x.numel() // k
    kernels.check_operand("gemm x", x, torch.bfloat16)
    kernels.check_operand("gemm weight", weight, torch.bfloat16)
    if bias is not None:
        kernels.check_operand("gemm bias", bias, torch.float32, (n,))
    out = torch.empty(*x.shape[:-1], n, dtype=torch.bfloat16, device=x.device)
    if residual is not None:
        kernels.check_operand("gemm residual", residual, torch.bfloat16, out.shape)
    rc = kernels.lib().ovt_gemm_bias_act(
        x.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        out.data_ptr(), m, n, k, int(gelu), kernels.stream(x))
    kernels.raise_on(rc, "gemm_bias_act")
    kernels.count("gemm_bias_act")
    return out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attend_plain(q, k, v, *, scale: float, prescale: bool = True, causal: bool = False,
                 prefix_len: int = 0, nomax: bool = False, out_dtype=None):
    """softmax(q k^T) v over (B, L, H, hd) tensors -> (o, lse), the arithmetic
    of the attention kernel (``csrc/attention.cu``) in f32.

    ``prescale`` scales q and rounds it to the input dtype before q.k^T (the
    order of ``_mhsa_t_kernel`` and the single-k flash kernel); otherwise the
    f32 scores are scaled (the multi-k flash kernel). Key j is visible to
    query i iff j <= max(i, prefix_len - 1) when causal. The probabilities
    are rounded to the input dtype for p.v, then divided by their f32 row sum
    (1 where a row sees no key); ``nomax`` takes exp(min(s, 80)) with no max
    subtraction. lse = m + log(l), (B, H, Lq) f32, is the logsumexp of the
    scores (meaningless under nomax). o comes in `out_dtype` (the input
    dtype by default; f32 leaves it unrounded).
    """
    dt = q.dtype
    if prescale:
        s = torch.einsum("bqhd,bkhd->bhqk", (q.float() * scale).to(dt).float(), k.float())
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lq, lk = s.shape[-2:]
    if causal:
        rows = torch.arange(lq, device=s.device)[:, None]
        cols = torch.arange(lk, device=s.device)[None, :]
        s = s.masked_fill(cols > torch.clamp(rows, min=prefix_len - 1), float("-inf"))
    if nomax:
        m = torch.zeros_like(s[..., :1])
        p = torch.exp(torch.clamp(s, max=80.0))
    else:
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l <= 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), v.float())
    o = o / l.squeeze(-1).transpose(1, 2)[..., None]
    return o.to(out_dtype or dt), (m + torch.log(l)).squeeze(-1)


def _split_qkv(qkv, num_heads: int):
    b, l, d3 = qkv.shape
    d = d3 // 3
    return (t.reshape(b, l, num_heads, d // num_heads) for t in qkv.split(d, dim=-1))


def attention_plain(qkv, num_heads: int, *, nomax: bool = False, causal: bool = False,
                    prefix_len: int = 0, scale: float | None = None, out_dtype=None):
    """softmax(q k^T) v from a (B, L, 3D) QKV buffer -> (B, L, D).

    As the Pallas kernels: q scaled (by head_dim**-0.5 unless `scale` is
    given) and rounded to the input dtype, f32 scores, the causal or
    prefix-LM mask, unnormalized probabilities rounded to the input dtype
    for p.v, then divided by their f32 row sum; ``nomax`` takes
    exp(min(s, 80)) with no max subtraction. The output comes in
    `out_dtype`, by default the input dtype.
    """
    b, l, d3 = qkv.shape
    q, k, v = _split_qkv(qkv, num_heads)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    o, _ = attend_plain(q, k, v, scale=scale, causal=causal, prefix_len=prefix_len,
                        nomax=nomax, out_dtype=out_dtype)
    return o.reshape(b, l, d3 // 3)


def attention(qkv, num_heads: int, *, nomax: bool = False, causal: bool = False,
              prefix_len: int = 0, scale: float | None = None, out_dtype=None):
    """Kernel ``csrc/attention.cu``: the attention core of ``_mhsa_t_kernel``
    and of ``_block_kernel`` (openvision_tpu/ops/fused_attention.py:440).

    qkv: (B, L, 3D) bf16 from the QKV projection; returns (B, L, D) in
    `out_dtype`: qkv's dtype by default, or f32 (unmasked only) for
    ``_mhsa_t_int8_kernel``, which quantises the unrounded o / l
    (fused_encoder_int8.py:112-126).
    Replaces openvision_tpu/ops/fused_encoder.py:106-154 (per-head scores,
    ``valid`` key mask, max or ``nomax`` softmax, p.v) and the causal and
    prefix-LM masks of ``_tvalid`` (fused_attention.py:64). One block per
    (batch, head, 64-query tile), online softmax over 64-key tiles in
    registers, keys past L and masked keys dropped, key tiles no query of the
    block sees skipped; reads q, k, v by stride, no permutes. head_dim must
    be 64.
    """
    if kernels.on_cpu(qkv):
        return attention_plain(qkv, num_heads, nomax=nomax, causal=causal,
                               prefix_len=prefix_len, scale=scale, out_dtype=out_dtype)
    b, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    if d3 % 3 or d % num_heads or hd != 64:
        raise ValueError(
            f"attention: the kernel takes head_dim 64, got width {d} over {num_heads} heads")
    kernels.check_operand("attention qkv", qkv, torch.bfloat16)
    if l * d3 >= 2**31:
        raise ValueError("attention: one batch item must hold fewer than 2**31 elements")
    out_dtype = out_dtype or torch.bfloat16
    if out_dtype not in (torch.bfloat16, torch.float32) or (out_dtype == torch.float32 and causal):
        raise ValueError(f"attention: the kernel writes bf16, or f32 unmasked; got {out_dtype}"
                         f"{' with a causal mask' if causal else ''}")
    out = torch.empty(b, l, d, dtype=out_dtype, device=qkv.device)
    rc = kernels.lib().ovt_attention(
        qkv.data_ptr(), out.data_ptr(), b, l, num_heads, hd,
        hd ** -0.5 if scale is None else scale, int(nomax), int(causal),
        int(prefix_len) if causal else 0, int(out_dtype == torch.float32), kernels.stream(qkv))
    kernels.raise_on(rc, "attention")
    kernels.count("attention")
    return out


# ---------------------------------------------------------------------------
# The two sub-blocks
# ---------------------------------------------------------------------------


def mhsa_block_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, *, num_heads: int,
                     eps: float = 1e-6, nomax: bool = False):
    """x + OutProj(MHA(LN(x))): the attention half of ``_tblock_reference``."""
    y = layernorm_plain(x, ln_w, ln_b, eps)
    qkv = linear_plain(y, w_qkv, b_qkv)
    o = attention_plain(qkv, num_heads, nomax=nomax)
    return linear_plain(o, w_o, b_o, residual=x)


def mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, *, eps: float = 1e-6):
    """x + fc2(tanh-GELU(fc1(LN(x)))): the MLP half of ``_tblock_reference``."""
    y = layernorm_plain(x, ln_w, ln_b, eps)
    h = linear_plain(y, w1, b1, gelu=True)
    return linear_plain(h, w2, b2, residual=x)


def attention_grads_plain(q, k, v, do, *, scale: float, causal: bool = False,
                          prefix_len: int = 0, nomax: bool = False):
    """(o, dq, dk, dv) of softmax attention over (B, L, H, hd) tensors whose
    values are those of the compute dtype, do's dtype, in the order of the
    Pallas backward kernels (``_mhsa_t_bwd_kernel``
    fused_encoder.py:285-365, ``_block_bwd_kernel`` fused_attention.py:755-
    804, ``_qkv_bwd_kernel`` :270-300): q arrives scaled, f32 scores, the
    max-subtracted (or ``nomax``: exp(min(s, 80))) softmax a = p / l, its
    rounding ab for o = ab v and dv = ab^T do, ds = a (dp - rowsum(dp a))
    rounded for dq = ds k (rounded, then times `scale`) and dk = ds^T q.
    Every output is rounded to do's dtype and returned in f32."""
    dt = do.dtype

    def r(t):
        return t.to(dt).float()

    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    lq, lk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        rows = torch.arange(lq, device=s.device)[:, None]
        cols = torch.arange(lk, device=s.device)[None, :]
        s = s.masked_fill(cols > torch.clamp(rows, min=prefix_len - 1), float("-inf"))
    if nomax:
        p = torch.exp(torch.clamp(s, max=80.0))
    else:
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    lsum = p.sum(-1, keepdim=True)
    a = p / torch.where(lsum <= 0, torch.ones_like(lsum), lsum)
    ab = r(a)
    o = r(torch.einsum("bhqk,bkhd->bqhd", ab, v))
    dv = r(torch.einsum("bhqk,bqhd->bkhd", ab, do))
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = r(a * (dp - (dp * a).sum(-1, keepdim=True)))
    dq = r(torch.einsum("bhqk,bkhd->bqhd", ds, k)) * scale
    dk = r(torch.einsum("bhqk,bqhd->bkhd", ds, q))
    return o, dq, dk, dv


def attn_block_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, g, *, num_heads: int,
                         sm_scale: float | None = None, causal: bool = False,
                         prefix_len: int = 0, eps: float = 1e-6, nomax: bool = False,
                         bias_sum_per_image: bool = True, partial: bool = False):
    """(dx, dln_w, dln_b, dw_qkv, db_qkv, dw_o, db_o) of x + OutProj(MHA(LN(x)))
    for the output gradient g, in f32 math with the Pallas backwards'
    roundings to x's dtype (the compute dtype): y; q (scaled after the bias),
    k and v; do = g . Wo; then :func:`attention_grads_plain`. The QKV bias
    gradient sums the rounded dq, dk, dv per image in the compute dtype,
    then in f32 (``_block_bwd_kernel``, ``bias_sum_per_image``), or in f32
    over every row (``_mhsa_t_bwd_kernel`` :388-389). dx is in x's dtype, the
    weight grads in their weights' dtype, the rest f32.

    The weights may be one tensor shard's (``w_qkv`` (3 D/t, D) over
    num_heads/t heads, ``w_o`` (D, D/t)). ``partial`` is the backward of
    the shard's partial block OutProj(MHA(LN(x))) with no residual and no
    bo (``_block_partial_bwd_kernel``, fused_attention.py:1057): dx is the
    LayerNorm path's alone and no db_o is returned."""
    cdt = x.dtype

    def r(t):
        return t.to(cdt).float()

    b, l, _ = x.shape
    d = w_qkv.shape[0] // 3  # the q (and k, v) width: D, or D/t on a shard
    hd = d // num_heads
    scale = hd ** -0.5 if sm_scale is None else sm_scale
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    y = r(xhat * ln_w.float() + ln_b.float())
    qkv = y @ w_qkv.float().t() + b_qkv.float()
    heads = lambda t: t.reshape(b, l, num_heads, hd)
    q = heads(r(qkv[..., :d] * scale))
    k, v = heads(r(qkv[..., d:2 * d])), heads(r(qkv[..., 2 * d:]))
    gf = g.float()
    do = heads((gf @ w_o.float()).to(cdt))
    o, dq, dk, dv = attention_grads_plain(q, k, v, do, scale=scale, causal=causal,
                                          prefix_len=prefix_len, nomax=nomax)
    o = o.reshape(b, l, d)
    dqkv = torch.cat([t.reshape(b, l, d) for t in (dq, dk, dv)], dim=-1)

    width = x.shape[-1]
    dw_o = (gf.reshape(-1, width).t() @ o.reshape(-1, d)).to(w_o.dtype)
    dw_qkv = (dqkv.reshape(-1, 3 * d).t() @ y.reshape(-1, width)).to(w_qkv.dtype)
    dy = dqkv @ w_qkv.float()
    dxhat = dy * ln_w.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    db_qkv = r(dqkv.sum(1)).sum(0) if bias_sum_per_image else dqkv.sum((0, 1))
    grads = ((dx if partial else gf + dx).to(x.dtype), (dy * xhat).sum((0, 1)), dy.sum((0, 1)),
             dw_qkv, db_qkv, dw_o)
    return grads if partial else (*grads, gf.sum((0, 1)))


def mhsa_block_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, g, *, num_heads: int,
                         eps: float = 1e-6, nomax: bool = False):
    """The gradients of :func:`mhsa_block` (x, ln_w, ln_b, w_qkv, b_qkv, w_o,
    b_o order) in the roundings of ``_mhsa_t_bwd_kernel`` (:215-417): o and
    dq/dk/dv rounded to the compute dtype, dq times the scale, the QKV bias
    gradient summed in f32 from the rounded dqkv, the LayerNorm backward in
    f32. Under ``nomax`` the probabilities are exp(min(s, 80)) / l and the
    softmax backward is the plain one (:337-338, no derivative of the clamp)."""
    return attn_block_bwd_plain(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, g, num_heads=num_heads,
                                eps=eps, nomax=nomax, bias_sum_per_image=False)


def mlp_block_bwd_plain(x, ln_w, ln_b, w1, b1, w2, b2, g, *, eps: float = 1e-6):
    """The gradients of :func:`mlp_block` (x, ln_w, ln_b, w1, b1, w2, b2
    order) in the roundings of ``_mlp_t_bwd_kernel`` (:593-662): h = y W1 + b1
    and t = tanh(...) in f32, gact = bf16(0.5 h (1 + t)); dgact = g W2 and
    dh = dgact gelu'(h) in f32; db1 = sum dh in f32; dhb = bf16(dh) for dW1
    and dy; db2 = sum g; dx = g + the LayerNorm backward of dy."""
    cdt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    y = (xhat * ln_w.float() + ln_b.float()).to(cdt).float()
    gact, dhb, col = gk.mlp_bwd_dual_plain(y.to(cdt), w1, b1, g, w2)
    gf = g.float()
    rows = lambda t: t.reshape(-1, t.shape[-1])
    dw2 = (rows(gf).t() @ rows(gact.float())).to(w2.dtype)
    dhb = dhb.float()
    dw1 = (rows(dhb).t() @ rows(y)).to(w1.dtype)
    dy = dhb @ w1.float()
    dxhat = dy * ln_w.float()
    dx = gf + rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                      - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (dx.to(cdt), rows(dy * xhat).sum(0), rows(dy).sum(0), dw1, col.sum(0), dw2,
            rows(gf).sum(0))


def _mlp_backward_kernels(x, ln_w, ln_b, w1, b1, w2, b2, g, *, eps: float):
    """``_mlp_t_bwd_kernel`` on the card: 8 launches (see the module doc)."""
    if w1.dtype != torch.bfloat16 or w2.dtype != torch.bfloat16:
        raise TypeError("mlp_block backward: the kernels take bf16 weights")
    y = layernorm(x, ln_w, ln_b, eps)
    gact, dhb, col = gk.mlp_bwd_dual(y, w1, b1, g, w2)
    dw2 = gk.gemm_tn(g, gact)
    dw1 = gk.gemm_tn(dhb, y)
    dy = gk.gemm_nn(dhb, w1, torch.float32)
    dx, dvec = gk.layernorm_bwd(x, ln_w, dy, g, eps=eps)
    # column sums in two passes (per image, per 128-row tile's pair of
    # partials), so no thread walks a whole batch's rows
    db1, db2 = gk.colsum(col, seg_len=2), gk.colsum(g, seg_len=x.shape[-2])
    return dx, dvec[0], dvec[1], dw1, db1, dw2, db2


def _mhsa_forward(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, *, num_heads, eps, nomax):
    y = layernorm(x, ln_w, ln_b, eps)
    qkv = gemm_bias_act(y, w_qkv, b_qkv)
    o = attention(qkv, num_heads, nomax=nomax)
    return gemm_bias_act(o, w_o, b_o, residual=x)


def _mlp_forward(x, ln_w, ln_b, w1, b1, w2, b2, *, eps):
    y = layernorm(x, ln_w, ln_b, eps)
    h = gemm_bias_act(y, w1, b1, gelu=True)
    return gemm_bias_act(h, w2, b2, residual=x)


class _MhsaBlock(torch.autograd.Function):
    """:func:`mhsa_block` with the backward of ``_mhsa_t_bwd_kernel``; each
    pass takes the kernels on CUDA and the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, num_heads, eps, nomax):
        ctx.save_for_backward(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o)
        ctx.kw = dict(num_heads=num_heads, eps=eps, nomax=nomax)
        return _mhsa_forward(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        g = g.contiguous()
        if kernels.on_cpu(*saved, g):
            grads = mhsa_block_bwd_plain(*saved, g, **ctx.kw)
        else:
            from openvision_tpu_torch.ops import fused_attention  # it imports this module

            grads = fused_attention._backward_kernels(
                *saved, g, sm_scale=None, causal=False, prefix_len=0, bias_sum_per_image=False,
                **ctx.kw)
        return (*grads, None, None, None)


class _MlpBlock(torch.autograd.Function):
    """:func:`mlp_block` with the backward of ``_mlp_t_bwd_kernel``."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.eps = eps
        return _mlp_forward(x, ln_w, ln_b, w1, b1, w2, b2, eps=eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        g = g.contiguous()
        if kernels.on_cpu(*saved, g):
            grads = mlp_block_bwd_plain(*saved, g, eps=ctx.eps)
        else:
            grads = _mlp_backward_kernels(*saved, g, eps=ctx.eps)
        return (*grads, None)


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def mhsa_block(x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o, *, num_heads: int,
               eps: float = 1e-6, nomax: bool = False):
    """The ``_mhsa_t_kernel`` sub-block as 4 launches: LN, QKV, attention,
    out-proj + residual. Weights in torch's (out, in) layout. When autograd
    records (grad enabled and an input requires grad) the call is
    differentiable through the backward of ``_mhsa_t_bwd_kernel``."""
    args = (x, ln_w, ln_b, w_qkv, b_qkv, w_o, b_o)
    if _records(*args):
        return _MhsaBlock.apply(*args, num_heads, eps, nomax)
    return _mhsa_forward(*args, num_heads=num_heads, eps=eps, nomax=nomax)


def mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, *, eps: float = 1e-6):
    """The ``_mlp_t_kernel`` sub-block as 3 launches: LN, fc1 + GELU,
    fc2 + residual; differentiable through the backward of
    ``_mlp_t_bwd_kernel`` when autograd records."""
    args = (x, ln_w, ln_b, w1, b1, w2, b2)
    if _records(*args):
        return _MlpBlock.apply(*args, eps)
    return _mlp_forward(*args, eps=eps)
