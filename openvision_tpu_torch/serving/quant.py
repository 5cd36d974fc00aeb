"""W8A8 quantised ViT encode for serving and for the int8 zero-shot eval.

Counterpart of ``openvision_tpu/serving/quant.py``: :func:`quantize_vit_params`
(:62) quantises a ViT tower's block matrices and head to per-output-channel
symmetric int8 once; :func:`quantized_encode_fused` (:298) encodes with
per-token dynamic activation quantisation on the int8 kernels of
``ops/fused_encoder_int8.py`` (the daemon's and the encode CLI's path):
conv patch embed in bf16, cls token and position embedding, the int8
blocks, GAP over tokens 1: with ``encoder_norm``, a per-row int8 head and
L2 normalisation with ``+ 1e-8``. Serving accuracy (output cosine >= 0.995
against the float tower), never a default.

:func:`quantized_encode` (:166) is the JAX package's XLA-composed encode,
the ``disclf`` evaluator's ``int8`` mode: the max-subtracted softmax and the
model's own GELU, and activations quantised per token (``act_scales``
None) or by the static per-tensor scales of :func:`calibrate_vit` (:251),
the max of each quantisation site's abs-max / 127 over the calibration
images in 32-image chunks. It runs on the same kernels: ``layernorm_quant``
(the f32 LN output quantised in the kernel, by its own row scale or the
static one), ``gemm_int8`` (its per-row ``a_scale`` a filled vector under a
static scale), the attention kernel (bf16 output, as JAX's bf16 einsum
gives it, widened to f32) and ``quant_rows``; the exact GELU, where the
model has it, is a torch op between fc1 and ``quant_rows``, as it is an XLA
op in JAX. The LN is E[x^2] - mean^2 here
(JAX: two-pass), and the dequant is ``acc * w_scale * a_scale`` (JAX:
``acc * x_scale * w_scale``): both differ in the last bits.

The quantiser reads the port's f32 weights as loaded (torch's ``(out, in)``
layout) and gives ``(out, in)`` int8 matrices with ``(out,)`` f32 scales: the
transpose of the JAX package's ``(in, out)`` int8 kernels, bit for bit, from
the same f32 weights (flax keeps ``param_dtype`` f32; the port's
``load_model`` casts the block matrices to bf16 after this runs, so
``load_model(..., int8=True)`` quantises first). cls, the position
embedding, the conv embed and ``encoder_norm`` stay in float.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from openvision_tpu_torch.models.layers import posemb_sincos_2d
from openvision_tpu_torch.ops import fused_encoder as fe
from openvision_tpu_torch.ops.fused_encoder_int8 import (
    gemm_int8,
    layernorm_quant,
    mhsa_t_int8,
    mlp_t_int8,
    quant_plain,
    quant_rows,
)


def quant_w(weight: torch.Tensor):
    """Per-output-channel symmetric int8 of an (out, in) f32 matrix:
    ((out, in) int8, (out,) f32), as ``_quant_w`` (quant.py:25) on its
    (in, out) transpose."""
    if weight.dtype != torch.float32:
        raise TypeError(f"int8 weights are quantised from the f32 weights as loaded, got "
                        f"{weight.dtype}: quantise before casting the block matrices")
    return quant_plain(weight)  # per row: the same arithmetic as the activations


def _f32(t):
    return None if t is None else t.detach().float()


@torch.no_grad()
def quantize_vit_params(vision, whole: dict | None = None) -> dict:
    """The int8 tower of a port ``ViT`` with f32 weights; `whole` (the
    tower's state dict, names within the tower) takes the leaves' place
    where a process mesh holds the tower's leaves in pieces.

    Returns {"_fp": float tensors (conv embed, cls, position embedding,
    encoder_norm), "head": {"q", "s", "b"}, "blocks": one dict a block with
    the LN parameters, "wqkv_q"/"wqkv_s" (3D, D) (query | key | value rows,
    each quantised per row as JAX quantises each projection per column),
    "wo_*" (D, D), "w1_*" (MLP, D), "w2_*" (D, MLP) and f32 biases (zeros
    where the model has none)}, on the tower's device.
    """
    if vision.pool_type != "gap" or not vision.num_classes:
        raise NotImplementedError(
            "the int8 encode computes GAP + encoder_norm + an int8 head "
            f"(quantized_encode_fused); got pool_type={vision.pool_type!r}, "
            f"num_classes={vision.num_classes}")

    def leaf(name: str):
        if whole is not None:
            return whole.get(name)
        owner, _, attr = name.rpartition(".")
        return getattr(vision.get_submodule(owner) if owner else vision, attr, None)

    fp = {"conv_w": _f32(leaf("conv1.weight")), "conv_b": _f32(leaf("conv1.bias")),
          "cls": _f32(leaf("class_embedding")),
          "pos_embedding": _f32(leaf("positional_embedding")),
          "ln_post_w": _f32(leaf("ln_post.weight")), "ln_post_b": _f32(leaf("ln_post.bias"))}
    hq, hs = quant_w(leaf("proj").detach().t().contiguous())
    head = {"q": hq, "s": hs, "b": _f32(leaf("proj_bias"))}

    def bias(t, n):
        return torch.zeros(n, device=fp["conv_w"].device) if t is None else _f32(t)

    blocks = []
    for i, blk in enumerate(vision.transformer.resblocks):
        pre = f"transformer.resblocks.{i}."
        qb = {"ln1_w": _f32(leaf(pre + "ln_1.weight")), "ln1_b": _f32(leaf(pre + "ln_1.bias")),
              "ln2_w": _f32(leaf(pre + "ln_2.weight")), "ln2_b": _f32(leaf(pre + "ln_2.bias")),
              "eps": blk.ln_1.eps}
        for name, w, b in (("wqkv", "attn.in_proj_weight", "attn.in_proj_bias"),
                           ("wo", "attn.out_proj.weight", "attn.out_proj.bias"),
                           ("w1", "mlp.c_fc.weight", "mlp.c_fc.bias"),
                           ("w2", "mlp.c_proj.weight", "mlp.c_proj.bias")):
            w = leaf(pre + w)
            qb[f"{name}_q"], qb[f"{name}_s"] = quant_w(w.detach())
            qb[f"b{name[1:]}"] = bias(leaf(pre + b), w.shape[0])
        qb["num_heads"] = blk.num_heads
        qb["gelu_tanh"] = bool(blk.mlp.gelu_approx)
        blocks.append(qb)
    return {"_fp": fp, "head": head, "blocks": blocks}


def _ln(x, w, b, eps: float = 1e-6):
    """Two-pass LayerNorm in f32 (quant.py:104, jnp.var)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * w + b


def _embed_tokens(qparams: dict, image: torch.Tensor, *, patch_size: int,
                 posemb: str = "learn") -> torch.Tensor:
    """The bf16 token stream (N, 1+P, D) of (N, H, W, 3) images: the conv
    patch embed on bf16 inputs and weights, cls, then the f32 position
    embedding added and rounded to bf16 (quant.py:323-339)."""
    fp = qparams["_fp"]
    x = F.conv2d(image.to(torch.bfloat16).permute(0, 3, 1, 2), fp["conv_w"].to(torch.bfloat16),
                 stride=patch_size)
    n, d, h, w = x.shape
    x = x.flatten(2).transpose(1, 2)
    if fp["conv_b"] is not None:
        x = x.float() + fp["conv_b"]
    x = torch.cat([fp["cls"].to(x.dtype).expand(n, 1, d), x], dim=1)
    if posemb == "sincos2d":
        pe = posemb_sincos_2d(h, w, d, cls_token=True, device=x.device)
    else:
        pe = fp["pos_embedding"]
    return (x.float() + pe).to(torch.bfloat16).contiguous()


def quantized_encode_fused(qparams: dict, image: torch.Tensor, *, patch_size: int,
                           posemb: str = "learn") -> torch.Tensor:
    """W8A8 ViT encode: (N, H, W, 3) images -> (N, out_dim) f32, L2-normalised.

    Always ``nomax`` softmax and tanh GELU (the fused kernels' serving mode,
    quant.py:390, fused_encoder_int8.py:154), whatever the model's flags.
    Per encode: 2 layernorm_quant, 4 gemm_int8, 1 attention (f32 out) and 2
    quant_rows launches a block, then the pooled row's quant_rows and the
    head's gemm_int8.
    """
    x = _embed_tokens(qparams, image, patch_size=patch_size, posemb=posemb)
    for blk in qparams["blocks"]:
        x = mhsa_t_int8(x, blk["ln1_w"], blk["ln1_b"], blk["wqkv_q"], blk["wqkv_s"], blk["bqkv"],
                        blk["wo_q"], blk["wo_s"], blk["bo"], num_heads=blk["num_heads"],
                        eps=blk["eps"])
        x = mlp_t_int8(x, blk["ln2_w"], blk["ln2_b"], blk["w1_q"], blk["w1_s"], blk["b1"],
                       blk["w2_q"], blk["w2_s"], blk["b2"], eps=blk["eps"])
    fp, head = qparams["_fp"], qparams["head"]
    # jnp.mean of the bf16 stream sums in f32 and rounds the mean to bf16
    pooled = x[:, 1:].float().mean(1).to(torch.bfloat16)
    pooled = _ln(pooled, fp["ln_post_w"], fp["ln_post_b"]).contiguous()
    pq, ps = quant_rows(pooled)
    z = gemm_int8(pq, ps, head["q"], head["s"], head["b"], out_dtype=torch.float32)
    return z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)


SITES = ("attn_in", "attn_out", "mlp_in", "mlp_hid")


def _amax_scale(amax: torch.Tensor) -> torch.Tensor:
    """A site's per-tensor scale from its abs-max: m / 127, 1 where m is 0
    (quant.py:114); (1,) f32."""
    m = amax.float().reshape(1)
    return torch.where(m == 0, torch.ones_like(m), m / 127.0)


def _rows_scale(q: torch.Tensor, row_scale: torch.Tensor) -> torch.Tensor:
    """The per-tensor scale of a tensor quantised per row, from its int8
    values and row scales: a row's scale is its abs-max / 127 and the
    division is monotone, so the largest row scale is the tensor's abs-max
    / 127; an all-zero row (scale 1, every value 0) is left out. (1,) f32."""
    live = (q.reshape(-1, q.shape[-1]) != 0).any(-1)
    m = torch.where(live, row_scale.reshape(-1), torch.zeros_like(row_scale.reshape(-1))).amax()
    return torch.where(m == 0, torch.ones_like(m), m).reshape(1)


def _int8_block(x, qb: dict, scales: dict | None, stats: dict | None):
    """One block of :func:`quantized_encode` (quant.py:_block, :121)."""
    site = (lambda k: None) if scales is None else scales.__getitem__
    yq, ys = layernorm_quant(x, qb["ln1_w"], qb["ln1_b"], qb["eps"], site("attn_in"))
    if stats is not None:
        stats["attn_in"] = _rows_scale(yq, ys)
    qkv = gemm_int8(yq, ys, qb["wqkv_q"], qb["wqkv_s"], qb["bqkv"])
    o = fe.attention(qkv, qb["num_heads"]).float()  # JAX's p.v einsum rounds o to bf16
    oq, os_ = quant_rows(o, static_scale=site("attn_out"))
    if stats is not None:
        stats["attn_out"] = _rows_scale(oq, os_)
    x = gemm_int8(oq, os_, qb["wo_q"], qb["wo_s"], qb["bo"], residual=x)
    yq, ys = layernorm_quant(x, qb["ln2_w"], qb["ln2_b"], qb["eps"], site("mlp_in"))
    if stats is not None:
        stats["mlp_in"] = _rows_scale(yq, ys)
    if qb["gelu_tanh"]:
        h, hmax = gemm_int8(yq, ys, qb["w1_q"], qb["w1_s"], qb["b1"], gelu=True,
                            out_dtype=torch.float32, row_amax=True)
    else:  # the exact GELU, an elementwise torch op as in XLA
        h = F.gelu(gemm_int8(yq, ys, qb["w1_q"], qb["w1_s"], qb["b1"], out_dtype=torch.float32))
        hmax = None
    hq, hs = quant_rows(h, hmax, static_scale=site("mlp_hid"))
    if stats is not None:
        stats["mlp_hid"] = _amax_scale(h.abs().amax() if hmax is None else hmax.amax())
    return gemm_int8(hq, hs, qb["w2_q"], qb["w2_s"], qb["b2"], residual=x)


def quantized_encode(qparams: dict, image: torch.Tensor, *, patch_size: int,
                     posemb: str = "learn", act_scales: dict | None = None,
                     return_stats: bool = False):
    """W8A8 ViT encode: (N, H, W, 3) images -> (N, out_dim) f32, L2-normalised.

    `act_scales` (from :func:`calibrate_vit`) switches the activations from
    per-token dynamic to static per-tensor scales. `return_stats=True` also
    returns each site's per-tensor scale on these images (abs-max / 127, 1
    where the abs-max is 0): {"blocks": [{site: (1,) f32}], "head_in"}.
    Per encode: 2 layernorm_quant, 4 gemm_int8, 1 attention and 2
    quant_rows launches a block, then the pooled row's quant_rows and the
    head's gemm_int8, with either kind of scale.
    """
    x = _embed_tokens(qparams, image, patch_size=patch_size, posemb=posemb)
    per_block = []
    for i, qb in enumerate(qparams["blocks"]):
        stats = {} if return_stats else None
        x = _int8_block(x, qb, None if act_scales is None else act_scales["blocks"][i], stats)
        if return_stats:
            per_block.append(stats)
    fp, head = qparams["_fp"], qparams["head"]
    pooled = x[:, 1:].float().mean(1).to(torch.bfloat16)
    pooled = _ln(pooled, fp["ln_post_w"], fp["ln_post_b"]).contiguous()
    pq, ps = quant_rows(pooled, static_scale=None if act_scales is None else act_scales["head_in"])
    z = gemm_int8(pq, ps, head["q"], head["s"], head["b"], out_dtype=torch.float32)
    z = z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-8)
    if not return_stats:
        return z
    return z, {"blocks": per_block, "head_in": _amax_scale(pooled.abs().amax())}


@torch.no_grad()
def calibrate_vit(qparams: dict, images: torch.Tensor, *, patch_size: int,
                  posemb: str = "learn", batch: int = 32) -> dict:
    """Static per-tensor activation scales from a calibration set: the int8
    encode in dynamic mode over `images` in `batch`-sized chunks, each
    site's scale the largest over the chunks ({"blocks": [{attn_in,
    attn_out, mlp_in, mlp_hid}], "head_in"}, each (1,) f32 on the images'
    device), for ``quantized_encode(act_scales=...)``. Inputs outside the
    calibration range saturate at +-127."""
    agg = None
    for i in range(0, images.shape[0], batch):
        _, stats = quantized_encode(qparams, images[i:i + batch], patch_size=patch_size,
                                    posemb=posemb, return_stats=True)
        if agg is None:
            agg = stats
            continue
        agg = {"blocks": [{k: torch.maximum(a[k], b[k]) for k in SITES}
                          for a, b in zip(agg["blocks"], stats["blocks"])],
               "head_in": torch.maximum(agg["head_in"], stats["head_in"])}
    return agg
