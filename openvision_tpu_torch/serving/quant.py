"""W8A8 dynamically quantised ViT encode for serving (opt-in).

Counterpart of ``openvision_tpu/serving/quant.py``: :func:`quantize_vit_params`
(:62) quantises a ViT tower's block matrices and head to per-output-channel
symmetric int8 once, and :func:`quantized_encode_fused` (:298) encodes with
per-token dynamic activation quantisation on the int8 kernels of
``ops/fused_encoder_int8.py``: conv patch embed in bf16, cls token and
position embedding, the int8 blocks, GAP over tokens 1: with
``encoder_norm``, a per-row int8 head and L2 normalisation with ``+ 1e-8``.
Serving accuracy (output cosine >= 0.995 against the float tower), never a
default.

The quantiser reads the port's f32 weights as loaded (torch's ``(out, in)``
layout) and gives ``(out, in)`` int8 matrices with ``(out,)`` f32 scales: the
transpose of the JAX package's ``(in, out)`` int8 kernels, bit for bit, from
the same f32 weights (flax keeps ``param_dtype`` f32; the port's
``load_model`` casts the block matrices to bf16 after this runs, so
``load_model(..., int8=True)`` quantises first). cls, the position
embedding, the conv embed and ``encoder_norm`` stay in float.

The XLA-composed ``quantized_encode`` (:166) and its static scales
``calibrate_vit`` (:251) are not ported: the daemon and the encode CLI run
the fused path only, and ``calibrate_vit``'s one caller is the ``disclf``
evaluator, which is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from openvision_tpu_torch.models.layers import posemb_sincos_2d
from openvision_tpu_torch.ops.fused_encoder_int8 import (
    gemm_int8,
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
def quantize_vit_params(vision) -> dict:
    """The int8 tower of a port ``ViT`` with f32 weights.

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
    conv = vision.conv1
    fp = {"conv_w": _f32(conv.weight), "conv_b": _f32(conv.bias),
          "cls": _f32(vision.class_embedding),
          "pos_embedding": _f32(getattr(vision, "positional_embedding", None)),
          "ln_post_w": _f32(vision.ln_post.weight), "ln_post_b": _f32(vision.ln_post.bias)}
    hq, hs = quant_w(vision.proj.detach().t().contiguous())
    head = {"q": hq, "s": hs, "b": _f32(vision.proj_bias)}

    def bias(t, n):
        return torch.zeros(n, device=conv.weight.device) if t is None else _f32(t)

    blocks = []
    for blk in vision.transformer.resblocks:
        attn, mlp = blk.attn, blk.mlp
        qb = {"ln1_w": _f32(blk.ln_1.weight), "ln1_b": _f32(blk.ln_1.bias),
              "ln2_w": _f32(blk.ln_2.weight), "ln2_b": _f32(blk.ln_2.bias),
              "eps": blk.ln_1.eps}
        for name, w, b in (("wqkv", attn.in_proj_weight, attn.in_proj_bias),
                           ("wo", attn.out_proj.weight, attn.out_proj.bias),
                           ("w1", mlp.c_fc.weight, mlp.c_fc.bias),
                           ("w2", mlp.c_proj.weight, mlp.c_proj.bias)):
            qb[f"{name}_q"], qb[f"{name}_s"] = quant_w(w.detach())
            qb[f"b{name[1:]}"] = bias(b, w.shape[0])
        qb["num_heads"] = blk.num_heads
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
