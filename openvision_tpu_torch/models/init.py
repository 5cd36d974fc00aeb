"""Random initialization of a CLIP/CoCa model from a seed.

Counterpart of the flax initializers the JAX package's modules declare:
``_make_inits`` (openvision_tpu/models/encoder.py:55-74) for the encoder
blocks, the towers' embeddings and heads (models/vit.py:220-355,
models/text.py:92-170), the caption decoder's projections, queries and head
(models/decoder.py:165-242, its cross-attention blocks :98-105) and the
temperature and the logit bias (models/clip.py:99-116, set by ``CLIPModel``
itself). The draws
come from a ``torch.Generator`` seeded with `seed`, so they match the JAX
distributions, not its bits (the two RNGs differ).

Per parameter (OpenCLIP names):

- LayerNorm weights one, biases zero; every Dense and conv bias zero;
  LayerScale gains (``ls_1.gamma``, ``ls_2.gamma``) the constant
  ``init_values`` (openvision_tpu/models/layers.py:193-195);
- ``vit`` blocks (the image tower): q/k/v, out and fc kernels N(0, 0.02),
  the MLP's second kernel the truncated normal of variance_scaling(0.3072,
  fan_out);
- ``scaled`` blocks (text tower, decoder; depth is the stack's): q/k/v
  N(0, w**-0.5), out and the MLP's second kernel N(0, w**-0.5 (2 depth)**-0.5),
  fc N(0, (2 w)**-0.5); the decoder's cross-attention blocks the same with
  the cross stack's depth;
- patch conv kaiming_uniform (so the ``stem`` convs and its 1x1 conv),
  the ``linear`` patch embed lecun_normal (flax Dense's default), the
  ``map`` pool's probe and attention kernels xavier_uniform (the DenseGeneral
  kernels over their flat (D, D) shape) and its MLP as a ``vit`` block's
  (models/vit.py:65-83, :238-265), cls N(0, 1e-6), learned image position
  embedding N(0, 0.02), token embedding N(0, 0.02), text position embedding
  N(0, 0.01), image head N(0, 0.02), text head N(0, w**-0.5) (zero with
  ``head_zeroinit``), decoder projections N(0, fan_in**-0.5), queries N(0, 1),
  decoder head N(0, w**-0.5).
"""

from __future__ import annotations

import math
import re

import torch
from torch import nn

from openvision_tpu_torch.models.clip import CLIPModel

_TRUNC_STD = 0.87962566103423978  # stddev of N(0, 1) truncated to [-2, 2]


def _block_inits(style: str, width: int, depth: int) -> dict:
    """std of each block kernel (``_make_inits``); "proj_trunc" marks the
    vit style's truncated-normal second MLP kernel."""
    if style == "vit":
        return {"qkv": 0.02, "out": 0.02, "fc": 0.02, "proj_trunc": 0.3072}
    proj = width**-0.5 * (2 * depth) ** -0.5
    return {"qkv": width**-0.5, "out": proj, "fc": (2 * width) ** -0.5, "proj": proj}


def _fill_block(name: str, p: torch.Tensor, inits: dict, gen: torch.Generator) -> None:
    leaf = name.rsplit(".", 2)
    kind = ".".join(leaf[-2:])
    if name.endswith("bias") or re.search(r"\.ln_\w+\.weight$", name):
        p.fill_(1.0 if name.endswith("weight") else 0.0)
    elif kind in ("ls_1.gamma", "ls_2.gamma"):
        p.fill_(inits["ls"])
    elif kind == "attn.in_proj_weight":
        p.normal_(0.0, inits["qkv"], generator=gen)
    elif kind == "out_proj.weight":
        p.normal_(0.0, inits["out"], generator=gen)
    elif kind == "c_fc.weight":
        p.normal_(0.0, inits["fc"], generator=gen)
    elif kind == "c_proj.weight":
        if "proj_trunc" in inits:  # variance_scaling(0.3072, fan_out, truncated_normal)
            std = math.sqrt(inits["proj_trunc"] / p.shape[0]) / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)
        else:
            p.normal_(0.0, inits["proj"], generator=gen)
    else:
        raise KeyError(f"no initializer for block parameter {name!r}")


def _fill_map_head(name: str, p: torch.Tensor, gen: torch.Generator) -> None:
    """The map pool's parameters: the probe (1, 1, D) and the attention's
    kernels xavier_uniform, the MLP and LayerNorm as a vit block's."""
    d = p.shape[-1]
    if name.endswith("probe"):  # fan_in 1, fan_out D
        limit = math.sqrt(6.0 / (1 + d))
        p.uniform_(-limit, limit, generator=gen)
    elif name.endswith(("attn.in_proj_weight", "out_proj.weight")):  # each (D, D) kernel
        limit = math.sqrt(6.0 / (2 * d))
        p.uniform_(-limit, limit, generator=gen)
    else:
        _fill_block(name, p, _block_inits("vit", d, 0), gen)


@torch.no_grad()
def init_params(model: CLIPModel, seed: int) -> CLIPModel:
    """Draws every parameter of `model` in place from `seed`; returns it."""
    gens = {}

    def gen_for(p):
        if p.device not in gens:
            gens[p.device] = torch.Generator(device=p.device).manual_seed(seed)
        return gens[p.device]

    vis, txt, dec = model.visual, model.text, model.txt_decoder
    styles = {"visual.transformer.": {**_block_inits("vit", vis.width, 0),
                                      "ls": vis.transformer.init_values},
              "text.transformer.": _block_inits("scaled", txt.width,
                                                len(txt.transformer.resblocks))}
    if dec is not None:
        styles["txt_decoder.transformer."] = _block_inits(  # the cross stack's depth is half
            "scaled", dec.width, len(dec.transformer.resblocks))
    for name, p in model.named_parameters():
        gen = gen_for(p)
        block = next((s for prefix, s in styles.items() if name.startswith(prefix)), None)
        if block is not None:
            _fill_block(name, p, block, gen)
        elif name in ("logit_scale", "logit_bias"):
            continue  # CLIPModel sets log(temperature_init) and init_logit_bias
        elif name.endswith("bias") or name.endswith(("ln_post.weight", "ln_final.weight",
                                                       "decoder_norm.weight")):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.startswith("visual.map_head."):
            _fill_map_head(name, p, gen)
        elif name == "visual.conv1.weight" or re.fullmatch(r"visual\.stem\.\d\.weight", name):
            # kaiming_uniform over fan_in = kh * kw * in
            limit = math.sqrt(6.0 / (p.shape[1] * p.shape[2] * p.shape[3]))
            p.uniform_(-limit, limit, generator=gen)
        elif name == "visual.embedding.weight":  # lecun_normal: truncated, fan_in
            std = p.shape[1] ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)
        elif re.fullmatch(r"visual\.stem_norm\.\d\.weight", name):
            p.fill_(1.0)
        elif name == "visual.class_embedding":
            p.normal_(0.0, 1e-6, generator=gen)
        elif name in ("visual.positional_embedding", "text.token_embedding.weight"):
            p.normal_(0.0, 0.02, generator=gen)
        elif name == "text.positional_embedding":
            p.normal_(0.0, 0.01, generator=gen)
        elif name == "visual.proj":
            p.zero_() if vis.head_zeroinit else p.normal_(0.0, 0.02, generator=gen)
        elif name == "text.text_projection":
            p.zero_() if txt.head_zeroinit else p.normal_(0.0, txt.width**-0.5, generator=gen)
        elif name in ("txt_decoder.image_projection_layer.weight",
                      "txt_decoder.text_projection_layer.weight"):
            p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
        elif name == "txt_decoder.learnable_tokens":
            p.normal_(0.0, 1.0, generator=gen)
        elif name == "txt_decoder.head.weight":
            p.normal_(0.0, dec.width**-0.5, generator=gen)
        else:
            raise KeyError(f"no initializer for parameter {name!r}")
    return model
