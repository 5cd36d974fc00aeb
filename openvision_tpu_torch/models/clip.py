"""Two-tower CLIP / CoCa model: ViT image tower + text tower (+ caption decoder).

Counterpart of ``openvision_tpu/models/clip.py:CLIPModel``: L2-normalized
zimg and ztxt (norm + 1e-8) with their norms in the out-dict, the learnable
log-temperature ``t`` (exp'd in the outputs), and the CoCa caption decoder
(``models/decoder.py``) consuming the image tower's patch tokens and the
text tower's pre-norm token features, its logits in ``out["logits"]``
(:80-97; None when the decoder is off or a tower gives no tokens). The
towers sit under ``visual`` and ``text``, the decoder under ``txt_decoder``
and the temperature is OpenCLIP's ``logit_scale``; ``convert/openclip.py``
maps OpenCLIP and JAX weights onto these names. The decoder is built when
``text_decoder`` names one; the port's default is "none" (the JAX default
is "text_decoder"), since the two-tower exports load no decoder weights.
With ``train=True`` (:90-97) the caption decoder reads the FIRST text view
only (a training batch stacks two caption views per image, so the text
tower's tokens are halved), and a decoder with ``return_prelogits`` returns
its prelogits as ``out["cap_prelogits"]`` (logits None) for the head-fused
caption loss. The logit bias is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from openvision_tpu_torch.models import decoder as decoder_mod
from openvision_tpu_torch.models import text as text_mod
from openvision_tpu_torch.models import vit as vit_mod


class CLIPModel(nn.Module):
    def __init__(self, out_dim: Union[int, Tuple[Optional[int], int]] = 512,
                 image: Optional[dict] = None, text: Optional[dict] = None,
                 text_decoder_config: Optional[dict] = None,
                 text_decoder: Optional[str] = "none", temperature_init: float = 10.0):
        super().__init__()
        out_dims = (out_dim, out_dim) if isinstance(out_dim, int) else out_dim
        self.visual = vit_mod.Model(num_classes=out_dims[0], **dict(image or {}))
        self.text = text_mod.Model(num_classes=out_dims[1], **dict(text or {}))
        self.txt_decoder = None
        if text_decoder not in (None, "none"):
            self.txt_decoder = decoder_mod.Model(
                image_width=self.visual.width, text_width=self.text.width,
                **dict(text_decoder_config or {}))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(temperature_init)))

    def forward(self, image: Optional[torch.Tensor], text: Optional[torch.Tensor] = None,
                train: bool = False, rng: Optional[torch.Generator] = None):
        """`rng` draws the image tower's drop-path masks in training (the
        JAX ``rngs={"drop_path": ...}``)."""
        zimg = ztxt = image_embs = token_embs = None
        out = {"logits": None}
        if image is not None:
            zimg = self.visual(image, train=train, rng=rng)
            if isinstance(zimg, tuple):
                zimg, image_embs = zimg
            zimg = zimg.float()
            out["img/norm"] = torch.linalg.norm(zimg, dim=1, keepdim=True)
            zimg = zimg / (out["img/norm"] + 1e-8)
            out["img/normalized"] = zimg
        if text is not None:
            ztxt = self.text(text)
            if isinstance(ztxt, tuple):
                ztxt, token_embs = ztxt
            ztxt = ztxt.float()
            out["txt/norm"] = torch.linalg.norm(ztxt, dim=1, keepdim=True)
            ztxt = ztxt / (out["txt/norm"] + 1e-8)
            out["txt/normalized"] = ztxt
        if self.txt_decoder is not None and image_embs is not None and token_embs is not None:
            if train:  # two text views per image: caption the first
                token_embs = token_embs[: token_embs.shape[0] // 2]
            if train and self.txt_decoder.return_prelogits:
                out["cap_prelogits"] = self.txt_decoder.prelogits(image_embs, token_embs)
            else:
                out["logits"] = self.txt_decoder(image_embs, token_embs)
        out["t"] = self.logit_scale.exp().reshape(1)
        out["t/parameter"] = self.logit_scale.reshape(1)
        return zimg, ztxt, out
