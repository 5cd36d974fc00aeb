"""Two-tower CLIP model: ViT image tower + text tower.

Counterpart of ``openvision_tpu/models/clip.py:CLIPModel``: L2-normalized
zimg and ztxt (norm + 1e-8) with their norms in the out-dict, and the
learnable log-temperature ``t`` (exp'd in the outputs). The towers sit under
``visual`` and ``text`` and the temperature is OpenCLIP's ``logit_scale``;
``convert/openclip.py`` maps OpenCLIP and JAX weights onto these names. The
caption decoder and the logit bias are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from openvision_tpu_torch.models import text as text_mod
from openvision_tpu_torch.models import vit as vit_mod


class CLIPModel(nn.Module):
    def __init__(self, out_dim: Union[int, Tuple[Optional[int], int]] = 512,
                 image: Optional[dict] = None, text: Optional[dict] = None,
                 temperature_init: float = 10.0):
        super().__init__()
        out_dims = (out_dim, out_dim) if isinstance(out_dim, int) else out_dim
        self.visual = vit_mod.Model(num_classes=out_dims[0], **dict(image or {}))
        self.text = text_mod.Model(num_classes=out_dims[1], **dict(text or {}))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(temperature_init)))

    def forward(self, image: Optional[torch.Tensor], text: Optional[torch.Tensor] = None):
        zimg = ztxt = None
        out = {}
        if image is not None:
            zimg = self.visual(image).float()
            out["img/norm"] = torch.linalg.norm(zimg, dim=1, keepdim=True)
            zimg = zimg / (out["img/norm"] + 1e-8)
            out["img/normalized"] = zimg
        if text is not None:
            ztxt = self.text(text).float()
            out["txt/norm"] = torch.linalg.norm(ztxt, dim=1, keepdim=True)
            ztxt = ztxt / (out["txt/norm"] + 1e-8)
            out["txt/normalized"] = ztxt
        out["t"] = self.logit_scale.exp().reshape(1)
        out["t/parameter"] = self.logit_scale.reshape(1)
        return zimg, ztxt, out
