"""ViT image tower.

Counterpart of ``openvision_tpu/models/vit.py``: the conv patch embed
computed in f32, the cls token, learned or sincos2d position embedding, the
shared Encoder, the pools ``gap``/``tok``/``0``/``avg`` and the head in f32.
Images come in the JAX package's NHWC layout. With ``output_tokens`` the
tower also returns the encoder's patch tokens (the caption decoder's image
tokens): ``encoded[:, 1:]``, or all of them under ``ignore_cls``, which
drops the cls token before the encoder (:289-290, :336-362).

Parameters carry OpenCLIP's ``visual.*`` names: ``conv1`` (OIHW),
``class_embedding`` (D,), ``positional_embedding`` (1+P, D),
``transformer``, ``ln_post`` and ``proj`` (D, out) with ``proj_bias``.
``remat_policy`` passes to the Encoder (training), and so do LayerScale
(``init_values``, :190) and stochastic depth (``drop_path``, whose masks
come from the generator ``forward`` is given with ``train``). The ``map``
pool, the ``stem`` and ``linear`` patch embeds, token masking
(``mask_ratio > 0`` raises under ``train``), dropout (a rate > 0 raises) and
``resample_posemb`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from openvision_tpu_torch.models.encoder import Encoder, check_not_ported
from openvision_tpu_torch.models.layers import LayerNorm, posemb_sincos_2d, zero_init

# Width/depth/mlp/heads per variant, Table 2 of arXiv:2106.04560.
VARIANTS = {
    "mu": (32, 1, 128, 2),
    "Ti": (192, 12, 768, 3),
    "S": (384, 12, 1536, 6),
    "M": (512, 12, 2048, 8),
    "B": (768, 12, 3072, 12),
    "L": (1024, 24, 4096, 16),
    "So400m": (1152, 27, 4304, 16),
    "H": (1280, 32, 5120, 16),
    "g": (1408, 40, 6144, 16),
    "g-opt": (1536, 40, 6144, 16),
    "G": (1664, 48, 8192, 16),
    "G-opt": (1536, 48, 8192, 16),
    "e": (1792, 56, 15360, 16),
}


def decode_variant(variant: str | None) -> dict:
    """Parses "L/14" -> dict(width=1024, depth=24, mlp_dim=4096, num_heads=16, patch_size=(14, 14))."""
    if variant is None:
        return {}
    v, patch = (variant.split("/") + [None])[:2]
    width, depth, mlp_dim, num_heads = VARIANTS[v]
    out = dict(width=width, depth=depth, mlp_dim=mlp_dim, num_heads=num_heads)
    if patch is not None:
        out["patch_size"] = (int(patch), int(patch))
    return out


class ViT(nn.Module):
    """Vision transformer tower producing the pooled embedding.

    `image_size` sizes the learned position embedding (the flax module
    infers it from the first input).
    """

    def __init__(self, num_classes: Optional[int] = None, patch_size: Sequence[int] = (16, 16),
                 width: int = 768, depth: int = 12, mlp_dim: Optional[int] = None,
                 num_heads: int = 12, posemb: str = "learn", pool_type: str = "gap",
                 attn_impl: str = "xla", fast_gelu: bool = False, nomax_softmax: bool = False,
                 emb_head_bias: bool = True, image_size: int = 224,
                 ignore_cls: bool = False, output_tokens: bool = False,
                 remat_policy: str = "none", mask_ratio: float = 0.0, dropout: float = 0.0,
                 drop_path: float = 0.0, init_values: Optional[float] = None,
                 head_zeroinit: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if pool_type not in ("gap", "tok", "0", "avg"):
            raise NotImplementedError(f"pool_type={pool_type!r} is not ported yet")
        if posemb not in ("learn", "sincos2d"):
            raise ValueError(f"Unknown posemb type: {posemb!r}")
        p = tuple(patch_size)
        self.conv1 = zero_init(nn.Conv2d, 3, width, p, stride=p, bias=emb_head_bias)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        if posemb == "learn":
            grid = (image_size // p[0]) * (image_size // p[1])
            self.positional_embedding = nn.Parameter(torch.zeros(1 + grid, width))
        self.transformer = Encoder(
            width, depth, num_heads, mlp_dim, init_style="vit", attn_impl=attn_impl,
            fast_gelu=fast_gelu, nomax_softmax=nomax_softmax, remat_policy=remat_policy,
            dropout=dropout, drop_path=drop_path, init_values=init_values, dtype=dtype)
        if pool_type in ("gap", "tok"):
            self.ln_post = LayerNorm(width, dtype)
        if num_classes:
            self.proj = nn.Parameter(torch.zeros(width, num_classes))
            self.proj_bias = nn.Parameter(torch.zeros(num_classes)) if emb_head_bias else None
        self.num_classes = num_classes
        self.width = width
        self.posemb = posemb
        self.pool_type = pool_type
        self.ignore_cls = ignore_cls
        self.output_tokens = output_tokens
        self.mask_ratio = mask_ratio
        self.head_zeroinit = head_zeroinit
        self.dtype = dtype

    def forward(self, image: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None):
        """image: (N, H, W, 3) -> (N, num_classes) f32 (or (N, width) without a
        head); with ``output_tokens``, (pooled, tokens (N, P, width)). With
        ``train`` and a drop-path rate > 0 the masks are drawn from `rng`."""
        if train:
            check_not_ported(mask_ratio=self.mask_ratio)
        w = self.conv1
        x = F.conv2d(image.float().permute(0, 3, 1, 2), w.weight.float(),
                     None if w.bias is None else w.bias.float(), stride=w.stride)
        n, c, h, wd = x.shape
        x = x.flatten(2).transpose(1, 2)  # (n, h*w, c), row-major patches
        x = torch.cat([self.class_embedding.float().expand(n, 1, c), x], dim=1)
        if self.posemb == "learn":
            x = x + self.positional_embedding.float()
        else:
            x = x + posemb_sincos_2d(h, wd, c, cls_token=True, device=x.device)
        if self.ignore_cls:
            x = x[:, 1:]
        x = self.transformer(x.to(self.dtype), train=train, rng=rng)
        patches = x if self.ignore_cls else x[:, 1:]

        if self.pool_type == "gap":
            pooled = self.ln_post(patches.mean(dim=1))
        elif self.pool_type == "avg":
            pooled = patches.mean(dim=1)
        elif self.pool_type == "0":
            pooled = x[:, 0]
        else:  # "tok"
            pooled = self.ln_post(x)[:, 0]

        if self.num_classes:
            pooled = pooled.float() @ self.proj.float()
            if self.proj_bias is not None:
                pooled = pooled + self.proj_bias.float()
        if self.output_tokens:
            return pooled, patches
        return pooled


def Model(num_classes=None, *, variant=None, **kw):
    """Factory mirroring the JAX package's ``Model(variant="L/14", ...)``."""
    return ViT(num_classes=num_classes, **{**decode_variant(variant), **kw})
