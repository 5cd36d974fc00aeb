"""Text transformer tower.

Counterpart of ``openvision_tpu/models/text.py:TextTransformer``: the token
embedding in f32 plus the position embedding, the shared Encoder with tanh
GELU, then the reference's pooling -- final LayerNorm first, then the LAST
token (the appended [CLS]) -- and a head without bias.

Parameters carry OpenCLIP's names: ``token_embedding``,
``positional_embedding`` (L, D), ``transformer``, ``ln_final`` and
``text_projection`` (D, out). With ``output_tokens`` the tower also
returns the caption decoder's token features, taken BEFORE the final
LayerNorm: ``x[:, :-1]`` for ``last`` pooling, ``x[:, 1:]`` for ``first``
(openvision_tpu/models/text.py:144-154). ``remat_policy`` passes to the
Encoder (training). Soft one-hot token input, dropout and drop-path (a rate
> 0 raises) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from openvision_tpu_torch.models.encoder import Encoder, check_not_ported
from openvision_tpu_torch.models.layers import LayerNorm, posemb_sincos_1d, zero_init

# The text variant table differs from the vision one.
VARIANTS = {
    "Ti": (192, 12, 768, 3),
    "S": (384, 12, 1536, 6),
    "M": (512, 12, 2048, 8),
    "B": (512, 12, 2048, 8),
    "L": (768, 12, 3072, 12),
    "So400m": (1152, 27, 4304, 16),
    "H": (1024, 24, 4096, 16),
    "g": (1280, 32, 5120, 16),
    "G": (1664, 48, 8192, 16),
    "e": (1792, 56, 15360, 16),
}


def decode_variant(variant: str | None) -> dict:
    if variant is None:
        return {}
    width, depth, mlp_dim, num_heads = VARIANTS[variant.split("/")[0]]
    return dict(width=width, depth=depth, mlp_dim=mlp_dim, num_heads=num_heads)


def text_global_pool(x: torch.Tensor, text: Optional[torch.Tensor] = None,
                     pool_type: str = "last") -> torch.Tensor:
    """Pools token features: 'first' | 'last' | 'argmax' (eot)."""
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        return x[:, -1]
    if pool_type == "argmax":
        return x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]
    raise ValueError(f"Unknown pool_type: {pool_type!r}")


class TextTransformer(nn.Module):
    """Text tower producing the pooled embedding."""

    def __init__(self, num_classes: Optional[int] = None, width: int = 512, depth: int = 12,
                 mlp_dim: Optional[int] = None, num_heads: int = 8, vocab_size: int = 32000,
                 context_length: int = 80, posemb: str = "learn", pool_type: str = "last",
                 causal: bool = False, attn_impl: str = "xla",
                 output_tokens: bool = False, remat_policy: str = "none", dropout: float = 0.0,
                 drop_path: float = 0.0, head_zeroinit: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if posemb not in ("learn", "sincos1d"):
            raise ValueError(f"Unknown posemb type: {posemb!r}")
        check_not_ported(drop_path=drop_path)  # no generator reaches this tower's stack
        self.token_embedding = zero_init(nn.Embedding, vocab_size, width)
        if posemb == "learn":
            self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = Encoder(
            width, depth, num_heads, mlp_dim, init_style="scaled", causal=causal,
            attn_impl=attn_impl, remat_policy=remat_policy, dropout=dropout,
            drop_path=drop_path, dtype=dtype)
        self.ln_final = LayerNorm(width)  # f32 out, like flax's default dtype
        if num_classes:
            self.text_projection = nn.Parameter(torch.zeros(width, num_classes))
        self.num_classes = num_classes
        self.width = width
        self.posemb = posemb
        self.pool_type = pool_type
        self.output_tokens = output_tokens
        self.head_zeroinit = head_zeroinit
        self.dtype = dtype

    def forward(self, text: torch.Tensor):
        """text: (N, L) int token ids -> (N, num_classes) f32; with
        ``output_tokens``, (pooled, pre-norm token features)."""
        x = self.token_embedding(text.long()).float()
        _, l, d = x.shape
        if self.posemb == "learn":
            x = x + self.positional_embedding.float()
        else:
            x = x + posemb_sincos_1d(l, d, device=x.device)
        x = self.transformer(x.to(self.dtype))
        tokens = {"last": x[:, :-1], "first": x[:, 1:]}.get(self.pool_type, x)
        pooled = text_global_pool(self.ln_final(x), text, self.pool_type)
        if self.num_classes:
            pooled = pooled.float() @ self.text_projection.float()
        if self.output_tokens:
            return pooled, tokens
        return pooled


def Model(num_classes=None, *, variant=None, **kw):
    """Factory mirroring the JAX package's ``Model(variant="L", ...)``."""
    return TextTransformer(num_classes=num_classes, **{**decode_variant(variant), **kw})
