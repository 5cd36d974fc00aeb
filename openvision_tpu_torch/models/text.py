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
Encoder (training). A float (N, L, V) ``text`` is a soft one-hot sequence
(the gradient-ascent tool's), embedded as ``text @ token_embedding.weight``
in f32 (:100-104); pooling ``last`` and ``first`` read no ids, and
``argmax`` on soft tokens raises (the JAX pool would take its argmax over
the vocab axis). In training (``train=True`` with a generator) the
embedded tokens take the dropout (:124) and the Encoder its dropout and
drop-path (:125-131), the draws in that order. ``scan_mlp``, ``chunk`` and
``use_dense_general`` pass to the Encoder; ``embed_cls`` is accepted and
unused, as in JAX (kept for config compat, :83); ``param_dtype``
(float32 or bfloat16) is the dtype the parameters are stored in, all but
``ln_final`` (flax's default f32 there).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from openvision_tpu_torch.models.encoder import Encoder
from openvision_tpu_torch.models.vit import cast_params, check_param_dtype
from openvision_tpu_torch.models.layers import (Dropout, LayerNorm, dropout_generator,
                                                posemb_sincos_1d, sharded_head, zero_init)
from openvision_tpu_torch.parallel import sharded_mesh, vocab_parallel_embedding

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
                 scan_mlp: bool = False, chunk: int = 128, embed_cls: bool = False,
                 use_dense_general: bool = False, param_dtype=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        param_dtype = check_param_dtype(param_dtype)
        if posemb not in ("learn", "sincos1d"):
            raise ValueError(f"Unknown posemb type: {posemb!r}")
        self.token_embedding = zero_init(nn.Embedding, vocab_size, width)
        if posemb == "learn":
            self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = Encoder(
            width, depth, num_heads, mlp_dim, init_style="scaled", causal=causal,
            attn_impl=attn_impl, remat_policy=remat_policy, dropout=dropout,
            drop_path=drop_path, scan_mlp=scan_mlp, chunk=chunk,
            use_dense_general=use_dense_general, dtype=dtype)
        self.dropout = Dropout(dropout)
        self.ln_final = LayerNorm(width)  # f32 out, like flax's default dtype
        if num_classes:
            self.text_projection = nn.Parameter(torch.zeros(width, num_classes))
        self.num_classes = num_classes
        # the tensor axis sizes token_embedding's vocab rows and text_projection's output
        # features are sharded over
        self.vocab_parallel = self.head_parallel = 1
        self.width = width
        self.posemb = posemb
        self.pool_type = pool_type
        self.output_tokens = output_tokens
        self.head_zeroinit = head_zeroinit
        self.dtype = dtype
        cast_params(self, param_dtype, keep=("ln_final.",))  # JAX's default f32 norm

    def forward(self, text: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None):
        """text: (N, L) int token ids, or (N, L, V) soft one-hot tokens ->
        (N, num_classes) f32; with ``output_tokens``, (pooled, pre-norm
        token features). With ``train`` the dropout and drop-path draws come
        from `rng`."""
        mesh = sharded_mesh(self.vocab_parallel)
        if text.ndim == 3:
            if self.pool_type == "argmax":
                raise ValueError("pool_type='argmax' needs integer token ids: it cannot find the "
                                 "eot position in soft one-hot (N, L, V) tokens")
            if mesh is not None:
                raise NotImplementedError("soft one-hot (N, L, V) tokens on a tower whose "
                                          "vocab is sharded over tensor")
            x = text.float() @ self.token_embedding.weight.float()
        elif mesh is not None:
            x = vocab_parallel_embedding(text, self.token_embedding.weight, mesh).float()
        else:
            x = self.token_embedding(text.long()).float()
        _, l, d = x.shape
        if self.posemb == "learn":
            x = x + self.positional_embedding.float()
        else:
            x = x + posemb_sincos_1d(l, d, device=x.device)
        x = x.to(self.dtype)
        if train:
            x = self.dropout(x, dropout_generator(rng, self.dropout.rate))
        x = self.transformer(x, train=train, rng=rng)
        tokens = {"last": x[:, :-1], "first": x[:, 1:]}.get(self.pool_type, x)
        pooled = text_global_pool(self.ln_final(x), text, self.pool_type)
        if self.num_classes:
            pooled = sharded_head(pooled, self.text_projection, None, self.head_parallel)
        if self.output_tokens:
            return pooled, tokens
        return pooled


def Model(num_classes=None, *, variant=None, **kw):
    """Factory mirroring the JAX package's ``Model(variant="L", ...)``,
    reference-config keys translated (``models/compat.py``)."""
    from openvision_tpu_torch.models.compat import translate_model_kwargs

    kw = translate_model_kwargs(kw)
    return TextTransformer(num_classes=num_classes, **{**decode_variant(variant), **kw})
