"""CoCa-style caption decoder.

Counterpart of ``openvision_tpu/models/decoder.py``: projects the image
tokens and the text tower's token features to the decoder width, appends
learnable query tokens, and decodes them with either

- ``concat`` fusion: one self-attention stack over [image+text | queries]
  with the prefix-LM mask (prefix fully visible, queries causal), or
- ``cross_attn`` fusion: depth//2 pairs of (causal self-attention over the
  queries, cross-attention queries <- image+text).

Output: vocab logits over the query positions (LayerNorm + Dense head).

The numerics of the flax modules are kept:

- the image and text projections and the learnable queries come out f32
  (flax ``Dense`` with ``dtype=None`` promotes to its f32 kernel,
  :165-187); every block casts its input to the compute dtype;
- decoder blocks use the ``scaled`` init style, so their GELU is tanh
  whatever ``fast_gelu`` says;
- ``CrossAttnBlock`` LayerNorms the context with its own parameters (:91);
  its attention parameters are always DenseGeneral-shaped in the JAX tree
  (:57-119), which ``convert/openclip.py`` reshapes, and under
  ``attn_impl="fused"`` its cross-attention runs on ``xla``, as in the JAX
  module;
- ``decoder_norm`` and ``head`` run in f32 (:235-245).

Parameter names (under ``txt_decoder.`` in the CLIP model; the JAX names
in ``convert/openclip.py``): ``image_projection_layer``,
``text_projection_layer`` (bias-free Linears), ``learnable_tokens`` (N, D),
``transformer.resblocks.i`` (EncoderBlocks), for ``cross_attn`` also
``transformer.cross_resblocks.i.{ln_1, ln_1_kv, attn, ln_2, mlp}``,
``decoder_norm`` and ``head`` (vocab, D). Sampling in :func:`generate` takes
an explicit ``torch.Generator``.

Training: ``remat_policy`` wraps every block (self- and cross-attention) as
the towers do, and with ``return_prelogits`` a ``train`` call returns
``decoder_norm``'s output through :meth:`TextDecoder.prelogits` for the
head-fused caption loss (``losses.linear_softmax_xent``; :246-253), so the
(N, Q, vocab) logits are never built. ``train`` with a generator turns on
the dropout and drop-path (:71-131, :276-308): the concat stack's as the
towers' Encoder, and under ``cross_attn`` each causal self-attention block's
drop-path (linspace(0, drop_path, depth // 2)) and dropout and each
cross-attention block's dropout (attention probabilities, the attention
output, the MLP hidden, the MLP output; it takes no drop-path, as in the JAX
block). ``scan_mlp`` / ``chunk`` reach the concat stack's Encoder (the MLP
half over sequence chunks, as the JAX concat stack's); the cross stack takes
none, as JAX's (:217-231).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from openvision_tpu_torch.models.attention_module import MultiHeadAttention
import numpy as np

from openvision_tpu_torch.models.encoder import (
    Encoder, EncoderBlock, check_remat_policy, drop_seeds, remat)
from openvision_tpu_torch.models.vit import cast_params, check_param_dtype
from openvision_tpu_torch.models.layers import (Dropout, LayerNorm, MlpBlock, shard_seed,
                                                sharded_head, zero_init)

# Decoder variant table (H/g differ from the text tower).
VARIANTS = {
    "Ti": (192, 12, 768, 3),
    "S": (384, 12, 1536, 6),
    "M": (512, 12, 2048, 8),
    "B": (512, 12, 2048, 8),
    "L": (768, 12, 3072, 12),
    "So400m": (1152, 27, 4304, 16),
    "H": (1024, 24, 4096, 16),
    "g": (1024, 24, 4096, 16),
    "G": (1664, 48, 8192, 16),
    "e": (1792, 56, 15360, 16),
}


def decode_variant(variant: str | None) -> dict:
    if variant is None:
        return {}
    width, depth, mlp_dim, num_heads = VARIANTS[variant]
    return dict(width=width, depth=depth, mlp_dim=mlp_dim, num_heads=num_heads)


class CrossAttnBlock(nn.Module):
    """Pre-LN cross-attention + MLP residual block (queries <- context)."""

    def __init__(self, width: int, num_heads: int, mlp_dim: Optional[int] = None,
                 attn_impl: str = "xla", dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(width, dtype)     # flax LayerNorm_0, the queries
        self.ln_1_kv = LayerNorm(width, dtype)  # flax LayerNorm_1, the context
        self.attn = MultiHeadAttention(width, num_heads, attn_impl=attn_impl,
                                       dropout_rate=dropout, dtype=dtype)
        self.ln_2 = LayerNorm(width, dtype)     # flax LayerNorm_2
        self.mlp = MlpBlock(width, mlp_dim, gelu_approx=True, dropout=dropout, dtype=dtype)
        self.dropout = Dropout(dropout)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                drop_seed: Optional[int] = None) -> torch.Tensor:
        """`drop_seed` (training with dropout), with the batch shard folded
        in, seeds the generator of the block's dropout masks."""
        gen = None if drop_seed is None else torch.Generator(device=x.device).manual_seed(
            shard_seed(drop_seed))
        x = x.to(self.dtype)
        y = self.ln_1(x)
        ctx = self.ln_1_kv(context.to(self.dtype))
        x = x + self.dropout(self.attn(y, ctx, dropout_gen=gen), gen)
        return x + self.dropout(self.mlp(self.ln_2(x), gen), gen)


class CrossAttnStack(nn.Module):
    """Alternating (causal self-attention, cross-attention) pairs."""

    def __init__(self, width: int, depth: int, num_heads: int, mlp_dim: Optional[int] = None,
                 causal: bool = True, attn_impl: str = "xla", remat_policy: str = "none",
                 dropout: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat_policy = check_remat_policy(remat_policy)
        self.depth = depth
        self.drop_rates = [float(r) for r in np.linspace(0.0, drop_path, depth)]
        self.dropout = float(dropout)
        self.resblocks = nn.ModuleList(
            EncoderBlock(width, num_heads, mlp_dim, init_style="scaled", causal=causal,
                         attn_impl=attn_impl, dropout=dropout, drop_path=rate, dtype=dtype)
            for rate in self.drop_rates)
        self.cross_resblocks = nn.ModuleList(
            CrossAttnBlock(width, num_heads, mlp_dim, attn_impl=attn_impl, dropout=dropout,
                           dtype=dtype)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, context: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """With ``train``, the self-attention blocks' seeds, then the
        cross-attention blocks', come from `rng`."""
        seeds = drop_seeds(self.drop_rates, self.dropout, train, rng)
        cross_seeds = drop_seeds([0.0] * self.depth, self.dropout, train, rng)
        for block, cross, seed, cseed in zip(self.resblocks, self.cross_resblocks, seeds,
                                             cross_seeds):
            x = remat(block, x, policy=self.remat_policy, drop_seed=seed)
            x = remat(cross, x, context, policy=self.remat_policy, drop_seed=cseed)
        return x


class TextDecoder(nn.Module):
    """Caption decoder head over (image_tokens, text_tokens) -> f32 logits.

    `image_width` and `text_width` are the widths of the incoming token
    streams (flax infers them from the first input).
    """

    def __init__(self, num_classes: int = 32000, width: int = 512, depth: int = 12,
                 mlp_dim: Optional[int] = None, num_heads: int = 8,
                 fusion_style: str = "concat", causal: bool = True,
                 num_learnable_tokens: int = 80, drop_token: int = 0,
                 attn_impl: str = "xla", image_width: int = 512, text_width: int = 512,
                 remat_policy: str = "none", return_prelogits: bool = False,
                 dropout: float = 0.0, drop_path: float = 0.0, scan_mlp: bool = False,
                 chunk: int = 128, use_dense_general: bool = False, param_dtype=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        param_dtype = check_param_dtype(param_dtype)
        self.image_projection_layer = zero_init(nn.Linear, image_width, width, bias=False)
        self.text_projection_layer = zero_init(nn.Linear, text_width, width, bias=False)
        self.learnable_tokens = nn.Parameter(torch.zeros(num_learnable_tokens, width))
        if fusion_style == "concat":
            self.transformer = Encoder(
                width, depth, num_heads, mlp_dim, init_style="scaled", causal=causal,
                attn_impl=attn_impl, remat_policy=remat_policy, dropout=dropout,
                drop_path=drop_path, scan_mlp=scan_mlp, chunk=chunk,
                use_dense_general=use_dense_general, dtype=dtype)
        elif fusion_style == "cross_attn":  # JAX's cross stack takes no scan_mlp (:217-231)
            if depth % 2:
                raise ValueError("cross_attn fusion needs even depth")
            self.transformer = CrossAttnStack(width, depth // 2, num_heads, mlp_dim,
                                              causal=causal, attn_impl=attn_impl,
                                              remat_policy=remat_policy, dropout=dropout,
                                              drop_path=drop_path, dtype=dtype)
        else:
            raise ValueError(f"Unknown fusion_style: {fusion_style!r}")
        self.decoder_norm = LayerNorm(width)  # f32 out, like flax's default dtype
        self.head = zero_init(nn.Linear, width, num_classes, bias=False)
        self.vocab_parallel = 1  # the tensor axis size head's vocab rows are sharded over
        self.fusion_style = fusion_style
        self.drop_token = drop_token
        self.return_prelogits = return_prelogits
        self.width, self.depth = width, depth
        self.dtype = dtype
        # the modules JAX builds with flax's default f32 params
        cast_params(self, param_dtype, keep=("learnable_tokens", "image_projection_layer.",
                                             "text_projection_layer.", "decoder_norm."))

    def forward(self, image_embeds: torch.Tensor, text_embeds: torch.Tensor,
                train: bool = False, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, Li, Di) image tokens, (N, Lt, Dt) text tokens -> (N, Q, vocab) f32."""
        x = self.prelogits(image_embeds, text_embeds, train=train, rng=rng)
        return sharded_head(x, self.head.weight, None, self.vocab_parallel, transposed=True)

    def prelogits(self, image_embeds: torch.Tensor, text_embeds: torch.Tensor,
                  train: bool = False, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """``decoder_norm``'s output (N, Q, D) f32: what the head reads. With
        ``train`` the dropout and drop-path draws come from `rng`."""
        if self.drop_token > 0:
            image_embeds = image_embeds[:, : image_embeds.shape[1] - self.drop_token + 1]
        n = image_embeds.shape[0]
        image_embeds = image_embeds.float() @ self.image_projection_layer.weight.float().t()
        text_embeds = text_embeds.float() @ self.text_projection_layer.weight.float().t()
        queries = self.learnable_tokens.float().expand(n, -1, -1)
        prefix = torch.cat([image_embeds, text_embeds], dim=1)
        li = prefix.shape[1]
        if self.fusion_style == "concat":
            x = self.transformer(torch.cat([prefix, queries], dim=1), prefix_len=li, train=train,
                                 rng=rng)[:, li:]
        else:
            x = self.transformer(queries, prefix, train=train, rng=rng)
        return self.decoder_norm(x).float()


def Model(num_classes=None, *, variant=None, **kw):
    """Factory mirroring the JAX package's ``Model(variant="L", ...)``,
    reference-config keys translated (``models/compat.py``)."""
    from openvision_tpu_torch.models.compat import translate_model_kwargs

    kw = translate_model_kwargs(kw)
    if num_classes is not None:
        kw["num_classes"] = num_classes
    return TextDecoder(**{**decode_variant(variant), **kw})


def warp_logits(logits: torch.Tensor, *, top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """top-k / top-p (nucleus) logit filtering, as the JAX ``warp_logits``:
    ``top_k`` keeps the k highest logits; ``top_p`` keeps the smallest
    descending-probability prefix whose cumulative probability reaches
    top_p (the top-1 token always kept). Filtered positions get the dtype's
    most negative value."""
    neg = torch.finfo(logits.dtype).min
    if top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        idx = keep.sum(-1, keepdim=True) - 1
        threshold = torch.gather(sorted_logits, -1, idx)
        logits = torch.where(logits < threshold, neg, logits)
    return logits


def sample_ids(logits: torch.Tensor, *, temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy ids (temperature 0) or a draw from softmax(warp(logits / T))."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    if generator is None:
        raise ValueError("sampling needs a torch.Generator")
    logits = warp_logits(logits.float() / temperature, top_k=top_k, top_p=top_p)
    probs = torch.softmax(logits, dim=-1)
    ids = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
    return ids.reshape(logits.shape[:-1])


def mask_after_eos(ids: torch.Tensor, eos_id: int, pad_id: int = 0) -> torch.Tensor:
    """Every id after the first eos becomes pad (the eos itself stays)."""
    is_eos = (ids == eos_id).long()
    seen = torch.cumsum(is_eos, dim=1) - is_eos
    return torch.where(seen > 0, torch.full_like(ids, pad_id), ids)


def generate(decoder: TextDecoder, image_tokens: torch.Tensor, text_tokens: torch.Tensor, *,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             generator: Optional[torch.Generator] = None, eos_id: int = 2,
             pad_id: int = 0) -> torch.Tensor:
    """Caption ids from the query positions in one forward pass: position i's
    logits predict token i+1. Greedy or temperature sampling, optionally
    top-k / top-p filtered; ids after the first eos become `pad_id` (the JAX
    function writes 0; the caption tool passes its tokenizer's pad)."""
    logits = decoder(image_tokens, text_tokens)
    ids = sample_ids(logits, temperature=temperature, top_k=top_k, top_p=top_p,
                     generator=generator)
    return mask_after_eos(ids, eos_id, pad_id)
