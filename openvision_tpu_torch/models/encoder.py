"""Shared pre-LN transformer encoder stack (vision and text towers).

Counterpart of ``openvision_tpu/models/encoder.py``: ``EncoderBlock`` and
``Encoder`` with the ``fast_gelu`` and ``nomax_softmax`` options. A block
runs one of two paths:

- ``xla``: plain PyTorch (LN -> MultiHeadAttention -> residual -> LN ->
  MlpBlock -> residual), the numerics reference;
- ``fused_t``: the two sub-blocks on the hand-written kernels of
  ``ops/fused_encoder.py``, taken when ``Encoder._fused_t_eligible`` holds
  (self-attention, not causal, tanh GELU -- the in-kernel activation). The
  JAX package runs this on its transposed patch stream; here the stream
  keeps the natural (B, 1+P, D) layout, so no transposes are needed.

Where the JAX Encoder falls back from an ineligible ``fused_t`` to its
natural-layout ``fused`` Pallas block, the port raises: that kernel
(``ops/fused_attention.py:_block_kernel``) is not ported yet.

Parameters carry OpenCLIP's names (``transformer.resblocks.N.{ln_1, attn,
ln_2, mlp}``). LayerScale, DropPath, dropout, the prefix-LM mask, remat,
the scanned MLP, pipelining and the KV cache are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from openvision_tpu_torch.models.attention_module import MultiHeadAttention
from openvision_tpu_torch.models.layers import LayerNorm, MlpBlock
from openvision_tpu_torch.ops.fused_encoder import mhsa_block, mlp_block

_GELU_APPROX = {"vit": False, "scaled": True}  # init_style -> tanh GELU


class EncoderBlock(nn.Module):
    """Pre-LN MHSA + MLP residual block."""

    def __init__(self, width: int, num_heads: int, mlp_dim: Optional[int] = None,
                 init_style: str = "vit", causal: bool = False, fast_gelu: bool = False,
                 nomax_softmax: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if init_style not in _GELU_APPROX:
            raise ValueError(f"Unknown init_style: {init_style!r}")
        self.gelu_approx = _GELU_APPROX[init_style] or fast_gelu
        self.ln_1 = LayerNorm(width, dtype)
        self.attn = MultiHeadAttention(width, num_heads, causal=causal, dtype=dtype)
        self.ln_2 = LayerNorm(width, dtype)
        self.mlp = MlpBlock(width, mlp_dim, gelu_approx=self.gelu_approx, dtype=dtype)
        self.num_heads = num_heads
        self.nomax_softmax = nomax_softmax
        self.dtype = dtype

    def forward(self, x: torch.Tensor, fused_t: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        if fused_t:
            return self._fused_t_block(x)
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def _fused_t_block(self, x: torch.Tensor) -> torch.Tensor:
        """Both sub-blocks on the kernels: matrices in the compute dtype,
        LayerNorm parameters and biases in f32, as the Pallas path feeds its
        kernels (openvision_tpu/models/encoder.py:262-279)."""
        dt, f32 = self.dtype, torch.float32
        x = mhsa_block(
            x.contiguous(),
            self.ln_1.weight.to(f32), self.ln_1.bias.to(f32),
            self.attn.in_proj_weight.to(dt), self.attn.in_proj_bias.to(f32),
            self.attn.out_proj.weight.to(dt), self.attn.out_proj.bias.to(f32),
            num_heads=self.num_heads, eps=self.ln_1.eps, nomax=self.nomax_softmax)
        return mlp_block(
            x,
            self.ln_2.weight.to(f32), self.ln_2.bias.to(f32),
            self.mlp.c_fc.weight.to(dt), self.mlp.c_fc.bias.to(f32),
            self.mlp.c_proj.weight.to(dt), self.mlp.c_proj.bias.to(f32),
            eps=self.ln_2.eps)


class Encoder(nn.Module):
    """A stack of EncoderBlocks (``resblocks``)."""

    def __init__(self, width: int, depth: int, num_heads: int, mlp_dim: Optional[int] = None,
                 init_style: str = "vit", causal: bool = False, attn_impl: str = "xla",
                 fast_gelu: bool = False, nomax_softmax: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_impl not in ("xla", "fused_t"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} is not ported yet (the port runs 'xla' and 'fused_t')")
        self.resblocks = nn.ModuleList(
            EncoderBlock(width, num_heads, mlp_dim, init_style=init_style, causal=causal,
                         fast_gelu=fast_gelu, nomax_softmax=nomax_softmax, dtype=dtype)
            for _ in range(depth))
        self.attn_impl = attn_impl
        self.causal = causal
        self.gelu_approx = _GELU_APPROX[init_style] or fast_gelu
        self.dtype = dtype

    def _fused_t_eligible(self, x: torch.Tensor) -> bool:
        """The fused_t kernels take the plain CLIP-vision-encode shape:
        cls-first self-attention with no mask, and tanh GELU (the in-kernel
        activation), as ``openvision_tpu/models/encoder.py:556``."""
        return (
            self.attn_impl == "fused_t"
            and x.ndim == 3
            and x.shape[1] >= 2
            and not self.causal
            and self.gelu_approx
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused_t = self._fused_t_eligible(x)
        if self.attn_impl == "fused_t" and not fused_t:
            raise NotImplementedError(
                "attn_impl='fused_t' needs a non-causal encoder with tanh GELU "
                "(fast_gelu=True); the JAX package falls back to its natural-layout "
                "'fused' Pallas block here, which is not ported yet")
        x = x.to(self.dtype)
        for block in self.resblocks:
            x = block(x, fused_t=fused_t)
        return x
