"""Multi-head self-attention module.

Counterpart of ``openvision_tpu/models/attention_module.py:MultiHeadAttention``
on its self-attention, non-decode, ``xla`` path. Parameters carry
OpenCLIP's names: ``in_proj_weight`` (3D, D) is the flax query, key and
value kernels transposed and stacked, and ``out_proj`` is the flax ``out``
Dense. The KV-cache decode path, DenseGeneral kernels and the fused and
flash backends are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from openvision_tpu_torch.models.layers import linear, zero_init
from openvision_tpu_torch.ops.attention import xla_attention


class MultiHeadAttention(nn.Module):
    def __init__(self, width: int, num_heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if width % num_heads:
            raise ValueError(f"width {width} is not divisible by {num_heads} heads")
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = zero_init(nn.Linear, width, width)
        self.num_heads = num_heads
        self.causal = causal
        self.dtype = dtype

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, d = x.shape
        qkv = F.linear(x.to(self.dtype), self.in_proj_weight.to(self.dtype),
                       self.in_proj_bias.to(self.dtype))
        q, k, v = (t.reshape(b, l, self.num_heads, d // self.num_heads)
                   for t in qkv.split(d, dim=-1))
        o = xla_attention(q, k, v, mask=mask, causal=self.causal, dtype=self.dtype)
        return linear(o.reshape(b, l, d), self.out_proj, self.dtype)
