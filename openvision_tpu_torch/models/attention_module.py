"""Multi-head attention module: self- and cross-attention.

Counterpart of ``openvision_tpu/models/attention_module.py:MultiHeadAttention``
without the KV-cache decode path. Parameters carry OpenCLIP's names:
``in_proj_weight`` (3D, D) is the flax query, key and value kernels
transposed and stacked, and ``out_proj`` is the flax ``out`` Dense. The
JAX module's ``use_dense_general`` kernels ((D, H, hd) and (H, hd, D)) hold
the same numbers; the port keeps the one layout and ``convert/openclip.py``
reshapes (the caption decoder's cross-attention is always DenseGeneral).
Dispatch follows the JAX module (:97-105, :212-214):

- ``attn_impl="fused"`` on self-attention with no mask and plain-Dense
  params runs ``ops/fused_attention.py:fused_qkv_attention``, the JAX
  package's Pallas ``_kernel`` (#7; its backward ``_qkv_bwd_kernel``, #8),
  then the out-projection. Encoder blocks reach it where the whole-sub-block
  path is not eligible (openvision_tpu/models/encoder.py:134-145): with
  LayerScale, or in training with drop-path > 0 and dropout 0. Active
  dropout turns off both fused paths in the JAX package
  (models/encoder.py:141, models/attention_module.py:103) and runs plain
  attention; the port refuses a dropout rate > 0 by name, so no block with
  dropout reaches #7. DenseGeneral self-attention, which the JAX module
  sends to ``xla`` instead, has no caller in the port.
- otherwise ``fused`` falls to ``xla`` (cross-attention, an external mask),
  and a mask forces ``xla``;
- ``flash`` and ``scan`` run the flash kernel (``ops/attention.py``).

Under tensor parallelism (``train/step.py:shard_model``, when tensor divides
the heads) a rank holds the q, k and v rows of its num_heads/t heads
(``in_proj_weight`` (3 D/t, D)) and the matching columns of ``out_proj``
(D, D/t): the inputs' gradients sum over tensor, the attention runs on the
rank's heads (the ``fused`` route through ``fused_qkv_attention_tp``, the
JAX ``_tp_qkv``), and the out-projection's partial is summed over tensor
before the bias, as the JAX package's GSPMD does with its row-sharded out
kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from openvision_tpu_torch.models.layers import linear, zero_init
from openvision_tpu_torch.ops.attention import dispatch_attention
from openvision_tpu_torch.ops.fused_attention import fused_qkv_attention, fused_qkv_attention_tp
from openvision_tpu_torch.parallel import copy_to_tensor, reduce_from_tensor, sharded_mesh


class MultiHeadAttention(nn.Module):
    def __init__(self, width: int, num_heads: int, attn_impl: str = "xla",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if width % num_heads:
            raise ValueError(f"width {width} is not divisible by {num_heads} heads")
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = zero_init(nn.Linear, width, width)
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.tensor_parallel = 1  # the tensor axis size its heads are sharded over

    def forward(self, inputs_q: torch.Tensor, inputs_kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None, *, causal: bool = False,
                prefix_len: int = 0) -> torch.Tensor:
        """inputs_kv=None is self-attention; `mask` broadcasts to (B, H, Lq,
        Lk); `causal` with `prefix_len > 0` is the prefix-LM mask."""
        self_attn = inputs_kv is None or inputs_kv is inputs_q
        b, lq, _ = inputs_q.shape
        dt = self.dtype
        mesh = sharded_mesh(self.tensor_parallel)
        num_heads = self.num_heads // self.tensor_parallel
        d = self.in_proj_weight.shape[0] // 3  # D, or D/t on a tensor shard
        if self.attn_impl == "fused" and self_attn and mask is None:
            # the JAX module's fused route (:97-134): q/k/v weights in the
            # compute dtype, their biases f32 (the param dtype)
            args = (inputs_q.to(dt).contiguous(), self.in_proj_weight.to(dt),
                    self.in_proj_bias.float())
            kw = dict(num_heads=self.num_heads, causal=causal, prefix_len=prefix_len)
            o = fused_qkv_attention(*args, **kw) if mesh is None else \
                fused_qkv_attention_tp(*args, **kw)
            return self._out_proj(o, mesh)
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        xq = inputs_q.to(dt)
        if mesh is not None:  # the inputs' gradients sum over the shards
            xq = copy_to_tensor(xq, mesh)
        if self_attn:
            q, k, v = F.linear(xq, w, bias).split(d, dim=-1)
        else:
            xkv = inputs_kv.to(dt)
            if mesh is not None:
                xkv = copy_to_tensor(xkv, mesh)
            q = F.linear(xq, w[:d], bias[:d])
            k, v = F.linear(xkv, w[d:], bias[d:]).split(d, dim=-1)
        heads = lambda t: t.reshape(t.shape[0], t.shape[1], num_heads, d // num_heads)
        q, k, v = heads(q), heads(k), heads(v)

        # a mask, or fused with its preconditions unmet: the unfused xla path
        impl = "xla" if mask is not None or self.attn_impl == "fused" else self.attn_impl
        o = dispatch_attention(impl, q, k, v, mask=mask, causal=causal, prefix_len=prefix_len,
                               dtype=dt)
        return self._out_proj(o.reshape(b, lq, d), mesh)

    def _out_proj(self, o: torch.Tensor, mesh) -> torch.Tensor:
        """The out-projection; on a tensor shard the partial of its heads,
        summed over tensor, then the bias."""
        if mesh is None:
            return linear(o, self.out_proj, self.dtype)
        part = F.linear(o.to(self.dtype), self.out_proj.weight.to(self.dtype))
        return reduce_from_tensor(part, mesh) + self.out_proj.bias.to(self.dtype)
