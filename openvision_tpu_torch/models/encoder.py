"""Shared pre-LN transformer encoder stack (vision, text and caption decoder).

Counterpart of ``openvision_tpu/models/encoder.py``: ``EncoderBlock`` and
``Encoder`` with causal and prefix-LM masking and the ``fast_gelu`` and
``nomax_softmax`` options. A block runs one of these paths:

- ``xla``: plain PyTorch (LN -> MultiHeadAttention -> residual -> LN ->
  MlpBlock -> residual), the numerics reference; ``flash`` (and ``scan``)
  the same with the attention core on the flash kernel;
- ``fused``: the attention sub-block on the natural-layout block kernels
  (``ops/fused_attention.py``, the JAX package's ``_block_kernel``), under
  the JAX block's eligibility rule (:134-145): no LayerScale and, in
  training, no active drop-path (the port's blocks have no external mask,
  DenseGeneral params, dropout or KV cache). Otherwise the block runs LN ->
  MultiHeadAttention, whose ``fused`` route is ``fused_qkv_attention``
  (the JAX package's ``_kernel`` / ``_qkv_bwd_kernel``), -> out-proj ->
  LayerScale ``ls_1`` -> DropPath -> residual (:171-196), and the MLP half
  likewise with ``ls_2`` (:150-169). The MLP half is XLA in the JAX
  package; here it runs on the ``layernorm`` + ``gemm_bias_act`` kernels
  where its GELU is tanh (the kernel's activation) and the block has no
  LayerScale, and in plain PyTorch otherwise;
- ``fused_t``: both sub-blocks on the kernels of ``ops/fused_encoder.py``,
  taken when ``Encoder._fused_t_eligible`` holds (self-attention, no mask,
  tanh GELU, no LayerScale, and in training no drop-path: :556-584). The
  JAX package runs this on its transposed patch stream;
  here the stream keeps the natural (B, 1+P, D) layout. Where ``fused_t``
  is not eligible the stack runs ``fused`` blocks, as the JAX Encoder
  falls back (:592-616).

The JAX blocks keep tiny sequences (< 32 tokens) off the Pallas kernels on a
TPU, where a block pads the sequence to 128 lanes; the CUDA kernels tile by
64 rows and masks, so the port applies no such guard.

Training (autograd recording): a ``fused`` block's attention half runs the
block's autograd Function (the backward of ``_block_bwd_kernel``), or with
LayerScale or active drop-path ``fused_qkv_attention``'s (the backward of
``_qkv_bwd_kernel``), and its MLP half runs ``MlpBlock`` in plain PyTorch,
where the JAX package runs XLA with no Pallas kernel (:150-164); inference
keeps the MLP kernels. A ``fused_t`` block runs both sub-blocks' autograd
Functions (the backwards of ``_mhsa_t_bwd_kernel`` and
``_mlp_t_bwd_kernel``). The stack's drop-path rates run linspace(0,
drop_path, depth) (:590); in training the stack draws one seed per block
with a rate > 0 from the generator it is given, and the block draws its two
masks (attention, then MLP) from a generator of that seed, so the recompute
under remat draws the same masks. The remat
policies (:395-408, :619-626) wrap each block in
``torch.utils.checkpoint(use_reentrant=False)``: ``full`` saves the block's
input only; ``minimal`` (JAX ``checkpoint_dots_with_no_batch_dims``) saves
the outputs of the matrix products that have no batch dimension, the nearest
PyTorch form being a selective checkpoint that saves ``aten.mm`` and
``aten.addmm`` (the linear layers; the attention einsums, batched over
heads, and the hand-written kernels are recomputed); ``minimal_offloaded``
raises.

Tensor parallelism (weights sharded by ``train/step.py:shard_model``, the
tensor axis of the active mesh): a ``fused`` block's attention half runs
``fused_mhsa_block_tp`` (the JAX ``_tp_block``: #11 and #12 on the rank's
heads) when the heads divide by tensor, and otherwise the one-device block
on the rank's batch rows; the LayerScale / drop-path route takes
``MultiHeadAttention``'s ``_tp_qkv`` counterpart, and the MLP half the
Megatron-sharded ``MlpBlock``. ``fused_t`` under tensor > 1 runs TP
``fused`` blocks and logs a warning, as JAX ``models/encoder.py:564,
593-616``.

Parameters carry OpenCLIP's names (``transformer.resblocks.N.{ln_1, attn,
ln_2, mlp}``, and ``ls_1.gamma`` / ``ls_2.gamma`` with LayerScale). Dropout
(a rate > 0 raises), the scanned MLP, pipelining and the KV cache are not
ported yet.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from openvision_tpu_torch.models.attention_module import MultiHeadAttention
from openvision_tpu_torch.models.layers import DropPath, LayerNorm, LayerScale, MlpBlock
from openvision_tpu_torch.ops.attention import prefix_lm_mask
from openvision_tpu_torch.ops.fused_attention import fused_mhsa_block, fused_mhsa_block_tp
from openvision_tpu_torch.ops.fused_encoder import mhsa_block, mlp_block
from openvision_tpu_torch.parallel import sharded_mesh, tensor_size

_GELU_APPROX = {"vit": False, "scaled": True}  # init_style -> tanh GELU
ATTN_IMPLS = ("xla", "fused", "fused_t", "flash", "scan", "ring")
REMAT_POLICIES = ("none", "full", "minimal", "minimal_offloaded")


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``minimal`` policy: keep the linear layers' products, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def check_remat_policy(policy: str) -> str:
    if policy not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat policy: {policy!r}")
    if policy == "minimal_offloaded":
        raise NotImplementedError(
            "remat policy 'minimal_offloaded' (device-to-host offload of the saved products) "
            "is not ported yet")
    return policy


def recording(module: nn.Module) -> bool:
    """Whether autograd records this call: grad enabled and a parameter needs it."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters())


def remat(fn, *args, policy: str, **kwargs):
    """fn(*args, **kwargs) under the remat `policy` when autograd records."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    if policy == "minimal":
        kwargs["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                 _save_matmuls)
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs)


def check_not_ported(**rates) -> None:
    """Raises for a dropout, drop-path or masking rate > 0 (not ported yet)."""
    for name, rate in rates.items():
        if rate:
            raise NotImplementedError(f"{name}={rate} is not ported yet (only 0 is)")


class EncoderBlock(nn.Module):
    """Pre-LN MHSA + MLP residual block."""

    def __init__(self, width: int, num_heads: int, mlp_dim: Optional[int] = None,
                 init_style: str = "vit", causal: bool = False, attn_impl: str = "xla",
                 fast_gelu: bool = False, nomax_softmax: bool = False, dropout: float = 0.0,
                 drop_path: float = 0.0, init_values: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if init_style not in _GELU_APPROX:
            raise ValueError(f"Unknown init_style: {init_style!r}")
        check_not_ported(dropout=dropout)
        self.gelu_approx = _GELU_APPROX[init_style] or fast_gelu
        self.ln_1 = LayerNorm(width, dtype)
        self.attn = MultiHeadAttention(width, num_heads, attn_impl=attn_impl, dtype=dtype)
        self.ln_2 = LayerNorm(width, dtype)
        self.mlp = MlpBlock(width, mlp_dim, gelu_approx=self.gelu_approx, dtype=dtype)
        if init_values is not None:  # flax ls1 / ls2
            self.ls_1 = LayerScale(width, init_values)
            self.ls_2 = LayerScale(width, init_values)
        self.layer_scale = init_values is not None
        self.drop_path = DropPath(drop_path)
        self.num_heads = num_heads
        self.causal = causal
        self.attn_impl = attn_impl
        self.nomax_softmax = nomax_softmax
        self.dtype = dtype

    def forward(self, x: torch.Tensor, fused_t: bool = False, prefix_len: int = 0,
                drop_seed: Optional[int] = None) -> torch.Tensor:
        """`prefix_len > 0` on a causal block is the prefix-LM mask (the
        caption decoder knows its prefix only from its inputs). `drop_seed`
        (training with a drop-path rate > 0) seeds the generator of this
        block's two drop-path masks."""
        x = x.to(self.dtype)
        if fused_t:
            return self._fused_t_block(x)
        gen = None if drop_seed is None else torch.Generator(device=x.device).manual_seed(
            drop_seed)
        mask, causal, native_prefix = None, self.causal, 0
        if self.causal and prefix_len > 0:
            if self.attn_impl in ("flash", "scan", "fused"):
                native_prefix = prefix_len  # these kernels mask natively
            else:
                mask = prefix_lm_mask(x.shape[0], x.shape[1], prefix_len, x.device)
                causal = False
        # whole-sub-block fusion (:134-145): no LayerScale, no active drop-path
        if self.attn_impl == "fused" and not self.layer_scale and gen is None:
            x = self._fused_attn_subblock(x, causal, native_prefix)
            if self.gelu_approx and not recording(self) and self.mlp.tensor_parallel == 1:
                return self._mlp_subblock_kernels(x)
            return x + self.mlp(self.ln_2(x))
        y = self.attn(self.ln_1(x), mask=mask, causal=causal, prefix_len=native_prefix)
        x = x + self.drop_path(self.ls_1(y) if self.layer_scale else y, gen)
        y = self.mlp(self.ln_2(x))
        return x + self.drop_path(self.ls_2(y) if self.layer_scale else y, gen)

    def _fused_attn_subblock(self, x, causal: bool, prefix_len: int):
        """``_block_kernel``'s sub-block: matrices in the compute dtype,
        LayerNorm parameters and biases in f32 (openvision_tpu/models/
        encoder.py:217-228); with the heads sharded over tensor,
        ``fused_mhsa_block_tp``."""
        dt, f32 = self.dtype, torch.float32
        args = (x.contiguous(),
                self.ln_1.weight.to(f32), self.ln_1.bias.to(f32),
                self.attn.in_proj_weight.to(dt), self.attn.in_proj_bias.to(f32),
                self.attn.out_proj.weight.to(dt), self.attn.out_proj.bias.to(f32))
        kw = dict(num_heads=self.num_heads, causal=causal, prefix_len=prefix_len,
                  eps=self.ln_1.eps)
        if sharded_mesh(self.attn.tensor_parallel) is not None:
            return fused_mhsa_block_tp(*args, **kw)
        return fused_mhsa_block(*args, **kw)

    def _mlp_subblock_kernels(self, x):
        dt, f32 = self.dtype, torch.float32
        return mlp_block(
            x,
            self.ln_2.weight.to(f32), self.ln_2.bias.to(f32),
            self.mlp.c_fc.weight.to(dt), self.mlp.c_fc.bias.to(f32),
            self.mlp.c_proj.weight.to(dt), self.mlp.c_proj.bias.to(f32),
            eps=self.ln_2.eps)

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
        return self._mlp_subblock_kernels(x)


class Encoder(nn.Module):
    """A stack of EncoderBlocks (``resblocks``)."""

    def __init__(self, width: int, depth: int, num_heads: int, mlp_dim: Optional[int] = None,
                 init_style: str = "vit", causal: bool = False, attn_impl: str = "xla",
                 fast_gelu: bool = False, nomax_softmax: bool = False,
                 remat_policy: str = "none", dropout: float = 0.0, drop_path: float = 0.0,
                 init_values: Optional[float] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"Unknown attention impl: {attn_impl!r}")
        check_not_ported(dropout=dropout)
        self.remat_policy = check_remat_policy(remat_policy)
        # an ineligible fused_t stack runs natural-layout fused blocks
        block_impl = "fused" if attn_impl == "fused_t" else attn_impl
        self.drop_rates = [float(r) for r in np.linspace(0.0, drop_path, depth)]  # :590
        self.resblocks = nn.ModuleList(
            EncoderBlock(width, num_heads, mlp_dim, init_style=init_style, causal=causal,
                         attn_impl=block_impl, fast_gelu=fast_gelu,
                         nomax_softmax=nomax_softmax, drop_path=rate,
                         init_values=init_values, dtype=dtype)
            for rate in self.drop_rates)
        self.init_values = init_values
        self.attn_impl = attn_impl
        self.causal = causal
        self.gelu_approx = _GELU_APPROX[init_style] or fast_gelu
        self.dtype = dtype

    def _fused_t_eligible(self, x: torch.Tensor, prefix_len: int, train: bool = False) -> bool:
        """The fused_t kernels take the plain CLIP-vision-encode shape:
        cls-first self-attention with no mask, tanh GELU (the in-kernel
        activation), no LayerScale, and in training no drop-path, as
        ``openvision_tpu/models/encoder.py:556-584``; batch-sharded only (no
        tensor > 1 mesh)."""
        if self.attn_impl == "fused_t" and tensor_size() > 1:
            logging.getLogger(__name__).warning(
                "attn_impl=fused_t is batch-sharded only; tensor=%d mesh active -> using the "
                "TP-aware 'fused' path (natural layout)", tensor_size())
            return False
        return (
            self.attn_impl == "fused_t"
            and x.ndim == 3
            and x.shape[1] >= 2
            and not self.causal
            and prefix_len == 0
            and self.gelu_approx
            and self.init_values is None
            and not (train and any(self.drop_rates))
        )

    def _drop_seeds(self, train: bool, rng: Optional[torch.Generator]) -> list:
        """One seed per block with a drop-path rate > 0 (None elsewhere) in
        training, drawn from `rng`."""
        if not train or not any(self.drop_rates):
            return [None] * len(self.drop_rates)
        if rng is None:
            raise ValueError("drop-path in training needs a torch.Generator (rng=...)")
        seeds = torch.randint(0, 2**62, (len(self.drop_rates),), generator=rng,
                              device=rng.device).tolist()
        return [s if rate else None for s, rate in zip(seeds, self.drop_rates)]

    def forward(self, x: torch.Tensor, prefix_len: int = 0, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """`prefix_len > 0` on a causal stack is the prefix-LM mask; `train`
        turns drop-path on, its masks drawn from `rng`."""
        fused_t = self._fused_t_eligible(x, prefix_len, train)
        x = x.to(self.dtype)
        for block, seed in zip(self.resblocks, self._drop_seeds(train, rng)):
            x = remat(block, x, policy=self.remat_policy, fused_t=fused_t, prefix_len=prefix_len,
                      drop_seed=seed)
        return x


def cast_block_matrices(module: nn.Module, dtype: torch.dtype) -> None:
    """Stores the weight matrices of every attention and MLP under `module`
    in `dtype`, once (what the flax modules cast at every call); LayerNorm
    parameters, biases, embeddings and heads stay f32."""
    if dtype == torch.float32:
        return
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, MultiHeadAttention):
                params = (m.in_proj_weight, m.out_proj.weight)
            elif isinstance(m, MlpBlock):
                params = (m.c_fc.weight, m.c_proj.weight)
            else:
                continue
            for p in params:
                p.data = p.data.to(dtype)
