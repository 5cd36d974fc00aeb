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
  training, no active drop-path or dropout (the port's blocks have no
  external mask, DenseGeneral params or KV cache). Otherwise the block runs LN ->
  MultiHeadAttention, whose ``fused`` route is ``fused_qkv_attention``
  (the JAX package's ``_kernel`` / ``_qkv_bwd_kernel``), -> out-proj ->
  LayerScale ``ls_1`` -> DropPath -> residual (:171-196), and the MLP half
  likewise with ``ls_2`` (:150-169). The MLP half is XLA in the JAX
  package; here it runs on the ``layernorm`` + ``gemm_bias_act`` kernels
  where its GELU is tanh (the kernel's activation) and the block has no
  LayerScale, and in plain PyTorch otherwise;
- ``fused_t``: both sub-blocks on the kernels of ``ops/fused_encoder.py``,
  taken when ``Encoder._fused_t_eligible`` holds (self-attention, no mask,
  tanh GELU, no LayerScale, and in training no drop-path or dropout:
  :556-584). The
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
with a drop-path rate > 0 or a dropout rate > 0 from the generator it is
given, and the block draws its drop-path masks from a generator of that
seed (for the global batch on a process mesh) and its dropout masks from
one of that seed with the batch shard folded in (``layers.shard_seed``),
so the recompute under remat draws the same masks. Dropout (:160-194)
takes the attention probabilities (``xla`` attention, one (Lq, Lk) mask),
the attention branch's output, the MLP's hidden after its GELU and the MLP
branch's output, each before LayerScale and drop-path, in that order. The remat
policies (:395-408, :619-626) wrap each block in
``torch.utils.checkpoint(use_reentrant=False)``: ``full`` saves the block's
input only; ``minimal`` (JAX ``checkpoint_dots_with_no_batch_dims``) saves
the outputs of the matrix products that have no batch dimension, the nearest
PyTorch form being a selective checkpoint that saves ``aten.mm`` and
``aten.addmm`` (the linear layers; the attention einsums, batched over
heads, and the hand-written kernels are recomputed); ``minimal_offloaded``
(JAX ``offload_dot_with_no_batch_dims`` to ``pinned_host``) keeps the same
products, but in pinned host memory: each is copied out on a side stream
as the forward makes it (the device copy is then freed with the forward's
other intermediates) and copied back for the backward's recompute, which
uses it in place of the product (``_OffloadSaves`` / ``_FetchSaves``, the
two dispatch modes of the checkpoint's ``context_fn``). The gradients are
``minimal``'s; the device holds no saved product between the passes. On
the CPU the copy is a host-to-host clone.

Tensor parallelism (weights sharded by ``train/step.py:shard_model``, the
tensor axis of the active mesh): a ``fused`` block's attention half runs
``fused_mhsa_block_tp`` (the JAX ``_tp_block``: #11 and #12 on the rank's
heads) when the heads divide by tensor, and otherwise the one-device block
on the rank's batch rows; the LayerScale / drop-path route takes
``MultiHeadAttention``'s ``_tp_qkv`` counterpart, and the MLP half the
Megatron-sharded ``MlpBlock``. ``fused_t`` under tensor > 1 runs TP
``fused`` blocks and logs a warning, as JAX ``models/encoder.py:564,
593-616``.

The model options (:77-99, :411-432):

- ``scan_mlp`` with ``chunk``: the MLP half over sequence chunks of
  ``chunk`` tokens, JAX's ``_blockwise_mlp`` (:371-388), which chunks only
  when ``chunk`` divides the length and is not all of it (so a 257-token
  tower runs whole); ``fused_t`` is not eligible under it (:581) and the
  stack runs ``fused`` blocks, whose MLP kernels (``mlp_block``) take the
  chunks one after the other. Each chunk's dropout draws come from the
  block's generator in turn (the JAX scan splits its key per chunk: other
  numbers, the same function of given draws);
- ``decode``: the KV cache of every block's attention
  (``attention_module.py``), sized and zeroed by :meth:`Encoder.init_cache`;
  the fused routes and the prefix-LM mask are off under it (:113, :138,
  :578), the cache mask takes causality's place;
- ``use_dense_general``: the JAX attention's DenseGeneral kernels hold the
  same numbers in another layout (``convert/openclip.py`` reshapes them);
  as in JAX, the fused routes are off under it (:139, :577).

Pipeline parallelism (:436-475, :499-552, :588-589): under an active mesh
with pipe > 1 the stack runs through ``ops/pipeline_parallel.py`` when
:meth:`Encoder._pipe_eligible` holds (pipe divides the depth; attn_impl
xla, scan or flash; no drop-path, no decode, no active dropout; rows to
split), else in sequence, with a warning for an impl that cannot ride the
pipe. The microbatches are ``pipe_microbatches`` (0: 2 P), clipped to the
process's rows and lowered until they divide them, the chunks a stage
``pipe_interleave`` (0: 2; 1 where P v does not divide the depth), and
``remat`` wraps each block as in the sequential stack. Every pipe rank
holds every block, so the parameters and their names are the sequential
stack's; :attr:`Encoder.pipelined` says whether the last call ran the
pipeline (its blocks' gradients then sum over ``pipe``, ``train/step.py``).

Sequence parallelism (JAX's ``activation_length`` rule,
``openvision_tpu/parallel/mesh.py:43``, applied at every block boundary):
under an active mesh with seq > 1 a stack whose attention is ``ring``
(:meth:`Encoder._seq_eligible`) pads its L to a multiple of seq and keeps
this rank's chunk once at entry (``parallel.enter_seq``), runs every
block's LN, QKV, MLP, residual, drop-path and dropout on the chunk, the
ring on the local chunks (``ring_attention_sharded``: the causal and
pad-key masks on global positions), and joins the chunks once at exit
(``parallel.exit_seq``), so the pools see whole tokens. A dropout draws the
whole sequence's mask and keeps its chunk (``layers.Dropout``), drop-path
draws per sample as before. The blocks' parameters then get a partial
gradient on each seq rank (:attr:`Encoder.seq_sharded`; summed over
``seq`` in ``train/step.py``), while the embeddings before the entry and
the pool and heads after the exit keep whole, equal gradients. A stack on
any other attention keeps whole tokens under seq > 1: its kernels need
the whole sequence.

Parameters carry OpenCLIP's names (``transformer.resblocks.N.{ln_1, attn,
ln_2, mlp}``, and ``ls_1.gamma`` / ``ls_2.gamma`` with LayerScale).
"""

from __future__ import annotations

import functools
import logging
import warnings
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt
from torch.utils._python_dispatch import TorchDispatchMode

from openvision_tpu_torch.models.attention_module import MultiHeadAttention
from openvision_tpu_torch.models.layers import (DropPath, Dropout, LayerNorm, LayerScale, MlpBlock,
                                               shard_seed)
from openvision_tpu_torch.ops.attention import prefix_lm_mask
from openvision_tpu_torch.ops.fused_attention import fused_mhsa_block, fused_mhsa_block_tp
from openvision_tpu_torch.ops.fused_encoder import mhsa_block, mlp_block
from openvision_tpu_torch.ops.pipeline_parallel import pipeline_apply
from openvision_tpu_torch.parallel import (active_mesh, enter_seq, exit_seq, sharded_mesh,
                                           tensor_size)

_GELU_APPROX = {"vit": False, "scaled": True}  # init_style -> tanh GELU
ATTN_IMPLS = ("xla", "fused", "fused_t", "flash", "scan", "ring")
REMAT_POLICIES = ("none", "full", "minimal", "minimal_offloaded")


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``minimal`` policy: keep the linear layers' products, recompute the rest."""
    if op in _MATMULS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_SIDE_STREAMS: dict = {}  # device -> the stream the offload copies run on


def _offload(t: torch.Tensor):
    """(host copy, the copy's event or None, device) of a saved product: a
    CUDA tensor goes to pinned host memory on a side stream (after the
    current stream's work that made it; its memory kept until the copy is
    done), a CPU tensor is cloned."""
    if not t.is_cuda:
        return t.clone(), None, t.device
    stream = _SIDE_STREAMS.get(t.device)
    if stream is None:
        stream = _SIDE_STREAMS[t.device] = torch.cuda.Stream(t.device)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    stream.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(stream):
        host.copy_(t, non_blocking=True)
    t.record_stream(stream)
    return host, stream.record_event(), t.device


def _fetch(saved) -> torch.Tensor:
    """The product back on its device (the current stream waits for its
    offload copy first)."""
    host, event, device = saved
    if event is None:
        return host
    torch.cuda.current_stream(device).wait_event(event)
    return host.to(device, non_blocking=True)


class _OffloadSaves(TorchDispatchMode):
    """``minimal_offloaded``'s forward: each linear product (aten.mm /
    addmm) is copied to the host (:func:`_offload`) into `store`, by op and
    call index."""

    def __init__(self, store: dict):
        super().__init__()
        self.store, self.calls = store, defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _MATMULS:
            self.store[func, self.calls[func]] = _offload(out)
            self.calls[func] += 1
        return out


class _FetchSaves(TorchDispatchMode):
    """``minimal_offloaded``'s recompute: the linear products come back from
    `store` (:func:`_fetch`) in place of being computed; the rest runs."""

    def __init__(self, store: dict):
        super().__init__()
        self.store, self.calls = store, defaultdict(int)

    def __enter__(self):
        self.calls.clear()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MATMULS:
            key = func, self.calls[func]
            self.calls[func] += 1
            return _fetch(self.store.pop(key))
        return func(*args, **(kwargs or {}))


def _offload_contexts():
    store: dict = {}
    return _OffloadSaves(store), _FetchSaves(store)


def check_remat_policy(policy: str) -> str:
    if policy not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat policy: {policy!r}")
    return policy


def blockwise(fn, x: torch.Tensor, chunk: int) -> torch.Tensor:
    """fn over (B, L, D) x in sequence chunks of `chunk` tokens, JAX's
    ``_blockwise_mlp`` (openvision_tpu/models/encoder.py:371-388): whole when
    `chunk` does not divide L or is all of it."""
    length = x.shape[1]
    if length % chunk or length == chunk:
        return fn(x)
    return torch.cat([fn(c.contiguous()) for c in x.split(chunk, dim=1)], dim=1)


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
    elif policy == "minimal_offloaded":
        kwargs["context_fn"] = _offload_contexts
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs)


class EncoderBlock(nn.Module):
    """Pre-LN MHSA + MLP residual block."""

    def __init__(self, width: int, num_heads: int, mlp_dim: Optional[int] = None,
                 init_style: str = "vit", causal: bool = False, attn_impl: str = "xla",
                 fast_gelu: bool = False, nomax_softmax: bool = False, dropout: float = 0.0,
                 drop_path: float = 0.0, init_values: Optional[float] = None,
                 scan_mlp: bool = False, chunk: int = 128, decode: bool = False,
                 use_dense_general: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if init_style not in _GELU_APPROX:
            raise ValueError(f"Unknown init_style: {init_style!r}")
        self.gelu_approx = _GELU_APPROX[init_style] or fast_gelu
        self.ln_1 = LayerNorm(width, dtype)
        self.attn = MultiHeadAttention(width, num_heads, attn_impl=attn_impl,
                                       dropout_rate=dropout, dtype=dtype, decode=decode)
        self.ln_2 = LayerNorm(width, dtype)
        self.mlp = MlpBlock(width, mlp_dim, gelu_approx=self.gelu_approx, dropout=dropout,
                            dtype=dtype)
        self.dropout = Dropout(dropout)
        if init_values is not None:  # flax ls1 / ls2
            self.ls_1 = LayerScale(width, init_values)
            self.ls_2 = LayerScale(width, init_values)
        self.layer_scale = init_values is not None
        self.drop_path = DropPath(drop_path)
        self.num_heads = num_heads
        self.causal = causal
        self.attn_impl = attn_impl
        self.nomax_softmax = nomax_softmax
        self.scan_mlp, self.chunk = scan_mlp, int(chunk)
        self.decode = decode
        self.use_dense_general = use_dense_general
        self.dtype = dtype

    def _mlp(self, fn, x: torch.Tensor) -> torch.Tensor:
        """fn over x, in sequence chunks under ``scan_mlp``."""
        return blockwise(fn, x, self.chunk) if self.scan_mlp else fn(x)

    def forward(self, x: torch.Tensor, fused_t: bool = False, prefix_len: int = 0,
                drop_seed: Optional[int] = None, seq_chunk=None) -> torch.Tensor:
        """`prefix_len > 0` on a causal block is the prefix-LM mask (the
        caption decoder knows its prefix only from its inputs). `drop_seed`
        (training with a drop-path or dropout rate > 0) seeds the generator
        of this block's dropout and drop-path masks. `seq_chunk`
        (``parallel.SeqChunk``): `x` holds this rank's tokens of a
        sequence-sharded ``ring`` stack (:meth:`Encoder.forward`)."""
        x = x.to(self.dtype)
        if fused_t:
            return self._fused_t_block(x)
        gen = dgen = None
        if drop_seed is not None:  # drop-path's per-sample draws; dropout's per-element ones
            gen = torch.Generator(device=x.device).manual_seed(drop_seed)
            dgen = torch.Generator(device=x.device).manual_seed(shard_seed(drop_seed))
        mask, causal, native_prefix = None, self.causal, 0
        if self.causal and prefix_len > 0 and not self.decode:
            if self.attn_impl in ("flash", "scan", "fused"):
                native_prefix = prefix_len  # these kernels mask natively
            else:
                mask = prefix_lm_mask(x.shape[0], x.shape[1], prefix_len, x.device)
                causal = False
        # whole-sub-block fusion (:134-145): no LayerScale, no active drop-path
        # or dropout, no KV cache, no DenseGeneral params
        if (self.attn_impl == "fused" and not self.layer_scale and gen is None
                and not self.decode and not self.use_dense_general):
            x = self._fused_attn_subblock(x, causal, native_prefix)
            if self.gelu_approx and not recording(self) and self.mlp.tensor_parallel == 1:
                return self._mlp(self._mlp_subblock_kernels, x)
            return x + self._mlp(self.mlp, self.ln_2(x))
        y = self.attn(self.ln_1(x), mask=mask, causal=causal, prefix_len=native_prefix,
                      dropout_gen=dgen, seq_chunk=seq_chunk)
        y = self.dropout(y, dgen, seq_chunk)
        x = x + self.drop_path(self.ls_1(y) if self.layer_scale else y, gen)
        y = self.dropout(self._mlp(lambda t: self.mlp(t, dgen, seq_chunk), self.ln_2(x)), dgen,
                         seq_chunk)
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
                 init_values: Optional[float] = None, scan_mlp: bool = False, chunk: int = 128,
                 decode: bool = False, use_dense_general: bool = False,
                 pipe_microbatches: int = 0, pipe_interleave: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"Unknown attention impl: {attn_impl!r}")
        self.remat_policy = check_remat_policy(remat_policy)
        if remat_policy in ("minimal", "minimal_offloaded") and attn_impl in ("fused", "fused_t"):
            logging.getLogger(__name__).warning(
                "remat=%s saves only aten.mm/addmm products; attn_impl=%s runs its products "
                "in the port's own kernels, so the policy saves nothing and acts as 'full'",
                remat_policy, attn_impl)
        # an ineligible fused_t stack runs natural-layout fused blocks
        block_impl = "fused" if attn_impl == "fused_t" else attn_impl
        self.drop_rates = [float(r) for r in np.linspace(0.0, drop_path, depth)]  # :590
        self.resblocks = nn.ModuleList(
            EncoderBlock(width, num_heads, mlp_dim, init_style=init_style, causal=causal,
                         attn_impl=block_impl, fast_gelu=fast_gelu,
                         nomax_softmax=nomax_softmax, dropout=dropout, drop_path=rate,
                         init_values=init_values, scan_mlp=scan_mlp, chunk=chunk, decode=decode,
                         use_dense_general=use_dense_general, dtype=dtype)
            for rate in self.drop_rates)
        self.dropout = float(dropout)
        self.drop_path = float(drop_path)
        self.pipe_microbatches, self.pipe_interleave = int(pipe_microbatches), int(pipe_interleave)
        self.pipelined = False  # whether the last call ran the pipeline
        self.seq_sharded = False  # whether the last call kept its tokens sharded over seq
        self.init_values = init_values
        self.attn_impl = attn_impl
        self.scan_mlp, self.decode, self.use_dense_general = scan_mlp, decode, use_dense_general
        self.causal = causal
        self.gelu_approx = _GELU_APPROX[init_style] or fast_gelu
        self.dtype = dtype

    def _fused_t_eligible(self, x: torch.Tensor, prefix_len: int, train: bool = False) -> bool:
        """The fused_t kernels take the plain CLIP-vision-encode shape:
        cls-first self-attention with no mask, tanh GELU (the in-kernel
        activation), no LayerScale, no scanned MLP, KV cache or DenseGeneral
        params, and in training no drop-path, as
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
            and not self.scan_mlp
            and not self.decode
            and not self.use_dense_general
            and not (train and (any(self.drop_rates) or self.dropout))
        )

    def _pipe_eligible(self, x: torch.Tensor, train: bool) -> bool:
        """The pipeline applies (JAX :436-475) under a mesh with pipe > 1
        dividing the depth, when the blocks are functions of their own
        parameters (no drop-path schedule, no active dropout, no KV cache)
        on an impl that rides the pipe (xla, scan, flash), and the process
        holds rows to split into microbatches (JAX: the global batch
        divides over the data axes, which holds for any rows the mesh
        split). An impl that cannot ride it warns, as in JAX."""
        mesh = active_mesh()
        if mesh is None or mesh.pipe <= 1:
            return False
        eligible = (
            self.depth % mesh.pipe == 0
            and x.ndim == 3
            and self.attn_impl in ("xla", "scan", "flash")
            and self.drop_path == 0.0
            and not self.decode
            and (not train or self.dropout == 0.0)
            and x.shape[0] >= 1
        )
        if not eligible and self.attn_impl not in ("xla", "scan", "flash"):
            warnings.warn(
                f"mesh has pipe={mesh.pipe} but attn_impl={self.attn_impl!r} is not "
                "pipeline-eligible (the fused kernels run whole blocks); running the block "
                "stack sequentially: the pipe axis does no useful work. Use attn_impl in "
                "('xla', 'scan', 'flash') with pipe parallelism.", stacklevel=3)
        return eligible

    @property
    def depth(self) -> int:
        return len(self.resblocks)

    def _pipelined(self, x: torch.Tensor, prefix_len: int) -> torch.Tensor:
        """The stack through ``pipeline_apply`` (JAX :499-552): m
        microbatches of this process's rows, v chunks a stage, ``remat``
        around each block."""
        mesh = active_mesh()
        n_stages = mesh.pipe
        m = self.pipe_microbatches or 2 * n_stages
        m = max(1, min(m, x.shape[0]))
        while x.shape[0] % m:
            m -= 1
        v = self.pipe_interleave or 2
        if self.depth % (n_stages * v):
            v = 1

        def block_fn(block, h):
            return remat(block, h, policy=self.remat_policy, prefix_len=prefix_len)

        return pipeline_apply(block_fn, list(self.resblocks), x, mesh, num_microbatches=m,
                              interleave=v)

    def init_cache(self, batch: int, max_len: int) -> None:
        """Zeroes every block's KV cache (``decode``) for `batch` sequences
        of up to `max_len` positions; each forward call then takes the next
        position."""
        for block in self.resblocks:
            block.attn.init_cache(batch, max_len)

    def _drop_seeds(self, train: bool, rng: Optional[torch.Generator]) -> list:
        """One seed per block with a drop-path or dropout rate > 0 (None
        elsewhere) in training, drawn from `rng`."""
        return drop_seeds(self.drop_rates, self.dropout, train, rng)

    def forward(self, x: torch.Tensor, prefix_len: int = 0, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """`prefix_len > 0` on a causal stack is the prefix-LM mask; `train`
        turns drop-path on, its masks drawn from `rng`."""
        self.pipelined = self._pipe_eligible(x, train)
        if self.pipelined:
            return self._pipelined(x.to(self.dtype), prefix_len)
        self.seq_sharded = self._seq_eligible(prefix_len, train)
        fused_t = self._fused_t_eligible(x, prefix_len, train)
        x, chunk = x.to(self.dtype), None
        if self.seq_sharded:  # this rank's tokens from here to the exit
            x, chunk = enter_seq(x, active_mesh())
        for block, seed in zip(self.resblocks, self._drop_seeds(train, rng)):
            x = remat(block, x, policy=self.remat_policy, fused_t=fused_t, prefix_len=prefix_len,
                      drop_seed=seed, seq_chunk=chunk)
        return exit_seq(x, active_mesh(), chunk) if self.seq_sharded else x

    def _seq_eligible(self, prefix_len: int, train: bool) -> bool:
        """The stack keeps its tokens sharded over ``seq`` (JAX's
        ``activation_length`` rule, ``openvision_tpu/parallel/mesh.py:43``)
        under a mesh with seq > 1 when its attention is ``ring``: no KV
        cache, no prefix-LM mask (the ring refuses it), and no scanned MLP
        with dropout in training (its draws go by JAX's chunks of the
        whole sequence). Any other stack keeps whole tokens: its attention
        kernels need the whole sequence."""
        mesh = active_mesh()
        return (mesh is not None and mesh.seq > 1 and self.attn_impl == "ring"
                and not self.decode and prefix_len == 0
                and not (train and self.scan_mlp and self.dropout))


def drop_seeds(rates, dropout: float, train: bool, rng: Optional[torch.Generator]) -> list:
    """One seed per block (drop-path `rates`, one a block) whose drop-path
    rate or `dropout` is > 0, None elsewhere or outside training; the seeds
    of all blocks are drawn from `rng` at once."""
    if not train or not (any(rates) or dropout):
        return [None] * len(rates)
    if rng is None:
        raise ValueError("drop-path or dropout in training needs a torch.Generator (rng=...)")
    seeds = torch.randint(0, 2**62, (len(rates),), generator=rng, device=rng.device).tolist()
    return [s if rate or dropout else None for s, rate in zip(seeds, rates)]


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
