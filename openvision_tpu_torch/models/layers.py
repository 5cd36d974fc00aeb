"""Shared building blocks: position embeddings, MLP, LayerNorm.

Counterpart of ``openvision_tpu/models/layers.py``. The numeric traps of the
flax modules are kept:

- LayerNorm eps is 1e-6 (flax), not torch's 1e-5;
- the vision MLP uses exact GELU and the text MLP tanh GELU (`gelu_approx`);
- sincos2d follows the MoCo-v3 order sin(x), cos(x), sin(y), cos(y) with a
  zero row prepended for [cls].

Parameters use OpenCLIP's names and torch's (out, in) weight layout, so an
``open_clip_pytorch_model.bin`` loads with ``load_state_dict``. They start
at zero (LayerNorm scales at one, LayerScale at its init value) and draw
nothing from the global RNG: the weights come from a checkpoint or
``models/init.py``. ``DropPath`` and ``Dropout`` draw from an explicit
``torch.Generator``. On a process mesh (``parallel/mesh.py``) each global
row gets a draw of its own, as the JAX step draws over the global batch:
the per-sample draws (drop-path here, token masking in ``models/vit.py``)
are drawn for the global batch and each process keeps its rows
(:func:`global_rows`), so a mesh draws for a row what one process draws
for it; dropout's per-element draws come from a generator with the batch
shard's index folded in (:func:`shard_seed`, :func:`dropout_generator`),
so they differ by batch shard and agree within a tensor group.

Under tensor parallelism (``train/step.py:shard_model``) the MLP is
Megatron-sharded, as the JAX logical rules shard ``mlp`` over ``tensor``
(:159, :173; parallel/mesh.py:45-48): a rank holds its hidden slice of
``c_fc`` (column-parallel) and the matching columns of ``c_proj``
(row-parallel into a partial); one sum over tensor, then the bias.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openvision_tpu_torch.ops.fused_encoder import layernorm_plain
from openvision_tpu_torch.parallel import (active_mesh, copy_to_tensor, gather_from_tensor,
                                           reduce_from_tensor, sharded_mesh)

LN_EPS = 1e-6  # flax nn.LayerNorm default


def shard_seed(seed: int) -> int:
    """`seed` with this process's batch shard folded in (the active mesh's
    ``batch_index``, 0 without one): the seed of per-element draws, which
    differ by batch shard and are equal within a tensor group."""
    mesh = active_mesh()
    index = 0 if mesh is None else mesh.batch_index
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def dropout_generator(generator: Optional[torch.Generator],
                      rate: float) -> Optional[torch.Generator]:
    """The generator of one dropout call's masks: a seed drawn from
    `generator` (one draw, whatever the shape of the masks) with the batch
    shard folded in (:func:`shard_seed`); None without a generator or at
    rate 0, where nothing is drawn."""
    if generator is None or rate == 0.0:
        return None
    seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(shard_seed(seed))


def global_rows(draw, n: int):
    """``draw(rows)`` (a tensor, or a dict of them, with a leading row axis)
    for the global batch of the active mesh, then this process's `n` rows of
    it (``Mesh.batch_rows``): a mesh draws for each row what one process
    draws for it. ``draw(n)`` without a mesh of several batch shards."""
    mesh = active_mesh()
    if mesh is None or mesh.batch_shards == 1:
        return draw(n)
    rows = mesh.batch_rows(n * mesh.batch_shards)
    out = draw(n * mesh.batch_shards)
    return {k: v[rows] for k, v in out.items()} if isinstance(out, dict) else out[rows]


def posemb_sincos_2d(h: int, w: int, width: int, temperature: float = 10_000.0,
                     dtype: torch.dtype = torch.float32, cls_token: bool = False,
                     device=None) -> torch.Tensor:
    """MoCo-v3 style fixed 2-D sincos position embedding, (1, [1+]hw, width)."""
    if width % 4:
        raise ValueError("width must be a multiple of 4 for sincos2d")
    y, x = np.mgrid[:h, :w]
    omega = np.arange(width // 4) / (width // 4 - 1)
    omega = 1.0 / (temperature**omega)
    y = np.einsum("m,d->md", y.flatten(), omega)
    x = np.einsum("m,d->md", x.flatten(), omega)
    pe = np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)], axis=1)
    if cls_token:
        pe = np.concatenate([np.zeros((1, width)), pe], axis=0)
    return torch.as_tensor(pe, dtype=dtype, device=device)[None]


def posemb_sincos_1d(max_len: int, width: int, min_scale: float = 1.0,
                     max_scale: float = 10_000.0, dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """1-D sincos position embedding (sin in the first half of dims, cos second)."""
    pe = np.zeros((max_len, width), dtype=np.float32)
    pos = np.arange(max_len)[:, None]
    half = width // 2
    scale = -np.log(max_scale / min_scale) / (half - 1)
    div = min_scale * np.exp(np.arange(half) * scale)
    pe[:, :half] = np.sin(pos * div)
    pe[:, half:2 * half] = np.cos(pos * div)
    return torch.as_tensor(pe, dtype=dtype, device=device)[None]


class LayerNorm(nn.Module):
    """flax-style LayerNorm: eps 1e-6, f32 statistics, output in `dtype`."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_plain(x.float(), self.weight, self.bias, self.eps).to(self.dtype)


def zero_init(cls, *args, **kwargs) -> nn.Module:
    """`cls(*args, **kwargs)` with zeroed parameters and no RNG draws."""
    module = torch.nn.utils.skip_init(cls, *args, **kwargs)
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
    return module


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=...): inputs, kernel and bias cast to `dtype`."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class MlpBlock(nn.Module):
    """Transformer feed-forward block: Linear -> GELU -> Linear.

    OpenCLIP names: ``c_fc`` (flax Dense_0) and ``c_proj`` (flax Dense_1).
    The GELU is the parameterless submodule ``act``, so a forward hook on it
    sees the activation the JAX block sows as ``intermediates/.../gelu``
    (openvision_tpu/models/layers.py:164-168); the state dict is unchanged.
    """

    def __init__(self, width: int, mlp_dim: Optional[int] = None, gelu_approx: bool = False,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        mlp_dim = mlp_dim or 4 * width
        self.c_fc = zero_init(nn.Linear, width, mlp_dim)
        self.c_proj = zero_init(nn.Linear, mlp_dim, width)
        self.act = nn.GELU(approximate="tanh" if gelu_approx else "none")
        self.gelu_approx = gelu_approx
        self.dropout = Dropout(dropout)
        self.dtype = dtype
        self.tensor_parallel = 1  # the tensor axis size its weights are sharded over

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` (training) draws the dropout mask of the hidden, after
        the GELU (JAX :170)."""
        mesh = sharded_mesh(self.tensor_parallel)
        if mesh is not None:  # the input's gradient sums over the shards
            x = copy_to_tensor(x, mesh)
        h = linear(x, self.c_fc, self.dtype)
        h = self.dropout(self.act(h), generator)
        if mesh is None:
            return linear(h, self.c_proj, self.dtype)
        part = F.linear(h.to(self.dtype), self.c_proj.weight.to(self.dtype))
        return reduce_from_tensor(part, mesh) + self.c_proj.bias.to(self.dtype)


def sharded_head(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 tensor_parallel: int = 1, transposed: bool = False) -> torch.Tensor:
    """``x @ weight (+ bias)`` in f32 (``weight.t()`` with `transposed`,
    torch's (out, in) layout). With `tensor_parallel` > 1 the weight (and
    bias) hold this rank's block of the output features (the JAX rules'
    ``vocab`` axis over ``tensor``): each rank computes its block, the
    blocks are joined over the tensor axis, and the input's gradient sums
    the ranks' parts."""
    mesh = sharded_mesh(tensor_parallel)
    if mesh is not None:
        x = copy_to_tensor(x, mesh)
    w = weight.float()
    y = x.float() @ (w.t() if transposed else w)
    if bias is not None:
        y = y + bias.float()
    return y if mesh is None else gather_from_tensor(y, mesh)


class LayerScale(nn.Module):
    """Per-channel learnable residual scaling (CaiT), the JAX package's
    ``LayerScale`` (openvision_tpu/models/layers.py:181-196): x * gamma, gamma
    (dim,) f32 initialised to `init_values`. The product with the f32 gain
    is f32, as flax promotes a bf16 x. OpenCLIP names it ``ls_N.gamma``; the
    flax path is ``lsN/lsN`` (the param inside module ``ls1`` is also
    called ``ls1``)."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Dropout(nn.Module):
    """flax ``nn.Dropout``: each element kept with probability keep = 1 -
    rate (a U[0, 1) draw in f32 below keep) and scaled by 1 / keep, else 0;
    the draws come from the `generator` given (never the global RNG), one a
    value of `x`. The identity when no generator is given (not training) or
    the rate is 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=generator, device=generator.device,
                       dtype=torch.float32)
        return torch.where((u < keep).to(x.device), x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth, the JAX package's ``DropPath`` (:199-212): drops
    whole residual branches per sample, x / keep * floor(keep + U) with
    keep = 1 - rate and U ~ U[0, 1) in f32, one per sample, drawn from the
    `generator` given (never the global RNG), for the global batch on a
    process mesh (:func:`global_rows`). The identity when no generator is
    given (not training) or the rate is 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        tail = (1,) * (x.ndim - 1)
        u = global_rows(lambda rows: torch.rand((rows,) + tail, generator=generator,
                                                device=generator.device, dtype=torch.float32),
                        x.shape[0])
        return x / keep * torch.floor(keep + u).to(x.device)
