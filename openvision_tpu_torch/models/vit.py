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
(``init_values``, :190), stochastic depth (``drop_path``) and ``dropout``,
whose masks come from the generator ``forward`` is given with ``train``.

In training (:276-287) the embedded tokens (after the position embedding,
in the compute dtype) take the dropout, then, with ``mask_ratio > 0``, MAE
token masking: the cls token is kept and the patch tokens are cut to
``int(P * (1 - mask_ratio))`` by :func:`random_token_masking` (modes
``random``, ``square`` and ``per2x2_random_grid``, :88-173), so the encoder
and the caption decoder see the kept tokens only. The draws
(:func:`draw_masking`) come from the generator, on a process mesh for the
global batch with this process's rows kept; the masking itself is a
function of given draws, the same function as the JAX one on the same draws.

:func:`resample_posemb` (:373-385) and :func:`resize_patch_kernel` (the
patch-kernel resize of the trainer's ``load_transform``) resize as
``jax.image.resize(..., "bilinear")`` does: a triangle filter that
antialiases when it shrinks (:func:`resize_bilinear_aa`).

The model options (:192-210): ``patch_embedding`` ``stem`` (three 3x3 convs
of 96, 192 and 384 channels at strides 1, 2, 2 with SAME padding, each
followed by a LayerNorm and flax's default tanh GELU, then a 1x1 conv of
``width`` channels: ``stem.N``, ``stem_norm.N`` and ``conv1``; the grid is
the image over 4) or ``linear`` (the ``nhpwqc`` patch order into one Dense,
``embedding``), both in f32 as flax runs them on f32 parameters;
``post_norm`` (the image normalized by ``mean`` and ``std`` in its own
dtype first); ``final_drop`` (dropout on the pooled row before the head,
in training); ``pool_type="map"`` (:class:`MAPHead`); and ``scan_mlp``,
``chunk`` and ``use_dense_general``, which pass to the Encoder.
``param_dtype`` (float32 or bfloat16) is the dtype the parameters are
stored in, as flax's: all but cls, the position embedding and the MAP head,
which JAX creates in f32 (:func:`cast_params`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openvision_tpu_torch.models.attention_module import MultiHeadAttention
from openvision_tpu_torch.models.encoder import Encoder
from openvision_tpu_torch.models.layers import (Dropout, LayerNorm, MlpBlock, dropout_generator,
                                                global_rows, posemb_sincos_2d, sharded_head,
                                                zero_init)

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


PATCH_EMBEDDINGS = ("conv", "stem", "linear")
STEM_WIDTHS, STEM_STRIDES = (96, 192, 384), (1, 2, 2)  # JAX :238-250


PARAM_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16,
                torch.float32: torch.float32, torch.bfloat16: torch.bfloat16}


def check_param_dtype(param_dtype) -> torch.dtype:
    """The dtype the towers store their parameters in (the flax modules'
    ``param_dtype``): float32 (the default) or bfloat16; another raises."""
    if param_dtype not in PARAM_DTYPES:
        raise NotImplementedError(f"param_dtype={param_dtype!r}: the port stores parameters in "
                                  "float32 or bfloat16")
    return PARAM_DTYPES[param_dtype]


def cast_params(module: nn.Module, dtype: torch.dtype, keep=()) -> None:
    """Stores `module`'s parameters in `dtype` (values rounded once), but
    those whose names start with one of `keep` (the JAX modules that create
    theirs in f32 whatever ``param_dtype`` says). The layers cast a weight
    to the compute dtype at use, so a bf16 weight enters a bf16 product as
    it is."""
    if dtype == torch.float32:
        return
    for name, p in module.named_parameters():
        if not name.startswith(tuple(keep)):
            p.data = p.data.to(dtype)


class MAPHead(nn.Module):
    """Multihead attention pooling, the JAX ``MAPHead`` (:65-83): a learned
    probe token attends over all tokens (flax ``MultiHeadDotProductAttention``,
    XLA attention with biases), then a LayerNorm and an exact-GELU
    ``MlpBlock`` with a residual; the probe's row. The probe is rounded to
    the tokens' dtype (flax creates it in ``x.dtype``); the rest runs in f32,
    flax's promotion of those tokens with f32 parameters. Names: ``probe``
    (1, 1, D), ``attn`` (flax MultiHeadDotProductAttention_0, DenseGeneral
    kernels reshaped), ``ln_1`` (LayerNorm_0), ``mlp`` (MlpBlock_0)."""

    def __init__(self, width: int, num_heads: int, mlp_dim: Optional[int] = None):
        super().__init__()
        self.probe = nn.Parameter(torch.zeros(1, 1, width))
        self.attn = MultiHeadAttention(width, num_heads)
        self.ln_1 = LayerNorm(width)
        self.mlp = MlpBlock(width, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        probe = self.probe.to(x.dtype).float().expand(x.shape[0], 1, -1)
        y = self.attn(probe, x.float())
        y = y + self.mlp(self.ln_1(y))
        return y[:, 0]


def _same_pad(size: int, kernel: int, stride: int) -> tuple:
    """XLA's SAME padding of one axis: (low, high) for ceil(size / stride) outputs."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


# (mask_ratio -> candidate window heights, widths) of the 'square' mode on a
# 14x14 grid (JAX :76-86).
_SQUARE_WINDOWS = {
    0.5: ([3, 14], [14, 3]),
    0.25: ([16, 12], [12, 16]),
    0.525: ([11], [11]),
    0.4375: ([12], [12]),
    0.75: ([7], [7]),
    0.816: ([4, 6, 9], [9, 6, 4]),
    0.875: ([2, 3, 4, 6, 8, 12], [12, 8, 6, 4, 3, 2]),
    0.918: ([2, 4, 8], [8, 4, 2]),
}
MASK_MODES = ("random", "square", "per2x2_random_grid")


def _keep_by_noise(x: torch.Tensor, noise: torch.Tensor, len_keep: int):
    """Keeps each sample's `len_keep` lowest-noise tokens (a stable sort, as
    jnp.argsort): (kept tokens, mask (1 = dropped), ids_restore)."""
    n, l, d = x.shape
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, d))
    mask = torch.ones(n, l, device=x.device)
    mask[:, :len_keep] = 0
    return x_masked, torch.gather(mask, 1, ids_restore), ids_restore


def draw_masking(mask_mode: str, mask_ratio: float, n: int, height: int, width: int,
                 generator: torch.Generator) -> dict:
    """The draws of one masking call, from `generator`: ``random`` noise (n,
    L) in [0, 1); ``square`` a window index, top and left (n,) each;
    ``per2x2_random_grid`` scores (n, h/2, w/2, 4) in [0, 1)."""
    dev = generator.device
    if mask_mode == "random":
        return {"noise": torch.rand(n, height * width, generator=generator, device=dev)}
    if mask_mode == "square":
        hs, _ = _SQUARE_WINDOWS[mask_ratio]
        return {"pick": torch.randint(0, len(hs), (n,), generator=generator, device=dev),
                "top": torch.randint(0, height, (n,), generator=generator, device=dev),
                "left": torch.randint(0, width, (n,), generator=generator, device=dev)}
    if mask_mode == "per2x2_random_grid":
        return {"scores": torch.rand(n, height // 2, width // 2, 4, generator=generator,
                                     device=dev)}
    raise ValueError(f"Unknown mask_mode: {mask_mode!r}")


def masking_noise(mask_mode: str, mask_ratio: float, height: int, width: int,
                  draws: dict) -> torch.Tensor:
    """The (n, L) keep order of a masking call's draws (low = kept)."""
    if mask_mode == "random":
        return draws["noise"]
    if mask_mode == "square":
        hs, ws = _SQUARE_WINDOWS[mask_ratio]
        pick = draws["pick"].long()
        mh, mw = torch.tensor(hs, device=pick.device)[pick], torch.tensor(ws, device=pick.device)[pick]
        top = torch.minimum(draws["top"].long(), height - mh)
        left = torch.minimum(draws["left"].long(), width - mw)
        rows = torch.arange(height, device=pick.device)[None, :, None]
        cols = torch.arange(width, device=pick.device)[None, None, :]
        window = ((rows >= top[:, None, None]) & (rows < (top + mh)[:, None, None])
                  & (cols >= left[:, None, None]) & (cols < (left + mw)[:, None, None]))
        return (~window).float().reshape(pick.shape[0], -1)  # the window is kept
    if mask_mode == "per2x2_random_grid":
        if mask_ratio not in (0.25, 0.5, 0.75):
            raise ValueError(f"per2x2_random_grid takes mask_ratio 0.25, 0.5 or 0.75, "
                             f"not {mask_ratio}")
        scores = draws["scores"]
        n, h2, w2, _ = scores.shape
        rank = torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1, stable=True)
        keep = rank < {0.25: 3, 0.5: 2, 0.75: 1}[mask_ratio]
        keep = keep.reshape(n, h2, w2, 2, 2).permute(0, 1, 3, 2, 4).reshape(n, height, width)
        return (~keep).float().reshape(n, -1)
    raise ValueError(f"Unknown mask_mode: {mask_mode!r}")


def random_token_masking(x: torch.Tensor, mask_ratio: float,
                         generator: Optional[torch.Generator] = None,
                         mask_mode: str = "random", height: int = 14, width: int = 14,
                         draws: Optional[dict] = None):
    """MAE-style masking of (n, L, d) tokens on an (height, width) grid;
    returns (kept tokens (n, int(L (1 - mask_ratio)), d), mask, ids_restore).
    The draws are `draws`, or drawn from `generator` (for the global batch
    on a process mesh, this process's rows kept: ``layers.global_rows``)."""
    n, l, _ = x.shape
    if draws is None:  # on a process mesh, the global batch's draws, then this shard's rows
        draws = global_rows(
            lambda rows: draw_masking(mask_mode, mask_ratio, rows, height, width, generator), n)
    noise = masking_noise(mask_mode, mask_ratio, height, width, draws).to(x.device)
    return _keep_by_noise(x, noise, int(l * (1.0 - mask_ratio)))


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
                 remat_policy: str = "none", mask_ratio: float = 0.0,
                 mask_mode: str = "random", dropout: float = 0.0,
                 drop_path: float = 0.0, init_values: Optional[float] = None,
                 head_zeroinit: bool = False, patch_embedding: str = "conv",
                 post_norm: bool = False, mean: Sequence[float] = (0.485, 0.456, 0.406),
                 std: Sequence[float] = (0.229, 0.224, 0.225), final_drop: float = 0.0,
                 scan_mlp: bool = False, chunk: int = 128, use_dense_general: bool = False,
                 param_dtype=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if pool_type not in ("gap", "tok", "map", "0", "avg"):
            raise ValueError(f"Unknown pool_type: {pool_type!r}")
        if posemb not in ("learn", "sincos2d"):
            raise ValueError(f"Unknown posemb type: {posemb!r}")
        if mask_mode not in MASK_MODES:
            raise ValueError(f"Unknown mask_mode: {mask_mode!r}")
        if patch_embedding not in PATCH_EMBEDDINGS:
            raise ValueError(f"Unknown patch_embedding: {patch_embedding!r}")
        param_dtype = check_param_dtype(param_dtype)
        p = tuple(patch_size)
        if patch_embedding == "conv":
            self.conv1 = zero_init(nn.Conv2d, 3, width, p, stride=p, bias=emb_head_bias)
            grid = (image_size // p[0]) * (image_size // p[1])
        elif patch_embedding == "stem":
            chans = (3,) + STEM_WIDTHS
            self.stem = nn.ModuleList(zero_init(nn.Conv2d, chans[i], chans[i + 1], 3,
                                                stride=STEM_STRIDES[i]) for i in range(3))
            self.stem_norm = nn.ModuleList(LayerNorm(c) for c in STEM_WIDTHS)
            self.conv1 = zero_init(nn.Conv2d, STEM_WIDTHS[-1], width, 1)  # flax "embedding"
            side = image_size
            for st in STEM_STRIDES:
                side = -(-side // st)
            grid = side * side
        else:  # "linear"
            self.embedding = zero_init(nn.Linear, p[0] * p[0] * 3, width)
            grid = (image_size // p[0]) ** 2
        self.class_embedding = nn.Parameter(torch.zeros(width))
        if posemb == "learn":
            self.positional_embedding = nn.Parameter(torch.zeros(1 + grid, width))
        self.transformer = Encoder(
            width, depth, num_heads, mlp_dim, init_style="vit", attn_impl=attn_impl,
            fast_gelu=fast_gelu, nomax_softmax=nomax_softmax, remat_policy=remat_policy,
            dropout=dropout, drop_path=drop_path, init_values=init_values, scan_mlp=scan_mlp,
            chunk=chunk, use_dense_general=use_dense_general, dtype=dtype)
        if pool_type in ("gap", "tok"):
            self.ln_post = LayerNorm(width, dtype)
        if pool_type == "map":
            self.map_head = MAPHead(width, num_heads, mlp_dim)
        if num_classes:
            self.proj = nn.Parameter(torch.zeros(width, num_classes))
            self.proj_bias = nn.Parameter(torch.zeros(num_classes)) if emb_head_bias else None
        self.head_parallel = 1  # the tensor axis size proj's output features are sharded over
        self.num_classes = num_classes
        self.width = width
        self.posemb = posemb
        self.pool_type = pool_type
        self.ignore_cls = ignore_cls
        self.output_tokens = output_tokens
        self.mask_ratio, self.mask_mode = mask_ratio, mask_mode
        self.patch_embedding, self.patch_size = patch_embedding, p
        self.post_norm, self.mean, self.std = post_norm, tuple(mean), tuple(std)
        self.final_drop = Dropout(final_drop)
        self.dropout = Dropout(dropout)
        self.head_zeroinit = head_zeroinit
        self.dtype = dtype
        # JAX creates cls and the position embedding in the stream's dtype
        # and the MAP head with flax's defaults: f32
        cast_params(self, param_dtype, keep=("class_embedding", "positional_embedding",
                                             "map_head."))

    def forward(self, image: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None):
        """image: (N, H, W, 3) -> (N, num_classes) f32 (or (N, width) without a
        head); with ``output_tokens``, (pooled, tokens (N, P, width)). With
        ``train``, the dropout, token-masking and drop-path draws come from
        `rng` (in that order; then the final dropout's)."""
        if self.post_norm:  # in the image's dtype (:203-205)
            image = ((image - torch.tensor(self.mean, dtype=image.dtype, device=image.device))
                     / torch.tensor(self.std, dtype=image.dtype, device=image.device))
        x, h, wd = self._embed(image)
        n, _, c = x.shape
        x = torch.cat([self.class_embedding.float().expand(n, 1, c), x], dim=1)
        if self.posemb == "learn":
            x = x + self.positional_embedding.float()
        else:
            x = x + posemb_sincos_2d(h, wd, c, cls_token=True, device=x.device)
        x = x.to(self.dtype)
        if train:
            x = self.dropout(x, dropout_generator(rng, self.dropout.rate))
            if self.mask_ratio > 0:
                if rng is None:
                    raise ValueError("token masking in training needs a torch.Generator (rng=...)")
                kept = random_token_masking(x[:, 1:], self.mask_ratio, rng, self.mask_mode, h, wd)[0]
                x = torch.cat([x[:, :1], kept], dim=1)
        if self.ignore_cls:
            x = x[:, 1:]
        x = self.transformer(x, train=train, rng=rng)
        patches = x if self.ignore_cls else x[:, 1:]

        if self.pool_type == "map":
            pooled = self.map_head(x)
        elif self.pool_type == "gap":
            pooled = self.ln_post(patches.mean(dim=1))
        elif self.pool_type == "avg":
            pooled = patches.mean(dim=1)
        elif self.pool_type == "0":
            pooled = x[:, 0]
        else:  # "tok"
            pooled = self.ln_post(x)[:, 0]

        if self.num_classes:
            if train:
                pooled = self.final_drop(pooled, dropout_generator(rng, self.final_drop.rate))
            pooled = sharded_head(pooled, self.proj, self.proj_bias, self.head_parallel)
        if self.output_tokens:
            return pooled, patches
        return pooled

    def _embed(self, image: torch.Tensor):
        """The patch embedding in f32: (tokens (n, h*w, width), h, w)."""
        if self.patch_embedding == "linear":  # (:259-265)
            p = self.patch_size[0]
            n, side = image.shape[0], image.shape[2] // p
            x = image.float().reshape(n, side, p, side, p, 3).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(n, side * side, p * p * 3)
            w = self.embedding
            return F.linear(x, w.weight.float(), w.bias.float()), side, side
        x = image.float().permute(0, 3, 1, 2)
        if self.patch_embedding == "stem":  # (:238-258)
            for conv, norm in zip(self.stem, self.stem_norm):
                ph, pw = (_same_pad(s, 3, conv.stride[0]) for s in x.shape[2:])
                x = F.conv2d(F.pad(x, (*pw, *ph)), conv.weight.float(), conv.bias.float(),
                             stride=conv.stride)
                x = F.gelu(norm(x.permute(0, 2, 3, 1)), approximate="tanh").permute(0, 3, 1, 2)
        w = self.conv1
        x = F.conv2d(x, w.weight.float(), None if w.bias is None else w.bias.float(),
                     stride=w.stride)
        n, c, h, wd = x.shape
        return x.flatten(2).transpose(1, 2), h, wd  # (n, h*w, c), row-major patches


def Model(num_classes=None, *, variant=None, **kw):
    """Factory mirroring the JAX package's ``Model(variant="L/14", ...)``,
    reference-config keys translated (``models/compat.py``)."""
    from openvision_tpu_torch.models.compat import translate_model_kwargs

    kw = translate_model_kwargs(kw)
    return ViT(num_classes=num_classes, **{**decode_variant(variant), **kw})


def resize_bilinear_aa(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`x` resized to `shape` as ``jax.image.resize(x, shape, "bilinear")``:
    each axis whose size changes is resampled by a triangle filter centred
    on (i + 0.5) / scale - 0.5, widened by 1 / scale when it shrinks (the
    antialiasing), its weights renormalized to sum 1 at the edges. The
    weights are formed in f64, the sums in x's dtype promoted to f32."""
    out = x.float()
    for axis, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        scale = n_out / n_in
        kernel_scale = max(1.0 / scale, 1.0)
        sample = (np.arange(n_out) + 0.5) / scale - 0.5
        w = np.maximum(0.0, 1.0 - np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale)
        total = w.sum(axis=0, keepdims=True)
        w = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                     w / np.where(total != 0, total, 1), 0)
        w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0)
        weights = torch.as_tensor(w, dtype=out.dtype, device=out.device)  # (n_in, n_out)
        out = torch.tensordot(out.movedim(axis, -1), weights, dims=1).movedim(-1, axis)
    return out


def resample_posemb(old: torch.Tensor, new_len: int) -> torch.Tensor:
    """A learned (1+N, D) position embedding (cls row first) resized to
    new_len rows for another resolution: the cls row as it is, the sqrt(N)
    x sqrt(N) grid resized bilinearly (:func:`resize_bilinear_aa`)."""
    if old.shape[0] == new_len:
        return old
    cls_pos, grid = old[:1].float(), old[1:]
    gs_old, gs_new = int(np.sqrt(grid.shape[0])), int(np.sqrt(new_len - 1))
    grid = resize_bilinear_aa(grid.reshape(gs_old, gs_old, -1), (gs_new, gs_new, grid.shape[-1]))
    return torch.cat([cls_pos, grid.reshape(gs_new * gs_new, -1)], dim=0)


def resize_patch_kernel(kernel: torch.Tensor, patch_size: Sequence[int]) -> torch.Tensor:
    """The (out, in, kh, kw) patch-embedding kernel resized to `patch_size`
    bilinearly (:func:`resize_bilinear_aa`, no rescaling of the values)."""
    return resize_bilinear_aa(kernel, (*kernel.shape[:2], *patch_size))
