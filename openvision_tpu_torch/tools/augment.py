"""Differentiable image augmentations and losses for the interpretability tools.

Counterpart of ``openvision_tpu/tools/augment.py``. Images are (B, H, W, C)
float, the JAX package's layout, which the port's ViT takes. Each random
augmentation is split in two: ``<name>_draw(gen, ...)`` draws its
parameters from an explicit ``torch.Generator`` (on the generator's
device; the global RNG is never read), and ``<name>_apply(images, ...)``
applies them, differentiably in the images; ``<name>(gen, images, ...)``
does both, as the JAX function does with its key. The draws have the JAX
draws' ranges and shapes, not their stream, so the tests feed JAX's draws to
the applies.

What a naive port would change, and this one keeps:

- the affine warp samples bilinearly with the corner indices clamped to the
  image before the weights are formed, so the weights clip to [0, 1] at the
  border (not ``F.grid_sample``'s border mode); rotation as the JAX grid
  (source y = cos y0 + sin x0), translation by ``ty * h`` and ``tx * w``;
- ``pixel_jitter`` is a per-sample circular roll by integer shifts in
  [-lim, lim];
- ``zoom`` is ``jax.image.resize(..., "bilinear")``: half-pixel centres,
  antialiased when it shrinks;
- ``centering`` shares one offset across the batch, clips it, then
  truncates it to an integer; ``flip`` flips the whole batch on one draw.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _affine_grid(h: int, w: int, angle, tx, ty, device):
    """Per-sample source coordinates (B, H, W) for rotation by `angle` (rad)
    about the centre and translation by (tx * w, ty * h)."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y0, x0 = yy - cy, xx - cx
    cos, sin = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    src_y = cos * y0 + sin * x0 + cy - ty[:, None, None] * h
    src_x = -sin * y0 + cos * x0 + cx - tx[:, None, None] * w
    return src_y, src_x


def _sample_bilinear(images: torch.Tensor, src_y, src_x) -> torch.Tensor:
    """Bilinear sampling of (B, H, W, C) at (B, H, W) fractional coordinates,
    the corner indices clamped to the image first."""
    b, h, w, c = images.shape
    y0 = torch.floor(src_y).long().clamp(0, h - 1)
    x0 = torch.floor(src_x).long().clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    wy = (src_y - y0).clamp(0.0, 1.0)[..., None]
    wx = (src_x - x0).clamp(0.0, 1.0)[..., None]
    flat = images.reshape(b, h * w, c)

    def at(yi, xi):
        idx = (yi * w + xi).reshape(b, h * w, 1).expand(b, h * w, c)
        return flat.gather(1, idx).reshape(b, h, w, c)

    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
            + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)


def random_affine_draw(gen: torch.Generator, b: int, *, degrees: float = 10.0,
                       translate: float = 0.1, p: float = 0.8):
    """(angles rad, tx, ty, on): each (b,), angles in [-degrees, degrees]
    converted to radians, translations in [-translate, translate], `on`
    True with probability p."""
    max_rad = math.radians(degrees)
    angles = _uniform(gen, (b,), -max_rad, max_rad)
    txs = _uniform(gen, (b,), -translate, translate)
    tys = _uniform(gen, (b,), -translate, translate)
    on = torch.rand((b,), generator=gen, device=gen.device) < p
    return angles, txs, tys, on


def random_affine_apply(images: torch.Tensor, angles, txs, tys, on) -> torch.Tensor:
    b, h, w, _ = images.shape
    dev = images.device
    src_y, src_x = _affine_grid(h, w, angles.to(dev), txs.to(dev), tys.to(dev), dev)
    warped = _sample_bilinear(images, src_y, src_x)
    return torch.where(on.to(dev)[:, None, None, None], warped, images)


def random_affine(gen: torch.Generator, images: torch.Tensor, *, degrees: float = 10.0,
                  translate: float = 0.1, p: float = 0.8) -> torch.Tensor:
    """Per-sample random rotation + translation, applied with probability p."""
    draws = random_affine_draw(gen, images.shape[0], degrees=degrees, translate=translate, p=p)
    return random_affine_apply(images, *draws)


def pixel_jitter_draw(gen: torch.Generator, b: int, lim: int = 8) -> torch.Tensor:
    """(b, 2) integer (dy, dx) shifts in [-lim, lim]."""
    return torch.randint(-lim, lim + 1, (b, 2), generator=gen, device=gen.device)


def pixel_jitter_apply(images: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Each image rolled by its shifts (``jnp.roll`` over H and W)."""
    b, h, w, _ = images.shape
    dev = images.device
    shifts = shifts.to(dev)
    iy = (torch.arange(h, device=dev)[None] - shifts[:, :1]) % h
    ix = (torch.arange(w, device=dev)[None] - shifts[:, 1:]) % w
    return images[torch.arange(b, device=dev)[:, None, None], iy[:, :, None], ix[:, None, :]]


def pixel_jitter(gen: torch.Generator, images: torch.Tensor, lim: int = 8) -> torch.Tensor:
    """Random integer translation (the classic feature-viz 'Jitter')."""
    return pixel_jitter_apply(images, pixel_jitter_draw(gen, images.shape[0], lim))


def color_jitter_draw(gen: torch.Generator, b: int, brightness: float = 0.1,
                      contrast: float = 0.1):
    """(brightness factors, contrast factors), each (b, 1, 1, 1) in
    1 +- brightness and 1 +- contrast."""
    bf = 1 + _uniform(gen, (b, 1, 1, 1), -brightness, brightness)
    cf = 1 + _uniform(gen, (b, 1, 1, 1), -contrast, contrast)
    return bf, cf


def color_jitter_apply(images: torch.Tensor, bf, cf) -> torch.Tensor:
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    return (images * bf.to(images.device) - mean) * cf.to(images.device) + mean


def color_jitter(gen: torch.Generator, images: torch.Tensor, brightness: float = 0.1,
                 contrast: float = 0.1) -> torch.Tensor:
    return color_jitter_apply(images, *color_jitter_draw(gen, images.shape[0], brightness,
                                                         contrast))


def gaussian_noise_draw(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal noise of `shape`."""
    return torch.randn(shape, generator=gen, device=gen.device)


def gaussian_noise_apply(images: torch.Tensor, noise: torch.Tensor,
                         std: float = 0.01) -> torch.Tensor:
    return images + std * noise.to(images.device)


def gaussian_noise(gen: torch.Generator, images: torch.Tensor, std: float = 0.01) -> torch.Tensor:
    return gaussian_noise_apply(images, gaussian_noise_draw(gen, images.shape), std)


def total_variation(images: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV penalty: mean |dy| + mean |dx|."""
    dy = (images[:, 1:] - images[:, :-1]).abs().mean()
    dx = (images[:, :, 1:] - images[:, :, :-1]).abs().mean()
    return dx + dy


def tile(images: torch.Tensor, rep: int) -> torch.Tensor:
    """Tiles each image rep x rep."""
    return images.repeat(1, rep, rep, 1)


def zoom(images: torch.Tensor, out_size: int) -> torch.Tensor:
    """Bilinear resize to (out_size, out_size), half-pixel centres,
    antialiased when it shrinks (``jax.image.resize``'s "bilinear")."""
    x = images.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(out_size, out_size), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1)


def centering_draw(gen: torch.Generator, std: float) -> torch.Tensor:
    """The batch's one (dy, dx) offset, each in [-std, std)."""
    return (torch.rand((2,), generator=gen, device=gen.device) * 2.0 - 1.0) * std


def centering_apply(images: torch.Tensor, pert: torch.Tensor, size: int) -> torch.Tensor:
    """The `size` crop about the centre moved by `pert`, clipped into the
    image and truncated to integers."""
    _, h, w, _ = images.shape
    if size > min(h, w):
        raise ValueError(f"centering: a {size} crop is larger than the {h} x {w} images")
    pert = pert.float().cpu()
    y = int(torch.clamp(pert[0] + (h // 2 - size // 2), 0, h - size))
    x = int(torch.clamp(pert[1] + (w // 2 - size // 2), 0, w - size))
    return images[:, y:y + size, x:x + size]


def centering(gen: torch.Generator, images: torch.Tensor, size: int, std: float) -> torch.Tensor:
    """Centre crop of `size` with a random +-std offset shared by the batch."""
    return centering_apply(images, centering_draw(gen, std), size)


def flip_draw(gen: torch.Generator, p: float = 0.5) -> torch.Tensor:
    """One bool for the whole batch, True with probability p."""
    return torch.rand((), generator=gen, device=gen.device) < p


def flip_apply(images: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    return torch.where(do.to(images.device), images.flip(2), images)


def flip(gen: torch.Generator, images: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Horizontal flip of the whole batch with probability p."""
    return flip_apply(images, flip_draw(gen, p))


def repeat_batch(images: torch.Tensor, repeat: int) -> torch.Tensor:
    """The batch repeated `repeat` times (``jnp.tile``)."""
    return images.repeat(repeat, 1, 1, 1)


def color_jitter_affine_draw(gen: torch.Generator, b: int, mean: float = 1.0, std: float = 1.0):
    """(m, s), each (b, 1, 1, 3): m in [-mean, mean), s = exp(u), u in
    [-std, std)."""
    m = (torch.rand((b, 1, 1, 3), generator=gen, device=gen.device) - 0.5) * 2.0 * mean
    s = torch.exp((torch.rand((b, 1, 1, 3), generator=gen, device=gen.device) - 0.5) * 2.0 * std)
    return m, s


def color_jitter_affine_apply(images: torch.Tensor, m, s) -> torch.Tensor:
    return (images - m.to(images.device)) / s.to(images.device)


def color_jitter_affine(gen: torch.Generator, images: torch.Tensor, mean: float = 1.0,
                        std: float = 1.0) -> torch.Tensor:
    """(img - m) / s with per-sample random m and log-uniform s, the feature
    visualisation's colour jitter (distinct from :func:`color_jitter`)."""
    return color_jitter_affine_apply(images, *color_jitter_affine_draw(gen, images.shape[0],
                                                                       mean, std))


def activation_norm_loss(acts: torch.Tensor) -> torch.Tensor:
    """Mean squared activation, in f32."""
    return acts.float().pow(2).mean()


def diversity_loss(embeds: torch.Tensor) -> torch.Tensor:
    """Mean off-diagonal cosine similarity across the batch."""
    z = embeds / (torch.linalg.norm(embeds, dim=-1, keepdim=True) + 1e-8)
    sim = z @ z.T
    b = sim.shape[0]
    return (sim.sum() - torch.trace(sim)) / (b * (b - 1) + 1e-8)
