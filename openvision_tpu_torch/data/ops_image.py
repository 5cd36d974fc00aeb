"""Image helpers: decode, resize and the eval preprocessing (numpy, PIL
imported inside).

Counterpart of ``_to_image_array``, ``_resize`` and the eval ops
``resize_small``, ``central_crop`` and ``vgg_value_range`` of
``openvision_tpu/data/ops_image.py`` (:18-20, :87-188; its package loads
JAX on import), as plain functions of an image, and the training pp ops the base config
names, registered as the JAX package registers them: ``inception_crop``
(:146) and ``simclr_jitter_gray`` (:228), each drawing from the record's
``np.random.Generator`` in the JAX op's order, so one generator state gives
the same crop and jitter in both packages. A resize to the image's own size
returns a copy without touching PIL, as PIL's ``Image.resize`` does, so
already-sized arrays need no PIL at all. The other random ops are not ported
yet.
"""

from __future__ import annotations

import io

import numpy as np

from openvision_tpu_torch.data.pp import inkey_outkey, pp_op

# ImageNet mean/std in 0..255 units (the JAX package's vgg_value_range).
VGG_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
VGG_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def _to_image_array(x) -> np.ndarray:
    """Decodes bytes to HWC uint8 RGB if needed; passes arrays through."""
    if isinstance(x, (bytes, bytearray, np.bytes_)):
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(x)).convert("RGB"))
    return np.asarray(x)


def _resize(image: np.ndarray, h: int, w: int, method: str = "bilinear",
            antialias: bool = True) -> np.ndarray:
    if image.shape[:2] == (h, w):
        return image.copy()
    from PIL import Image

    resample = {
        "bilinear": Image.BILINEAR,
        "bicubic": Image.BICUBIC,
        "nearest": Image.NEAREST,
        "lanczos": Image.LANCZOS,
        "area": Image.BOX,
    }[method]
    if image.dtype == np.uint8:
        return np.asarray(Image.fromarray(image).resize((w, h), resample))
    # PIL resizes float images one channel at a time (mode "F")
    if image.ndim == 2:
        out = Image.fromarray(image.astype(np.float32), mode="F").resize((w, h), resample)
        return np.asarray(out).astype(image.dtype)
    chans = [
        np.asarray(Image.fromarray(image[..., c].astype(np.float32), mode="F")
                   .resize((w, h), resample))
        for c in range(image.shape[-1])
    ]
    return np.stack(chans, axis=-1).astype(image.dtype)


def resize_small(image, smaller_size: int, method: str = "bilinear",
                 antialias: bool = True) -> np.ndarray:
    """Resizes so the smaller side is `smaller_size`, keeping the aspect."""
    image = _to_image_array(image)
    h, w = image.shape[:2]
    ratio = smaller_size / min(h, w)
    return _resize(image, round(h * ratio), round(w * ratio), method, antialias)


def central_crop(image, crop_size) -> np.ndarray:
    """The centred (crop_size, crop_size) window (or (h, w) for a pair)."""
    ch, cw = (crop_size, crop_size) if isinstance(crop_size, int) else crop_size
    image = _to_image_array(image)
    h, w = image.shape[:2]
    top, left = (h - ch) // 2, (w - cw) // 2
    return image[top:top + ch, left:left + cw]


def vgg_value_range(image) -> np.ndarray:
    """0..255 pixels -> ImageNet-normalized f32."""
    return (np.asarray(image, np.float32) - VGG_MEAN) / VGG_STD


def _sample_inception_box(rng, h, w, area_min, area_max=100, min_aspect=3 / 4,
                          max_aspect=4 / 3, max_attempts=10):
    area = h * w
    for _ in range(max_attempts):
        target_area = rng.uniform(area_min / 100, area_max / 100) * area
        aspect = np.exp(rng.uniform(np.log(min_aspect), np.log(max_aspect)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if ch <= h and cw <= w:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    s = min(h, w)  # fallback: centered square crop
    return (h - s) // 2, (w - s) // 2, s, s


@pp_op("inception_crop")
@inkey_outkey(indefault="image", outdefault="image")
def get_inception_crop(size=None, area_min=5, area_max=100, method="bilinear",
                       antialias=True):
    def op(image, rng):
        image = _to_image_array(image)
        h, w = image.shape[:2]
        top, left, ch, cw = _sample_inception_box(rng, h, w, area_min, area_max)
        crop = image[top: top + ch, left: left + cw]
        if size:
            crop = _resize(crop, size, size, method, antialias)
        return crop

    return op


def _rgb_to_gray(image: np.ndarray) -> np.ndarray:
    gray = image @ np.array([0.2989, 0.587, 0.114], np.float32)
    return np.repeat(gray[..., None], 3, axis=-1)


def _adjust_contrast(img, factor):
    mean = _rgb_to_gray(img).mean()
    return (img - mean) * factor + mean


def _adjust_saturation(img, factor):
    gray = _rgb_to_gray(img)
    return gray + (img - gray) * factor


def _adjust_hue(img, delta):
    """Hue rotation in YIQ space (delta in turns, like tf's fraction)."""
    theta = delta * 2 * np.pi
    u, w_ = np.cos(theta), np.sin(theta)
    t_yiq = np.array(
        [[0.299, 0.587, 0.114], [0.596, -0.274, -0.322], [0.211, -0.523, 0.312]], np.float32)
    rot = np.array([[1, 0, 0], [0, u, -w_], [0, w_, u]], np.float32)
    return img @ (np.linalg.inv(t_yiq) @ rot @ t_yiq).T


@pp_op("simclr_jitter_gray")
@inkey_outkey(indefault="image", outdefault="image")
def get_simclr_jitter_gray(jitter_strength=0.4, p_jitter=0.8, p_gray=0.2):
    """SimCLR-style random color jitter + random grayscale (uint8 in/out)."""
    b = c = s = 0.8 * jitter_strength
    hu = 0.2 * jitter_strength

    def op(image, rng):
        img = np.asarray(image, np.float32)
        if rng.random() < p_jitter:
            fns = [
                lambda x: x * (1 + rng.uniform(-b, b)),
                lambda x: _adjust_contrast(x, 1 + rng.uniform(-c, c)),
                lambda x: _adjust_saturation(x, 1 + rng.uniform(-s, s)),
                lambda x: _adjust_hue(x, rng.uniform(-hu, hu)),
            ]
            for i in rng.permutation(4):
                img = np.clip(fns[i](img), 0, 255)
        if rng.random() < p_gray:
            img = _rgb_to_gray(img)
        return img.astype(image.dtype if hasattr(image, "dtype") else np.uint8)

    return op
