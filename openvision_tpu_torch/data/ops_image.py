"""Image helpers: decode, resize and the eval preprocessing (numpy, PIL
imported inside).

Counterpart of ``_to_image_array``, ``_resize`` and the eval ops
``resize_small``, ``central_crop`` and ``vgg_value_range`` of
``openvision_tpu/data/ops_image.py`` (:18-20, :87-188; its package loads
JAX on import), as plain functions of an image rather than pp-string ops.
A resize to the image's own size returns a copy without touching PIL, as
PIL's ``Image.resize`` does, so already-sized arrays need no PIL at all.
The random and pipeline ops are not ported yet.
"""

from __future__ import annotations

import io

import numpy as np

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
