"""Image helpers: decode and resize (numpy, PIL imported inside).

Counterpart of ``_to_image_array`` and ``_resize`` in
``openvision_tpu/data/ops_image.py`` (whose package loads JAX on import).
A resize to the image's own size returns a copy without touching PIL, as
PIL's ``Image.resize`` does, so already-sized arrays need no PIL at all.
The random and pipeline ops are not ported yet.
"""

from __future__ import annotations

import io

import numpy as np


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
