"""Augmentation ops: the per-image pp ops and batch-level mixup / cutmix.

Counterpart of ``openvision_tpu/data/ops_aug.py``: the pp ops ``randaug``
(:127-145, RandAugment's layers in ``ops_autoaugment``), ``color_jitter``
(:146-170), ``random_erasing`` (:171-198), ``three_aug`` (:199-220) and
``color_jitter_timm`` (:221-240), registered under the same names, and
``mixup_cutmix`` (:241-283), applied after batching by
``pipeline.MixupCutmixTransform``. Each draws from the
``np.random.Generator`` it is given in the JAX function's order, so the
same generator state gives the same bytes. Pillow is imported inside the
ops (``ops_autoaugment.pil``); without it they raise an ImportError naming
it (``random_erasing`` and ``mixup_cutmix`` need none).
"""

from __future__ import annotations

import numpy as np

from openvision_tpu_torch.data.ops_autoaugment import _np, _pil, pil
from openvision_tpu_torch.data.pp import inkey_outkey, pp_op


@pp_op("randaug")
@inkey_outkey(indefault="image", outdefault="image")
def get_randaug(num_layers: int = 2, magnitude: int = 10, increase: bool = True,
                timm: bool = False):
    """RandAugment: per layer one uniformly chosen op at the shared
    magnitude with the level -> argument mappings; `increase=True` takes the
    monotonic variants; `timm=True` adds the 50% skip gate and the N(m, 0.5)
    magnitude jitter."""
    from openvision_tpu_torch.data.ops_autoaugment import randaug_layers

    def op(image, rng):
        return randaug_layers(image, rng, num_layers=num_layers, magnitude=magnitude,
                              increase=increase, timm=timm)

    return op


@pp_op("color_jitter")
@inkey_outkey(indefault="image", outdefault="image")
def get_color_jitter(color_jitter=0.4):
    """Random contrast, then random saturation, each a factor in
    [max(0, 1 - s), 1 + s] (brightness is off, as in JAX's)."""
    if isinstance(color_jitter, (list, tuple)):
        assert len(color_jitter) == 3
        _, b, c = color_jitter
    else:
        b = c = float(color_jitter)

    def op(image, rng):
        enhance = pil("ImageEnhance")
        img = _pil(image)
        img = enhance.Contrast(img).enhance(rng.uniform(max(0.0, 1 - b), 1 + b))
        img = enhance.Color(img).enhance(rng.uniform(max(0.0, 1 - c), 1 + c))
        return _np(img)

    return op


@pp_op("random_erasing")
@inkey_outkey(indefault="image", outdefault="image")
def get_random_erasing(probability=0.25, min_area=0.02, max_area=1 / 3, min_aspect=0.3):
    """With `probability`, a box of random area and aspect (up to 10 tries)
    filled with N(128, 50) noise clipped to [0, 255]."""
    def op(image, rng):
        img = np.array(image)
        if rng.random() > probability:
            return img
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = rng.uniform(min_area, max_area) * area
            aspect = np.exp(rng.uniform(np.log(min_aspect), np.log(1 / min_aspect)))
            eh = int(round(np.sqrt(target * aspect)))
            ew = int(round(np.sqrt(target / aspect)))
            if eh < h and ew < w:
                top = int(rng.integers(0, h - eh))
                left = int(rng.integers(0, w - ew))
                patch_shape = (eh, ew) + img.shape[2:]
                img[top:top + eh, left:left + ew] = rng.normal(
                    128, 50, patch_shape).clip(0, 255).astype(img.dtype)
                return img
        return img

    return op


@pp_op("three_aug")
@inkey_outkey(indefault="image", outdefault="image")
def get_three_aug(blur_prob=1.0):
    """DeiT-III's 3-augment: one of grayscale, solarize (at 128) or a
    Gaussian blur of radius U(0.1, 2)."""
    def op(image, rng):
        img = np.asarray(image, np.uint8)
        choice = int(rng.integers(0, 3))
        if choice == 0:
            from openvision_tpu_torch.data.ops_image import _rgb_to_gray

            return _rgb_to_gray(img.astype(np.float32)).astype(np.uint8)
        if choice == 1:
            return _np(pil("ImageOps").solarize(_pil(img), 128))
        radius = rng.uniform(0.1, 2.0)
        return _np(_pil(img).filter(pil("ImageFilter").GaussianBlur(radius)))

    return op


@pp_op("color_jitter_timm")
@inkey_outkey(indefault="image", outdefault="image")
def get_color_jitter_timm(strength=0.4):
    """Brightness, contrast and saturation in a random order, each a factor
    1 + U(-strength, strength)."""
    def op(image, rng):
        enhance = pil("ImageEnhance")
        img = _pil(image)
        for kind in rng.permutation(["Brightness", "Contrast", "Color"]):
            img = getattr(enhance, str(kind))(img).enhance(1 + rng.uniform(-strength, strength))
        return _np(img)

    return op


def mixup_cutmix(batch_images: np.ndarray, batch_labels: np.ndarray, rng: np.random.Generator,
                 *, mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                 switch_prob: float = 0.5, num_classes: int | None = None):
    """Mixes a batch with its reversal; returns (images, soft labels).

    With probability `switch_prob` cutmix (a box of the reversed batch
    pasted in, the label weight the box's area), else mixup (a Beta(alpha,
    alpha) blend, images in f32). Integer labels become one-hot over
    `num_classes` first.
    """
    b = batch_images.shape[0]
    if num_classes is not None and batch_labels.ndim == 1:
        one_hot = np.zeros((b, num_classes), np.float32)
        one_hot[np.arange(b), batch_labels] = 1.0
        batch_labels = one_hot

    use_cutmix = rng.random() < switch_prob
    alpha = cutmix_alpha if use_cutmix else mixup_alpha
    lam = float(rng.beta(alpha, alpha))

    flipped_img = batch_images[::-1]
    flipped_lab = batch_labels[::-1]
    if use_cutmix:
        h, w = batch_images.shape[1:3]
        cut = np.sqrt(1 - lam)
        ch, cw = int(h * cut), int(w * cut)
        cy = int(rng.integers(0, h))
        cx = int(rng.integers(0, w))
        y0, y1 = np.clip([cy - ch // 2, cy + ch // 2], 0, h)
        x0, x1 = np.clip([cx - cw // 2, cx + cw // 2], 0, w)
        out = np.array(batch_images)
        out[:, y0:y1, x0:x1] = flipped_img[:, y0:y1, x0:x1]
        lam = 1 - (y1 - y0) * (x1 - x0) / (h * w)
    else:
        out = (lam * batch_images.astype(np.float32)
               + (1 - lam) * flipped_img.astype(np.float32))
    labels = lam * batch_labels + (1 - lam) * flipped_lab
    return out, labels
