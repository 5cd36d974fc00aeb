"""Batch-level augmentation: mixup and cutmix.

Counterpart of ``openvision_tpu/data/ops_aug.py:mixup_cutmix`` (:241-283),
applied after batching by ``pipeline.MixupCutmixTransform``. It draws from
the ``np.random.Generator`` it is given in the JAX function's order, so the
same generator state gives the same outputs. The per-image augmentation ops
of that module (``randaug``, ``color_jitter``, ``random_erasing``,
``three_aug``, ``color_jitter_timm``) are not ported yet.
"""

from __future__ import annotations

import numpy as np


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
