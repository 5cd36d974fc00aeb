"""AutoAugment policies and RandAugment: the port's copy of
``openvision_tpu/data/ops_autoaugment.py``.

numpy and Pillow under the per-record RNG contract: every op draws from
the ``np.random.Generator`` it is given in the JAX module's order, so the
same generator state gives the same bytes.

- the AutoAugment ``v0`` policy table (25 sub-policies) and the ``test``
  policy (``POLICIES``);
- the level -> argument mappings, standard and ``increase`` variants,
  with the 50% random negation of signed magnitudes (``level_args``);
- the op set with Cutout and pixel-unit Translate (``apply_op``);
- RandAugment's layers (``randaug_layers``: per layer one of 15 ops at the
  shared magnitude; ``timm=True`` adds the 50% skip gate and the N(m, 0.5)
  magnitude jitter), which ``ops_aug``'s ``randaug`` op runs.

pp op registered here: ``autoaugment(policy='v0', increase=False)``.
Pillow is imported inside the ops (:func:`pil`): without it an op raises
an ImportError naming it; the rest of the pipeline needs no Pillow.
"""

from __future__ import annotations

import importlib

import numpy as np

from openvision_tpu_torch.data.pp import inkey_outkey, pp_op

_MAX_LEVEL = 10.0

# [128, 128, 128] for AutoAugment and RandAugment, the ImageNet mean
# [124, 116, 104] for the timm variant
GRAY = (128, 128, 128)
IMAGENET_FILL = (124, 116, 104)


def pil(module: str = "Image"):
    """``PIL.<module>``, or an ImportError that names Pillow."""
    try:
        return importlib.import_module(f"PIL.{module}")
    except ImportError as e:
        raise ImportError("the augmentation ops (randaug, autoaugment, color_jitter, "
                          "three_aug, color_jitter_timm) need Pillow (PIL), which is not "
                          "installed") from e


def _pil(img):
    return pil("Image").fromarray(np.asarray(img, np.uint8))


def _np(img):
    return np.asarray(img)


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------


def autocontrast(img):
    return _np(pil("ImageOps").autocontrast(_pil(img)))


def equalize(img):
    return _np(pil("ImageOps").equalize(_pil(img)))


def invert(img):
    return 255 - np.asarray(img, np.uint8)


def rotate(img, degrees, replace=GRAY):
    return _np(_pil(img).rotate(degrees, fillcolor=tuple(replace)))


def posterize(img, bits):
    """Zeroes the lowest `bits` bits (reference :233: shift right then left)."""
    shift = int(bits)
    arr = np.asarray(img, np.uint8)
    if shift <= 0:
        return arr
    return ((arr >> shift) << shift).astype(np.uint8)


def solarize(img, threshold=128):
    arr = np.asarray(img, np.uint8)
    return np.where(arr < threshold, arr, 255 - arr).astype(np.uint8)


def solarize_add(img, addition=0, threshold=128):
    arr = np.asarray(img, np.int64)
    added = np.clip(arr + int(addition), 0, 255)
    return np.where(arr < threshold, added, arr).astype(np.uint8)


def _blend_enhance(kind, img, factor):
    return _np(getattr(pil("ImageEnhance"), kind)(_pil(img)).enhance(float(factor)))


def color(img, factor):
    return _blend_enhance("Color", img, factor)


def contrast(img, factor):
    return _blend_enhance("Contrast", img, factor)


def brightness(img, factor):
    return _blend_enhance("Brightness", img, factor)


def sharpness(img, factor):
    return _blend_enhance("Sharpness", img, factor)


def shear_x(img, level, replace=GRAY):
    h, w = np.asarray(img).shape[:2]
    return _np(_pil(img).transform(
        (w, h), pil("Image").AFFINE, (1, level, 0, 0, 1, 0),
        fillcolor=tuple(replace)))


def shear_y(img, level, replace=GRAY):
    h, w = np.asarray(img).shape[:2]
    return _np(_pil(img).transform(
        (w, h), pil("Image").AFFINE, (1, 0, 0, level, 1, 0),
        fillcolor=tuple(replace)))


def translate_x(img, pixels, replace=GRAY):
    h, w = np.asarray(img).shape[:2]
    return _np(_pil(img).transform(
        (w, h), pil("Image").AFFINE, (1, 0, pixels, 0, 1, 0),
        fillcolor=tuple(replace)))


def translate_y(img, pixels, replace=GRAY):
    h, w = np.asarray(img).shape[:2]
    return _np(_pil(img).transform(
        (w, h), pil("Image").AFFINE, (1, 0, 0, 0, 1, pixels),
        fillcolor=tuple(replace)))


def cutout(img, pad_size, rng, replace=GRAY):
    """Zeroes a (2*pad_size)² patch at a random center (reference :139)."""
    arr = np.array(img, np.uint8)
    h, w = arr.shape[:2]
    cy = int(rng.integers(0, h))
    cx = int(rng.integers(0, w))
    y0, y1 = max(0, cy - pad_size), min(h, cy + pad_size)
    x0, x1 = max(0, cx - pad_size), min(w, cx + pad_size)
    arr[y0:y1, x0:x1] = np.asarray(replace, np.uint8)
    return arr


# ---------------------------------------------------------------------------
# Level -> argument mappings
# ---------------------------------------------------------------------------


def _negate(rng, v):
    return -v if rng.random() < 0.5 else v


def _enhance_level(level, rng):
    return (level / _MAX_LEVEL) * 1.8 + 0.1


def _enhance_level_increasing(level, rng):
    amt = (level / _MAX_LEVEL) * 0.9
    return max(0.1, 1.0 + _negate(rng, amt))


def level_args(name, level, rng, *, increase, cutout_const, translate_const):
    """Returns the positional args for op `name` at `level` (0..10)."""
    if name in ("AutoContrast", "Equalize", "Invert"):
        return ()
    if name == "Rotate":
        return (_negate(rng, (level / _MAX_LEVEL) * 30.0),)
    if name == "Posterize":
        frac = int((level / _MAX_LEVEL) * 4)
        return (4 - min(4, frac),) if increase else (frac,)
    if name == "Solarize":
        frac = int((level / _MAX_LEVEL) * 256)
        return (256 - min(256, frac),) if increase else (frac,)
    if name == "SolarizeAdd":
        frac = int((level / _MAX_LEVEL) * 110)
        return (min(128, frac),)
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        fn = _enhance_level_increasing if increase else _enhance_level
        return (fn(level, rng),)
    if name in ("ShearX", "ShearY"):
        return (_negate(rng, (level / _MAX_LEVEL) * 0.3),)
    if name in ("TranslateX", "TranslateY"):
        return (_negate(rng, (level / _MAX_LEVEL) * translate_const),)
    if name == "Cutout":
        return (int((level / _MAX_LEVEL) * cutout_const),)
    raise ValueError(f"unknown autoaugment op {name!r}")


def apply_op(name, img, args, rng, replace=GRAY):
    table = {
        "AutoContrast": lambda: autocontrast(img),
        "Equalize": lambda: equalize(img),
        "Invert": lambda: invert(img),
        "Rotate": lambda: rotate(img, *args, replace=replace),
        "Posterize": lambda: posterize(img, *args),
        "Solarize": lambda: solarize(img, *args),
        "SolarizeAdd": lambda: solarize_add(img, *args),
        "Color": lambda: color(img, *args),
        "Contrast": lambda: contrast(img, *args),
        "Brightness": lambda: brightness(img, *args),
        "Sharpness": lambda: sharpness(img, *args),
        "ShearX": lambda: shear_x(img, *args, replace=replace),
        "ShearY": lambda: shear_y(img, *args, replace=replace),
        "TranslateX": lambda: translate_x(img, *args, replace=replace),
        "TranslateY": lambda: translate_y(img, *args, replace=replace),
        "Cutout": lambda: cutout(img, *args, rng, replace=replace),
    }
    return table[name]()


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

POLICY_V0 = [
    [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
    [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
    [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateY", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
    [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]

POLICY_TEST = [
    [("TranslateX", 1.0, 4), ("Equalize", 1.0, 10)],
]

POLICIES = {"v0": POLICY_V0, "test": POLICY_TEST}


def apply_autoaugment(image, rng, *, policy="v0", increase=False):
    """Applies one randomly-selected sub-policy (reference :625-705)."""
    table = POLICIES[policy]
    sub = table[int(rng.integers(0, len(table)))]
    img = np.asarray(image, np.uint8)
    for name, prob, level in sub:
        args = level_args(
            name, level, rng, increase=increase,
            cutout_const=100, translate_const=250,
        )
        if rng.random() < prob:
            img = apply_op(name, img, args, rng, replace=GRAY)
    return img


@pp_op("autoaugment")
@inkey_outkey(indefault="image", outdefault="image")
def get_autoaugment(policy: str = "v0", increase: bool = False):
    assert policy in POLICIES, f"unknown policy {policy!r}"

    def op(image, rng):
        return apply_autoaugment(image, rng, policy=policy, increase=increase)

    return op


# ---------------------------------------------------------------------------
# RandAugment layers (ops_aug's randaug)
# ---------------------------------------------------------------------------

RANDAUG_OPS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateX", "TranslateY",
]


def randaug_layers(image, rng, *, num_layers, magnitude, increase, timm):
    """Reference RandAugment: per layer one uniformly-chosen op at the shared
    magnitude (cutout_const=40, translate_const=100). timm mode gates each
    layer at 50% and jitters the magnitude ~N(m, 0.5)."""
    img = np.asarray(image, np.uint8)
    replace = IMAGENET_FILL if timm else GRAY
    for _ in range(num_layers):
        name = RANDAUG_OPS[int(rng.integers(0, len(RANDAUG_OPS)))]
        mag = float(rng.normal(magnitude, 0.5)) if timm else float(magnitude)
        mag = float(np.clip(mag, 0.0, _MAX_LEVEL))
        if timm and rng.random() >= 0.5:
            continue
        args = level_args(
            name, mag, rng, increase=increase,
            cutout_const=40, translate_const=100,
        )
        img = apply_op(name, img, args, rng, replace=replace)
    return img
