"""Image preprocessing ops: decode, resize and the eval and training pp ops
(numpy; PIL imported inside, and only where needed).

Counterpart of ``openvision_tpu/data/ops_image.py``: ``_to_image_array``,
``_resize`` and the eval ops ``decode``, ``resize``, ``resize_small``,
``central_crop`` and ``vgg_value_range`` (:18-20, :64-188), registered as
the JAX package registers them and kept as plain functions of an image as
well, and the training ops the base config names, ``inception_crop``
(:146) and ``simclr_jitter_gray`` (:228), each drawing from the record's
``np.random.Generator`` in the JAX op's order, so one generator state gives
the same crop and jitter in both packages. The other random ops are not
ported yet.

Encoding: :func:`encode_png` writes (H, W, 3) uint8 as an 8-bit RGB PNG
with unfiltered rows (zlib and struct), the inverse of :func:`decode_png`;
the interpretability tools save their images with it.

Decoding: an 8-bit non-interlaced RGB or RGBA PNG is always decoded by
:func:`decode_png` (zlib and numpy, no Pillow: the card's machine may lack
it), bit-equal to PIL's ``convert("RGB")``; every other image goes through
Pillow, and without Pillow that raises an ImportError naming it. A resize
to the image's own size returns a copy without touching PIL, as PIL's
``Image.resize`` does, so already-sized arrays need no PIL at all.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

from openvision_tpu_torch.data.pp import inkey_outkey, pp_op

# ImageNet mean/std in 0..255 units (the JAX package's vgg_value_range).
VGG_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
VGG_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _png_chunks(data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        yield ctype, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IEND":
            return


def _png_header(data: bytes):
    """(width, height, bit depth, colour type, interlace) of a PNG, or None."""
    if data[:8] != _PNG_MAGIC or data[12:16] != b"IHDR":
        return None
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return w, h, depth, color, interlace


def png_is_plain(data) -> bool:
    """True for an 8-bit non-interlaced RGB or RGBA PNG (decode_png's kind)."""
    hdr = _png_header(bytes(data[:29]))
    return hdr is not None and hdr[2] == 8 and hdr[3] in (2, 6) and hdr[4] == 0


def _unfilter_wavefront(filters: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Undoes any mix of the five row filters on (H, W, bpp) filtered bytes.
    Average and Paeth recur along the row, but a pixel reads only its left,
    upper and upper-left neighbours, so the pixels of one anti-diagonal
    (row + column constant) are independent: H + W - 1 numpy steps, each
    over a whole diagonal, instead of a Python step a byte. The image is
    held skewed, ``s[k + 2, y + 1]`` the pixel (y, k - y), so that every
    neighbour of a diagonal is a slice of the two before it; the entries
    that are no pixel stay 0, which is what the filters read outside the
    image."""
    h, w, bpp = x.shape
    ys, xs = np.indices((h, w))
    skewed = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    skewed[ys + xs + 2, ys + 1] = x
    s = np.zeros_like(skewed)
    # each row's filter as four 0/1 weights (Sub, Up, Average, Paeth)
    sub, up, avg, paeth = ((filters == f)[:, None].astype(np.int16) for f in (1, 2, 3, 4))
    for k in range(h + w - 1):
        y0, y1 = max(0, k - w + 1), min(h, k + 1)
        a, b, c = s[k + 1, y0 + 1:y1 + 1], s[k + 1, y0:y1], s[k, y0:y1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        near = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (sub[y0:y1] * a + up[y0:y1] * b + avg[y0:y1] * ((a + b) >> 1)
                + paeth[y0:y1] * near)
        s[k + 2, y0 + 1:y1 + 1] = (skewed[k + 2, y0 + 1:y1 + 1] + pred) & 255
    return s[ys + xs + 2, ys + 1].astype(np.uint8)


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG, every row filter 0 (None)."""
    image = np.ascontiguousarray(image)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {image.shape} {image.dtype}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit non-interlaced RGB/RGBA PNG -> (H, W, 3) uint8, alpha dropped
    as PIL's ``convert("RGB")`` drops it. An image whose rows are all
    unfiltered is one copy; rows filtered None, Sub or Up alone are undone
    a row at a time in numpy (Sub as a running sum over the pixels,
    wrapping mod 256); an image with any Average or Paeth row is undone a
    diagonal at a time (:func:`_unfilter_wavefront`)."""
    data = bytes(data)
    hdr = _png_header(data)
    if hdr is None:
        raise ValueError("not a PNG")
    w, h, depth, color, interlace = hdr
    if depth != 8 or interlace != 0 or color not in (2, 6):
        raise ValueError("decode_png takes 8-bit non-interlaced RGB/RGBA PNGs only")
    bpp = 3 if color == 2 else 4
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(c for t, c in _png_chunks(data) if t == b"IDAT")),
                        np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    filters = rows[:, 0]
    if not filters.any():  # every row unfiltered: the pixels as they are
        return rows[:, 1:].reshape(h, w, bpp)[..., :3].copy()
    if filters.max() > 4:
        raise ValueError(f"bad PNG filter {filters.max()}")
    if (filters >= 3).any():
        return _unfilter_wavefront(filters, rows[:, 1:].reshape(h, w, bpp))[..., :3].copy()
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = filters[y], rows[y, 1:]
        if ftype == 0:
            out[y] = cur
        elif ftype == 1:
            out[y] = np.cumsum(cur.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            out[y] = cur + prev
        prev = out[y]
    return out.reshape(h, w, bpp)[..., :3].copy()


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("this image needs Pillow (PIL), which is not installed: only 8-bit "
                          "non-interlaced RGB/RGBA PNGs decode without it") from e
    return Image


def _to_image_array(x) -> np.ndarray:
    """Decodes bytes to HWC uint8 RGB if needed; passes arrays through."""
    if isinstance(x, (bytes, bytearray, np.bytes_)):
        if png_is_plain(x):
            return decode_png(x)
        return np.asarray(_pil().open(io.BytesIO(bytes(x))).convert("RGB"))
    return np.asarray(x)


def _resize(image: np.ndarray, h: int, w: int, method: str = "bilinear",
            antialias: bool = True) -> np.ndarray:
    if image.shape[:2] == (h, w):
        return image.copy()
    Image = _pil()

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


@pp_op("decode")
@inkey_outkey(indefault="image", outdefault="image")
def get_decode(channels=3):
    def op(x, rng):
        return _to_image_array(x)

    return op


@pp_op("resize")
@inkey_outkey(indefault="image", outdefault="image")
def get_resize(size, method="bilinear", antialias=True):
    size = (size, size) if isinstance(size, int) else tuple(size)

    def op(image, rng):
        return _resize(_to_image_array(image), size[0], size[1], method, antialias)

    return op


@pp_op("resize_small")
@inkey_outkey(indefault="image", outdefault="image")
def get_resize_small(smaller_size, method="bilinear", antialias=True):
    def op(image, rng):
        return resize_small(image, smaller_size, method, antialias)

    return op


@pp_op("central_crop")
@inkey_outkey(indefault="image", outdefault="image")
def get_central_crop(crop_size):
    def op(image, rng):
        return central_crop(image, crop_size)

    return op


@pp_op("vgg_value_range")
@inkey_outkey(indefault="image", outdefault="image")
def get_vgg_value_range():
    def op(image, rng):
        return vgg_value_range(image)

    return op


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
