"""zarr v2 arrays over any key-value store: the leaves of Orbax and legacy
tensorstore checkpoints.

An array is a ``.zarray`` JSON document (shape, chunk shape, dtype, order,
compressor, fill value, dimension separator) beside one value per chunk,
keyed by the chunk's grid indices joined by the separator ("0.0", "1.0";
"0" for a 0-d array). :func:`read_array` reads one through ``get(key) ->
bytes or None`` (an OCDBT database's keys or a directory's files), in C or
F order, with ragged edge chunks, and a missing chunk read as the fill
value (zero for ``null``), as the zarr v2 spec says. Chunks are raw, zstd
or blosc (:mod:`.codecs`); filters are not supported. ``bfloat16`` arrays
come back as ``torch.bfloat16`` tensors (numpy has no such type), the rest
as numpy arrays. A zarr v3 array (``zarr.json``) raises by name.
:func:`zarray` writes the document the port's Orbax writer stores.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Callable, Optional

import numpy as np
import torch

from openvision_tpu_torch.train import codecs

Get = Callable[[str], Optional[bytes]]


def _numpy_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype("<u2")  # its bits; viewed as torch.bfloat16 at the end
    if not isinstance(name, str):
        raise NotImplementedError(f"zarr structured dtype {name!r} is not supported")
    return np.dtype(name)


def zarray(shape, dtype: str, compressor: Optional[dict] = None) -> bytes:
    """The ``.zarray`` of a one-chunk C-order array, as tensorstore writes it."""
    shape = [int(d) for d in shape]
    return json.dumps({"chunks": [max(d, 1) for d in shape], "compressor": compressor,
                       "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                       "filters": None, "order": "C", "shape": shape, "zarr_format": 2},
                      sort_keys=True, separators=(",", ":")).encode()


def dtype_name(value) -> str:
    """The zarr v2 dtype string of a numpy array or torch tensor."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            return "bfloat16"
        return torch.empty(0, dtype=value.dtype).numpy().dtype.str
    return np.asarray(value).dtype.str


def decode_chunk(data, meta: dict, nbytes: int) -> np.ndarray:
    comp = meta.get("compressor")
    if comp is None:
        out = np.frombuffer(data, np.uint8)
    elif comp["id"] == "zstd":
        out = codecs.zstd_decompress(data, nbytes)
    elif comp["id"] == "blosc":
        out = codecs.blosc_decompress(data)
    else:
        raise NotImplementedError(f"zarr compressor {comp['id']!r} is not supported "
                                  "(zstd, blosc or none)")
    if out.nbytes != nbytes:
        raise ValueError(f"a zarr chunk of {out.nbytes} bytes, expected {nbytes}")
    return out


def _fill(meta: dict, dtype: np.dtype, shape) -> np.ndarray:
    value = meta.get("fill_value")
    if value is None or value == 0:
        return np.zeros(shape, dtype)
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = float(value.replace("Infinity", "inf"))
    if meta["dtype"] == "bfloat16":
        value = torch.tensor(value, dtype=torch.bfloat16).view(torch.int16).item() & 0xFFFF
    return np.full(shape, value, dtype)


def read_array(get: Get, prefix: str = ""):
    """The array stored under `prefix` ("params.img.w/" in an OCDBT store,
    "" in a legacy leaf's directory)."""
    raw = get(prefix + ".zarray")
    if raw is None:
        if get(prefix + "zarr.json") is not None:
            raise NotImplementedError(f"{prefix!r}: zarr v3 arrays are not supported (v2 only)")
        raise FileNotFoundError(f"no zarr array at {prefix!r}")
    meta = json.loads(raw)
    if meta.get("zarr_format", 2) != 2:
        raise NotImplementedError(f"zarr format {meta.get('zarr_format')} is not supported")
    if meta.get("filters"):
        raise NotImplementedError(f"zarr filters {meta['filters']} are not supported")
    dtype = _numpy_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order, sep = meta.get("order", "C"), meta.get("dimension_separator", ".")
    nbytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    out = None
    for idx in itertools.product(*grid):
        key = sep.join(map(str, idx)) if shape else "0"
        data = get(prefix + key)
        if data is None:
            chunk = _fill(meta, dtype, chunks)
        else:
            flat = decode_chunk(data, meta, nbytes).view(dtype)
            chunk = (flat.reshape(chunks) if order == "C"
                     else flat.reshape(chunks[::-1]).transpose())
        if chunks == shape:  # one chunk covers the array: no copy
            out = chunk
            break
        if out is None:
            out = np.empty(shape, dtype)
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        out[tuple(map(slice, lo, hi))] = chunk[tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    if out is None:  # an array with a zero-sized dimension
        out = np.empty(shape, dtype)
    if not out.flags.writeable:
        out = out.copy()
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(out).view(np.int16)).view(torch.bfloat16)
    return out


def chunk_bytes(value) -> np.ndarray:
    """The C-order bytes (a uint8 array, no copy where none is needed) of one
    numpy array or torch tensor."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().contiguous()
        if value.dtype == torch.bfloat16:
            value = value.view(torch.int16)
        value = value.numpy()
    return np.ascontiguousarray(value).reshape(-1).view(np.uint8)
