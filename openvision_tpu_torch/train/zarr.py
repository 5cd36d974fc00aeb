"""zarr v2 and v3 arrays over any key-value store: the leaves of Orbax and
legacy tensorstore checkpoints.

An array is a ``.zarray`` JSON document (shape, chunk shape, dtype, order,
compressor, fill value, dimension separator) beside one value per chunk,
keyed by the chunk's grid indices joined by the separator ("0.0", "1.0";
"0" for a 0-d array). :func:`read_array` reads one through ``get(key) ->
bytes or None`` (an OCDBT database's keys or a directory's files), in C or
F order, with ragged edge chunks, and a missing chunk read as the fill
value (zero for ``null``), as the zarr v2 spec says. Chunks are raw, zstd
or blosc (:mod:`.codecs`); filters are not supported. ``bfloat16`` arrays
come back as ``torch.bfloat16`` tensors (numpy has no such type), the rest
as numpy arrays. :func:`zarray` writes the document the port's Orbax writer
stores.

A zarr v3 array (``zarr.json``, what Orbax writes with ``use_zarr3``) is
read the same way: a regular chunk grid, the ``default`` chunk keys
("c/0/0", "c" for a 0-d array; the separator of the document), every
chunk the full chunk shape, a missing one read as the fill value. Its
codec chain, as Orbax's writer sets it: the ``bytes`` codec with its
endianness; ``zstd`` and ``crc32c`` over the bytes; and
``sharding_indexed`` (Orbax's writer puts every chunk in a shard): the
shard's inner chunks, each decoded by the inner chain, found through an
index of (offset, length) u64 pairs at the shard's end (or start), itself
encoded by the index chain (``bytes``, ``crc32c``), an inner chunk of
offset and length 2**64 - 1 being absent. Any other codec raises by name.
"""

from __future__ import annotations

import itertools
import json
import math
import struct
from typing import Callable, Optional

import numpy as np
import torch

from openvision_tpu_torch.data.tfrecord import crc32c
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
        raw = get(prefix + "zarr.json")
        if raw is None:
            raise FileNotFoundError(f"no zarr array at {prefix!r}")
        return _read_v3(get, prefix, json.loads(raw))
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
    return _finish(out, shape, dtype, meta["dtype"])


def _finish(out, shape, dtype: np.dtype, name: str):
    if out is None:  # an array with a zero-sized dimension
        out = np.empty(shape, dtype)
    if not out.flags.writeable:
        out = out.copy()
    if name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(out).view(np.int16)).view(torch.bfloat16)
    return out


_ABSENT = 2**64 - 1  # a sharding index's offset and length of an absent inner chunk


def _v3_bytes(data: bytes, codec: dict) -> bytes:
    """One bytes -> bytes codec of a zarr v3 chain, decoded."""
    name, cfg = codec["name"], codec.get("configuration") or {}
    if name == "zstd":
        return codecs.zstd_decompress(data).tobytes()
    if name == "crc32c":
        if len(data) < 4 or crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
            raise ValueError("zarr v3: crc32c checksum mismatch")
        return data[:-4]
    raise NotImplementedError(f"zarr v3 codec {name!r} ({cfg}) is not supported (bytes, zstd, "
                              "crc32c, sharding_indexed)")


def _v3_chunk(data: bytes, chain: list, shape: tuple, dtype: np.dtype, fill) -> np.ndarray:
    """One encoded chunk (or shard) of `shape` through the codec `chain`."""
    split = next((i for i, c in enumerate(chain) if c["name"] in ("bytes", "sharding_indexed")),
                 None)
    if split is None or split:
        bad = chain[0]["name"] if chain else "(an empty chain)"
        raise NotImplementedError(f"zarr v3 codec {bad!r} is not supported (array -> array "
                                  "codecs; bytes or sharding_indexed first)")
    for codec in reversed(chain[1:]):
        data = _v3_bytes(data, codec)
    codec = chain[0]
    cfg = codec.get("configuration") or {}
    if codec["name"] == "bytes":
        order = ">" if cfg.get("endian", "little") == "big" else "<"
        flat = np.frombuffer(data, dtype.newbyteorder(order) if dtype.itemsize > 1 else dtype)
        if flat.size != math.prod(shape):
            raise ValueError(f"a zarr v3 chunk of {flat.size} values, expected {math.prod(shape)}")
        return flat.astype(dtype, copy=False).reshape(shape)
    inner = tuple(cfg["chunk_shape"])
    grid = tuple(s // c for s, c in zip(shape, inner))
    index_chain = cfg.get("index_codecs") or [{"name": "bytes",
                                               "configuration": {"endian": "little"}},
                                              {"name": "crc32c"}]
    size = 16 * math.prod(grid) + 4 * sum(c["name"] == "crc32c" for c in index_chain)
    at_end = cfg.get("index_location", "end") == "end"
    raw = data[len(data) - size:] if at_end else data[:size]
    index = _v3_chunk(raw, index_chain, grid + (2,), np.dtype("<u8"), 0)
    out = np.empty(shape, dtype)
    for idx in itertools.product(*map(range, grid)):
        offset, length = (int(v) for v in index[idx])
        region = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, inner))
        if offset == _ABSENT and length == _ABSENT:
            out[region] = fill
        else:
            out[region] = _v3_chunk(data[offset:offset + length], cfg["codecs"], inner, dtype,
                                    fill)
    return out


def _v3_fill(value, dtype: np.dtype, name: str):
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = float(value.replace("Infinity", "inf"))
    if name == "bfloat16":
        return torch.tensor(float(value or 0), dtype=torch.bfloat16).view(torch.int16).item() & 0xFFFF
    return np.asarray(value if value is not None else 0).astype(dtype)


def _read_v3(get: Get, prefix: str, meta: dict):
    if meta.get("zarr_format") != 3 or meta.get("node_type", "array") != "array":
        raise NotImplementedError(f"{prefix!r}: zarr.json of format {meta.get('zarr_format')} "
                                  f"and node type {meta.get('node_type')} is not an array")
    name = meta["data_type"]
    if not isinstance(name, str):
        raise NotImplementedError(f"zarr v3 data type {name!r} is not supported")
    dtype = _numpy_dtype(name).newbyteorder("=")
    shape = tuple(meta["shape"])
    grid_meta, keys = meta["chunk_grid"], meta.get("chunk_key_encoding") or {"name": "default"}
    if grid_meta.get("name") != "regular":
        raise NotImplementedError(f"zarr v3 chunk grid {grid_meta.get('name')!r} is not supported")
    chunks = tuple(grid_meta["configuration"]["chunk_shape"])
    sep = (keys.get("configuration") or {}).get("separator", "/")
    if keys["name"] != "default":
        raise NotImplementedError(f"zarr v3 chunk key encoding {keys['name']!r} is not supported")
    fill = _v3_fill(meta.get("fill_value"), dtype, name)
    out = None
    for idx in itertools.product(*(range(-(-s // c)) for s, c in zip(shape, chunks))):
        data = get(prefix + sep.join(("c",) + tuple(map(str, idx))))
        chunk = (np.full(chunks, fill, dtype) if data is None
                 else _v3_chunk(data, meta["codecs"], chunks, dtype, fill))
        if chunks == shape:
            out = chunk
            break
        if out is None:
            out = np.empty(shape, dtype)
        lo = [i * c for i, c in zip(idx, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        out[tuple(map(slice, lo, hi))] = chunk[tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    return _finish(out, shape, dtype, name)


def chunk_bytes(value) -> np.ndarray:
    """The C-order bytes (a uint8 array, no copy where none is needed) of one
    numpy array or torch tensor."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().contiguous()
        if value.dtype == torch.bfloat16:
            value = value.view(torch.int16)
        value = value.numpy()
    return np.ascontiguousarray(value).reshape(-1).view(np.uint8)
