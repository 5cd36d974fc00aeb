"""TFRecord files and ``tf.train.Example`` records without tensorflow or protobuf.

The JAX package reads and writes them through tensorflow's
``example_pb2`` (``openvision_tpu/data/pipeline.py:653``,
``data/prepare.py:70, 89``); the card's machine has neither package, so the
port carries the two wire formats itself:

- the record framing (``pipeline.py:613-623``): u64 little-endian payload
  length, u32 masked crc32c of those 8 bytes, the payload, u32 masked
  crc32c of the payload (``prepare.py:43-50``);
- the protobuf wire format of ``Example{features = 1: Features{feature = 1:
  map<string, Feature>}}``, where ``Feature`` is a oneof of ``bytes_list =
  1``, ``float_list = 2`` (packed little-endian f32, or one fixed32 a value)
  and ``int64_list = 3`` (varints, packed or one a field; a negative value
  is a 10-byte two's-complement varint), each list's values under field 1.
  Map entries come in any order; fields this reader does not know are
  skipped by their wire type.

:func:`parse_example` returns what the JAX reader returns: each feature's
values as a list (bytes, int or float), unwrapped when it holds one value;
a feature with no kind set is left out. :func:`masked_crc32c` gives the
value of the JAX package's per-byte loop by a faster route (the CRC over
many chunks at once in numpy, the chunks joined by the GF(2) operator that
runs the register over zero bytes), so a shard of images is framed in
milliseconds a megabyte.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli, reflected) and TFRecord's mask
# ---------------------------------------------------------------------------

_POLY = 0x82F63B78


def _table() -> np.ndarray:
    t = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        t[i] = c
    return t


_TABLE = _table()
_TABLE_LIST = [int(v) for v in _TABLE]
_CHUNK = 256  # bytes a lane runs through the register before the lanes are joined
_zeros_ops: Dict[int, List[int]] = {}  # log2 of a length -> its operator


def _raw_bytes(data, crc: int = 0) -> int:
    """The register after `data`, from `crc`, one byte at a time."""
    t = _TABLE_LIST
    for b in data:
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def _apply(op: List[int], x):
    """The GF(2) operator `op` (its image of each of the 32 bits) on x (an
    int or a uint32 array)."""
    if isinstance(x, np.ndarray):
        out = np.zeros_like(x)
        for b in range(32):
            out ^= np.uint32(op[b]) * ((x >> np.uint32(b)) & np.uint32(1))
        return out
    out = 0
    for b in range(32):
        if (x >> b) & 1:
            out ^= op[b]
    return out


def _pow2_op(k: int) -> List[int]:
    """The operator that runs the register over 2**k zero bytes (cached)."""
    op = _zeros_ops.get(k)
    if op is None:
        if k == 0:
            op = [_raw_bytes(b"\0", 1 << b) for b in range(32)]
        else:
            half = _pow2_op(k - 1)
            op = [_apply(half, v) for v in half]
        _zeros_ops[k] = op
    return op


def _run_zeros(x, n: int):
    """x (an int or a uint32 array) run over n zero bytes."""
    k = 0
    while n:
        if n & 1:
            x = _apply(_pow2_op(k), x)
        n >>= 1
        k += 1
    return x


def _raw(data: bytes) -> int:
    """The register after `data` from 0: linear in the data, so the data is
    cut into lanes of _CHUNK bytes (zeros in front, which leave a zero
    register as it is), each lane's register is run in numpy side by side,
    and adjacent lanes are joined pairwise: left run over the right's
    length, xor right."""
    n = len(data)
    if n <= 4 * _CHUNK:
        return _raw_bytes(data)
    lanes = 1 << (-(-n // _CHUNK) - 1).bit_length()
    buf = np.zeros(lanes * _CHUNK, np.uint8)
    buf[lanes * _CHUNK - n:] = np.frombuffer(data, np.uint8)
    cols = buf.reshape(lanes, _CHUNK)
    crc = np.zeros(lanes, np.uint32)
    for j in range(_CHUNK):
        crc = _TABLE[(crc ^ cols[:, j]) & 0xFF] ^ (crc >> np.uint32(8))
    width = _CHUNK
    while len(crc) > 1:
        crc = _run_zeros(crc[0::2], width) ^ crc[1::2]
        width *= 2
    return int(crc[0])


def crc32c(data: bytes) -> int:
    """The standard crc32c of `data` (initial and final xor 0xFFFFFFFF)."""
    data = bytes(data)
    if len(data) <= 4 * _CHUNK:
        return _raw_bytes(data, 0xFFFFFFFF) ^ 0xFFFFFFFF
    start = _run_zeros(0xFFFFFFFF, len(data))  # the initial register run over the data
    return start ^ _raw(data) ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked crc32c: rotate right by 15, plus 0xA282EAD8."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------


def frame(payload: bytes) -> bytes:
    """One framed record: length, its masked crc, payload, its masked crc."""
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", masked_crc32c(length)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


class TFRecordWriter:
    """Writes framed records to one file."""

    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        self._f.write(frame(payload))

    def close(self) -> None:
        self._f.close()


def index_records(path: str) -> List[Tuple[int, int]]:
    """(payload offset, payload length) of every record of one file; the
    checksums are not verified (as the JAX reader). The native indexer
    (``native/indexer.cpp``) walks the file; with ``OPENVISION_NO_NATIVE``
    set, :func:`index_records_py` does."""
    from openvision_tpu_torch.native import indexer

    out = indexer.tfrecord_index(path)
    return index_records_py(path) if out is None else out


def index_records_py(path: str) -> List[Tuple[int, int]]:
    """The Python walk of :func:`index_records`."""
    out = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 12 <= size:
            f.seek(pos)
            (length,) = struct.unpack("<Q", f.read(8))
            out.append((pos + 12, length))
            pos += 16 + length
    return out


# ---------------------------------------------------------------------------
# tf.train.Example, wire format
# ---------------------------------------------------------------------------


def _varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _fields(buf, start: int = 0, end: int | None = None):
    """(field number, wire type, value) of one message: an int for varint
    and fixed fields, a (start, end) span for length-delimited ones."""
    pos, end = start, len(buf) if end is None else end
    while pos < end:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = (pos, pos + n), pos + n
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        else:
            raise ValueError(f"tf.train.Example: unsupported wire type {wire}")
        yield field, wire, value


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _feature(buf, start: int, end: int):
    """One Feature -> (kind or None, values)."""
    kind, vals = None, []
    for field, wire, value in _fields(buf, start, end):
        if field not in (1, 2, 3) or wire != 2:
            continue
        kind, vals = field, []  # oneof: the last kind wins
        for f, w, v in _fields(buf, *value):
            if f != 1:
                continue
            if field == 1:  # bytes_list
                vals.append(bytes(buf[v[0]:v[1]]))
            elif field == 2:  # float_list: packed f32, or one fixed32
                if w == 2:
                    vals.extend(np.frombuffer(bytes(buf[v[0]:v[1]]), "<f4").tolist())
                elif w == 5:
                    vals.append(struct.unpack("<f", struct.pack("<I", v))[0])
            elif w == 2:  # int64_list packed
                p = v[0]
                while p < v[1]:
                    x, p = _varint(buf, p)
                    vals.append(_int64(x))
            elif w == 0:
                vals.append(_int64(v))
    return kind, vals


def parse_example(payload: bytes) -> Dict[str, Any]:
    """A serialized tf.train.Example -> {name: values}, each a list unwrapped
    when it has one element (JAX ``pipeline.py:654-667``)."""
    buf = memoryview(payload)
    out: Dict[str, Any] = {}
    for field, wire, span in _fields(buf):
        if field != 1 or wire != 2:
            continue
        for f, w, entry in _fields(buf, *span):  # Features.feature map entries
            if f != 1 or w != 2:
                continue
            name, kind, vals = "", None, []
            for ef, ew, ev in _fields(buf, *entry):
                if ef == 1 and ew == 2:
                    name = bytes(buf[ev[0]:ev[1]]).decode("utf-8")
                elif ef == 2 and ew == 2:
                    kind, vals = _feature(buf, *ev)
            if kind is None:
                out.pop(name, None)
                continue
            out[name] = vals[0] if len(vals) == 1 else vals
    return out


def _put_varint(out: bytearray, v: int) -> None:
    v &= (1 << 64) - 1
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _put_len(out: bytearray, field: int, body: bytes) -> None:
    _put_varint(out, (field << 3) | 2)
    _put_varint(out, len(body))
    out += body


def _values(value) -> Tuple[int, list]:
    """(Feature field, values) of a Python or numpy value."""
    vals = value if isinstance(value, (list, tuple, np.ndarray)) else [value]
    vals = list(np.asarray(vals).reshape(-1)) if isinstance(vals, np.ndarray) else list(vals)
    if not vals:
        raise ValueError("serialize_example: an empty feature has no kind")
    first = vals[0]
    if isinstance(first, (bytes, bytearray, str, np.bytes_, np.str_)):
        return 1, [v.encode("utf-8") if isinstance(v, str) else bytes(v) for v in vals]
    if isinstance(first, (float, np.floating)):
        return 2, [float(v) for v in vals]
    if isinstance(first, (int, np.integer)):
        return 3, [int(v) for v in vals]
    raise TypeError(f"serialize_example: no Feature kind for {type(first).__name__}")


def serialize_example(features: Dict[str, Any]) -> bytes:
    """{name: bytes | str | int | float or a list / array of one kind} -> a
    serialized tf.train.Example (floats packed as f32, ints as packed
    varints)."""
    feats = bytearray()
    for name, value in features.items():
        kind, vals = _values(value)
        lst = bytearray()
        if kind == 1:
            for v in vals:
                _put_len(lst, 1, v)
        elif kind == 2:
            _put_len(lst, 1, np.asarray(vals, "<f4").tobytes())
        else:
            packed = bytearray()
            for v in vals:
                _put_varint(packed, v)
            _put_len(lst, 1, bytes(packed))
        feature = bytearray()
        _put_len(feature, kind, bytes(lst))
        entry = bytearray()
        _put_len(entry, 1, name.encode("utf-8"))
        _put_len(entry, 2, bytes(feature))
        _put_len(feats, 1, bytes(entry))
    out = bytearray()
    _put_len(out, 1, bytes(feats))
    return bytes(out)
