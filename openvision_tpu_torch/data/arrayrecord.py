"""ArrayRecord files read without grain or array_record.

The JAX pipeline serves ``input.data.name = "arrayrecord"`` with
``grain.ArrayRecordDataSource(paths)`` (``openvision_tpu/data/pipeline.py
:131``): random access to every record's bytes, the files in the order
given, each file's records in the order written. :class:`ArrayRecordSource`
is the port's own reader of the same bytes.

The format is riegeli's records file: the file is cut into 64 KiB blocks,
each beginning with a 24-byte block header (header hash, previous chunk,
next chunk), and holds chunks laid end to end across those headers. A
chunk is a 40-byte header (header hash, data size, data hash, the chunk
type and a 7-byte record count, the decoded data size) and its data.
Chunk types: ``'s'`` the file signature, ``'m'`` metadata, ``'p'``
padding, ``'r'`` simple records: a compression byte (0 none, ``'z'``
zstd, ``'b'`` Brotli, ``'s'`` snappy), the varint size of the compressed
record sizes, those sizes (varint64s), then the records' bytes; a
compressed buffer is its varint decoded size and the compressed frame.
array_record writes each group of records (``group_size``) as one simple
chunk, then a footer chunk (a metadata record, then one record a data
chunk: its offset, decoded size and record count) and last, at the start
of the last block, a postscript chunk whose record (written three times)
gives the footer's offset. The reader finds the data chunks through the postscript and the
footer and decodes a chunk when one of its records is asked for (the last
chunk decoded is kept). zstd goes through ``train/codecs.py``; Brotli and
snappy chunks raise by name. Hashes are not checked.
"""

from __future__ import annotations

import bisect
import os
import threading

import numpy as np

BLOCK, BLOCK_HEADER, CHUNK_HEADER = 1 << 16, 24, 40


def _varint(buf, pos: int):
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def _proto_ints(buf) -> dict:
    """Field number -> value of a protobuf message's varint fields."""
    out, pos = {}, 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            out[field], pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            pos += n
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        else:
            raise ValueError(f"ArrayRecord: protobuf wire type {wire} in a footer record")
    return out


class _File:
    """One riegeli file: logical reads across its block headers."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read()

    def read(self, pos: int, n: int):
        """`n` logical bytes from physical `pos` (skipping the block headers
        at block boundaries) and the physical position after them."""
        parts = []
        while n > 0:
            if pos % BLOCK == 0:
                pos += BLOCK_HEADER
            take = min(n, BLOCK - pos % BLOCK)
            parts.append(self.buf[pos:pos + take])
            if len(parts[-1]) != take:
                raise ValueError(f"{self.path}: truncated riegeli file")
            pos, n = pos + take, n - take
        return b"".join(parts), pos

    def chunk(self, pos: int):
        """(type, record count, decoded size, data, physical end) of the
        chunk beginning at physical `pos`."""
        head, pos = self.read(pos, CHUNK_HEADER)
        data_size = int.from_bytes(head[8:16], "little")
        kind = chr(head[24])
        count = int.from_bytes(head[25:32], "little")
        decoded = int.from_bytes(head[32:40], "little")
        data, end = self.read(pos, data_size)
        return kind, count, decoded, data, end


def _buffer(data, pos: int, size: int, compression: int) -> bytes:
    """One buffer of a simple chunk, decompressed."""
    raw = data[pos:pos + size]
    if compression == 0:
        return raw
    if compression == ord("z"):
        from openvision_tpu_torch.train.codecs import zstd_decompress

        n, start = _varint(raw, 0)
        return zstd_decompress(np.frombuffer(raw, np.uint8, offset=start), n).tobytes()
    name = {ord("b"): "Brotli", ord("s"): "snappy"}.get(compression, f"type {compression}")
    raise ValueError(f"ArrayRecord: a {name}-compressed chunk; the port's reader takes zstd "
                     "and uncompressed chunks")


def decode_simple_chunk(kind: str, count: int, data: bytes, where: str) -> list[bytes]:
    """The records of a simple (``'r'``) chunk."""
    if kind != "r":
        raise ValueError(f"{where}: chunk type {kind!r}; the reader decodes simple chunks ('r')")
    if count == 0:
        return []
    compression = data[0]
    sizes_size, pos = _varint(data, 1)
    sizes_buf = _buffer(data, pos, sizes_size, compression)
    values = _buffer(data, pos + sizes_size, len(data) - pos - sizes_size, compression)
    out, p, start = [], 0, 0
    for _ in range(count):
        n, p = _varint(sizes_buf, p)
        out.append(values[start:start + n])
        start += n
    return out


def chunk_index(path: str) -> list[tuple[int, int]]:
    """(physical offset, record count) of every data chunk of an ArrayRecord
    file, in order, from its postscript and footer."""
    f = _File(path)
    if len(f.buf) < BLOCK_HEADER + CHUNK_HEADER or f.chunk(0)[0] != "s":
        raise ValueError(f"{path}: not a riegeli records file (no signature chunk)")
    last = (len(f.buf) - 1) // BLOCK * BLOCK  # the postscript: the last block's first chunk
    kind, count, _, data, _ = f.chunk(last)
    post = decode_simple_chunk(kind, count, data, f"{path} postscript")  # copies of one record
    footer_offset = _proto_ints(post[0]).get(1) if post else None
    if footer_offset is None:
        raise ValueError(f"{path}: the postscript holds no footer offset")
    kind, count, _, data, _ = f.chunk(footer_offset)
    records = decode_simple_chunk(kind, count, data, f"{path} footer")
    out = []
    for rec in records[1:]:  # records[0]: the footer's metadata
        fields = _proto_ints(rec)
        out.append((fields.get(1, 0), fields.get(3, 0)))
    return out


class ArrayRecordSource:
    """Random access over the records of ArrayRecord files (each record's
    bytes), the files in the order given: ``grain.ArrayRecordDataSource``'s
    order."""

    def __init__(self, paths):
        self._paths = [paths] if isinstance(paths, (str, os.PathLike)) else list(paths)
        self._chunks: list[tuple[int, int]] = []  # (file, offset) of each chunk
        self._starts: list[int] = []  # first record index of each chunk
        n = 0
        for fi, path in enumerate(self._paths):
            for offset, count in chunk_index(path):
                self._chunks.append((fi, offset))
                self._starts.append(n)
                n += count
        self._len = n
        self._files: dict = {}
        self._cache = (None, [])  # (chunk number, its records)
        self._lock = threading.Lock()

    def __repr__(self):
        return f"ArrayRecordSource({self._paths!r})"

    def __len__(self):
        return self._len

    def __getstate__(self):
        return {**self.__dict__, "_files": {}, "_cache": (None, []), "_lock": None}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def __getitem__(self, i: int) -> bytes:
        if i < 0:
            i += self._len
        if not 0 <= i < self._len:
            raise IndexError(f"record {i} of {self._len}")
        c = bisect.bisect_right(self._starts, i) - 1
        with self._lock:
            if self._cache[0] != c:
                fi, offset = self._chunks[c]
                f = self._files.get(fi)
                if f is None:
                    f = self._files[fi] = _File(self._paths[fi])
                kind, count, _, data, _ = f.chunk(offset)
                self._cache = (c, decode_simple_chunk(kind, count, data, self._paths[fi]))
            return self._cache[1][i - self._starts[c]]
