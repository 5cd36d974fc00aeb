"""An OCDBT key-value store: the reader, and a writer of Orbax's layout.

OCDBT ("optionally-cooperative distributed B+tree", tensorstore's
documentation "OCDBT format") is the store every Orbax train state keeps
its zarr arrays in. What this module reads and writes:

- A **manifest** (``manifest.ocdbt``) and every **B-tree node** is a
  header (a big-endian magic, 0x0cdb3a2a or 0x0cdb20de; the file's length
  as u64le; a varint version, 0; a varint compression, 0 raw or 1 zstd),
  the body, and the CRC-32C (Castagnoli) of everything before it as u32le.
- The manifest's body: the config (a 16-byte uuid; varints manifest kind,
  ``max_inline_value_bytes``, ``max_decoded_node_bytes``; a byte
  ``version_tree_arity_log2``; a varint compression and, for zstd, an
  int32le level), then the newest versions, column by column: a data-file
  table, the count, generation numbers, root heights (bytes), the roots'
  data file, offset and length, their key, tree-byte and indirect-byte
  counts, commit times (u64le); then the version-tree node references,
  which only older versions need. The newest version is the last.
- A data-file table: the count, the shared-prefix lengths of entries 1..,
  the suffix lengths, the base-path lengths, then the suffixes. A path is
  ``base_path + relative_path`` under the database's directory; a node's
  table is read under the base path of the file that holds the node, so a
  merged top-level database can reach the trees of ``ocdbt.process_<i>/``.
- A node's body: its height (a byte), a data-file table, the count, keys
  (shared-prefix lengths of entries 1.., suffix lengths, for interior nodes
  each child's common key prefix length, then the suffixes). A leaf then
  has value lengths, value kinds (0 inline, 1 indirect), the indirect
  values' data files and offsets, and the inline values' bytes. An interior
  node has its children's data files, offsets and lengths and three counts
  each; a child's keys omit the common prefix its entry names.

:class:`Database` reads the newest version's keys and values. A manifest
of the "numbered" kind (config kind 1) holds the config alone; the versions
are in ``manifest.<generation as 16 hex digits>`` files beside it, of which
the newest (the highest generation, as tensorstore reads them) is read as a
single manifest is. A save of several processes (``ocdbt.process_<i>/``
stores under one merged top-level manifest) is read through the base paths
of its nodes' data-file tables: the top-level tree reaches, and reuses, the
nodes each process wrote. :func:`write_orbax_store` writes what
one process of an Orbax save leaves: the values (those over 1024 bytes in
a data file) and one leaf node in ``ocdbt.process_0/``, its manifest, and
the top-level manifest and node that reach the same values through the
``ocdbt.process_0/`` base path, every manifest and node zstd-compressed.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import time
import uuid
from typing import Dict, Iterable, List, Optional, Tuple, Union

from openvision_tpu_torch.data.tfrecord import crc32c
from openvision_tpu_torch.train import codecs

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
MAX_INLINE_VALUE_BYTES = 1024  # Orbax's setting
MAX_DECODED_NODE_BYTES = 100_000_000
_EMPTY = 2**64 - 1  # the length of an empty tree's root
_NUMBERED = re.compile(r"manifest\.[0-9a-f]{16}")
FileId = Tuple[str, str]  # (base path, relative path)
Ref = Tuple[str, int, int]  # (path under the database, offset, length)


class _Cursor:
    def __init__(self, data):
        self.data, self.pos, self.kind = memoryview(data), 0, 0

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        out = bytes(self.data[self.pos:self.pos + n])
        if len(out) != n:
            raise ValueError("OCDBT: truncated data")
        self.pos += n
        return out


def _varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _varints(out: bytearray, values) -> None:
    for v in values:
        _varint(out, v)


def decode_file(data, magic: int, what: str) -> bytes:
    """The body of one manifest or node, its header and CRC-32C checked."""
    data = bytes(data)
    if len(data) < 18 or struct.unpack_from(">I", data)[0] != magic:
        raise ValueError(f"OCDBT {what}: bad magic")
    if struct.unpack_from("<Q", data, 4)[0] != len(data):
        raise ValueError(f"OCDBT {what}: the length in its header is not its size")
    if crc32c(data[:-4]) != struct.unpack_from("<I", data, len(data) - 4)[0]:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    c = _Cursor(data)
    c.pos = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise NotImplementedError(f"OCDBT {what} format version {version}")
    body = data[c.pos:-4]
    if compression == 1:
        return codecs.zstd_decompress(body).tobytes()
    if compression != 0:
        raise NotImplementedError(f"OCDBT {what} compression {compression}")
    return body


def encode_file(body: bytes, magic: int) -> bytes:
    comp = codecs.zstd_compress(body).tobytes()
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + 2 + len(comp) + 4) + b"\x00\x01"
    data = head + comp
    return data + struct.pack("<I", crc32c(data))


def _read_table(c: _Cursor, transitive: str = "") -> List[FileId]:
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix, base = c.varints(n), c.varints(n)
    out, prev = [], b""
    for p, s, b in zip(prefix, suffix, base):
        full = prev[:p] + c.take(s)
        prev = full
        out.append((transitive + full[:b].decode(), full[b:].decode()))
    return out


def _write_table(out: bytearray, files: List[FileId]) -> None:
    paths = [(b + r).encode() for b, r in files]
    prefix = [0] + [len(os.path.commonprefix([a, b])) for a, b in zip(paths, paths[1:])]
    _varint(out, len(paths))
    _varints(out, prefix[1:])
    _varints(out, (len(p) - k for p, k in zip(paths, prefix)))
    _varints(out, (len(b.encode()) for b, _ in files))
    for p, k in zip(paths, prefix):
        out += p[k:]


def _read_keys(c: _Cursor, n: int, interior: bool):
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + c.take(s)
        keys.append(prev)
    return keys, common


class Database:
    """The newest version of the OCDBT database in `root`: its keys and,
    through :meth:`get`, their values (thread-safe)."""

    def __init__(self, root: str):
        self.root = root
        self.entries: Dict[bytes, Union[bytes, Ref]] = {}
        self._fds: Dict[str, int] = {}
        self._lock = threading.Lock()
        c = self._manifest("manifest.ocdbt")
        if c.kind == 1:  # numbered: the versions are in the newest manifest.<16 hex digits>
            numbered = [n for n in os.listdir(root) if _NUMBERED.fullmatch(n)]
            if not numbered:
                raise FileNotFoundError(f"{root}: a numbered OCDBT manifest kind without any "
                                        "manifest.<number> file")
            c = self._manifest(max(numbered, key=lambda n: int(n[9:], 16)))
        elif c.kind != 0:
            raise NotImplementedError(f"{root}: OCDBT manifest kind {c.kind} (single 0 or "
                                      "numbered 1)")
        table = _read_table(c)
        n = c.varint()
        if not n:
            return
        c.varints(n)  # generation numbers
        heights = c.take(n)
        fid, off, length = c.varints(n), c.varints(n), c.varints(n)
        if length[-1] != _EMPTY:
            self._walk(table[fid[-1]], off[-1], length[-1], heights[-1], b"")

    def _manifest(self, name: str) -> "_Cursor":
        """A cursor past the config of the manifest file `name`; its ``kind``
        set to the config's manifest kind."""
        with open(os.path.join(self.root, name), "rb") as f:
            c = _Cursor(decode_file(f.read(), MANIFEST_MAGIC, "manifest"))
        c.take(16)  # uuid
        c.kind = c.varint()
        c.varint(), c.varint(), c.take(1)  # max inline / decoded node bytes, arity
        if c.varint() == 1:
            c.take(4)  # zstd level
        return c

    def _walk(self, fid: FileId, offset: int, length: int, height: int, prefix: bytes):
        body = decode_file(self._pread(fid[0] + fid[1], offset, length), NODE_MAGIC, "node")
        c = _Cursor(body)
        if c.take(1)[0] != height:
            raise ValueError(f"OCDBT node at {fid}:{offset}: height mismatch")
        table = _read_table(c, fid[0])
        n = c.varint()
        keys, common = _read_keys(c, n, height > 0)
        if height:
            ids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            for key, k, i, o, ln in zip(keys, common, ids, offs, lens):
                self._walk(table[i], o, ln, height - 1, prefix + key[:k])
            return
        lengths, kinds = c.varints(n), c.varints(n)
        indirect = sum(kinds)
        ids, offs = c.varints(indirect), c.varints(indirect)
        refs = iter(zip(ids, offs))
        for key, ln, kind in zip(keys, lengths, kinds):
            if kind:
                i, o = next(refs)
                self.entries[prefix + key] = (table[i][0] + table[i][1], o, ln)
            else:
                self.entries[prefix + key] = c.take(ln)

    def _pread(self, path: str, offset: int, length: int) -> bytes:
        with self._lock:
            fd = self._fds.get(path)
            if fd is None:
                fd = self._fds[path] = os.open(os.path.join(self.root, path), os.O_RDONLY)
        data = os.pread(fd, length, offset)
        if len(data) != length:
            raise ValueError(f"OCDBT: {path} holds {len(data)} bytes at {offset}, "
                             f"expected {length}")
        return data

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self.entries)

    def get(self, key: str) -> Optional[bytes]:
        value = self.entries.get(key.encode())
        if value is None or isinstance(value, bytes):
            return value
        return self._pread(*value)

    def close(self) -> None:
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _leaf(items: List[Tuple[bytes, Union[bytes, Tuple[int, int]]]], files: List[FileId]) -> bytes:
    """One leaf node: `items` sorted by key, each an inline value or an
    (offset, length) in the table's one data file."""
    body = bytearray([0])
    _write_table(body, files)
    keys = [k for k, _ in items]
    _varint(body, len(keys))
    prefix = [0] + [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    _varints(body, prefix[1:])
    _varints(body, (len(k) - p for k, p in zip(keys, prefix)))
    for k, p in zip(keys, prefix):
        body += k[p:]
    refs = [v for _, v in items if isinstance(v, tuple)]
    _varints(body, (v[1] if isinstance(v, tuple) else len(v) for _, v in items))
    _varints(body, (int(isinstance(v, tuple)) for _, v in items))
    _varints(body, [0] * len(refs))
    _varints(body, (o for o, _ in refs))
    for _, v in items:
        if not isinstance(v, tuple):
            body += v
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"an OCDBT leaf of {len(body)} bytes: over the "
                         f"{MAX_DECODED_NODE_BYTES}-byte node limit")
    return encode_file(bytes(body), NODE_MAGIC)


def _manifest(root_file: FileId, offset: int, length: int, num_keys: int,
              indirect_bytes: int) -> bytes:
    body = bytearray(uuid.uuid4().bytes)
    _varints(body, (0, MAX_INLINE_VALUE_BYTES, MAX_DECODED_NODE_BYTES))
    body += bytes([4, 1]) + struct.pack("<i", 0)  # arity log2 4; zstd at its default level
    _write_table(body, [root_file])
    _varints(body, (1, 1))  # one version, generation 1
    body.append(0)  # root height
    _varints(body, (0, offset, length, num_keys, length, indirect_bytes))
    body += struct.pack("<Q", time.time_ns())
    _varint(body, 0)  # no version-tree nodes
    return encode_file(bytes(body), MANIFEST_MAGIC)


def write_orbax_store(root: str, items: Iterable[Tuple[str, bytes]], process: int = 0) -> dict:
    """Writes `items` (key, value: bytes or a uint8 array) under `root` as
    one process of an Orbax save lays them out; returns the bytes written."""
    sub = f"ocdbt.process_{process}/"
    name = "d/" + uuid.uuid4().hex
    os.makedirs(os.path.join(root, sub, "d"), exist_ok=True)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    entries, offset = [], 0
    with open(os.path.join(root, sub, name), "wb") as f:
        for key, value in items:
            if len(value) > MAX_INLINE_VALUE_BYTES:
                f.write(value)
                entries.append((key.encode(), (offset, len(value))))
                offset += len(value)
            else:
                entries.append((key.encode(), bytes(value)))
        entries.sort(key=lambda e: e[0])
        node = _leaf(entries, [("", name)] if offset else [])
        f.write(node)
    with open(os.path.join(root, sub, "manifest.ocdbt"), "wb") as f:
        f.write(_manifest(("", name), offset, len(node), len(entries), offset))
    top_name = "d/" + uuid.uuid4().hex
    top = _leaf(entries, [(sub, name)] if offset else [])
    with open(os.path.join(root, top_name), "wb") as f:
        f.write(top)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_manifest(("", top_name), 0, len(top), len(entries), offset))
    return {"values": offset, "nodes": len(node) + len(top)}
