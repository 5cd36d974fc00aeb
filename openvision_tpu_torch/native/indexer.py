"""ctypes bindings of the native shard indexer (``indexer.cpp``).

``tar_index(path)`` -> [(name, offset, size)] of the regular members of a
tar shard; ``tfrecord_index(path)`` -> [(offset, size)] of a TFRecord
file's record payloads. Both return None when ``OPENVISION_NO_NATIVE`` is
set (the callers then scan in Python: tarfile, the struct walk of
``data/tfrecord.py``); otherwise the library is built at first use
(``native/build.py``), a build failure raises, and a library that is
missing is built again at the next call (nothing remembers its absence).
A shard the scanner cannot read raises.
"""

from __future__ import annotations

import ctypes
import os

from openvision_tpu_torch.native import build

_LIBS: dict = {}  # loaded libraries by path


def _lib():
    if os.environ.get("OPENVISION_NO_NATIVE"):
        return None
    path = build.library("indexer")
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        long_p = ctypes.POINTER(ctypes.c_long)
        lib.tar_index.restype = ctypes.c_long
        lib.tar_index.argtypes = [ctypes.c_char_p, long_p, long_p, ctypes.c_char_p,
                                  ctypes.c_long, ctypes.c_long]
        lib.tfrecord_index.restype = ctypes.c_long
        lib.tfrecord_index.argtypes = [ctypes.c_char_p, long_p, long_p, ctypes.c_long]
        _LIBS[path] = lib
    return lib


def _check(n: int, path: str) -> None:
    if n < 0:
        raise OSError(f"the native indexer could not scan {path!r} "
                      f"({'unreadable' if n == -1 else 'more entries than its buffers hold'})")


def tar_index(path: str):
    lib = _lib()
    if lib is None:
        return None
    # headers are 512 bytes apart, so entries <= filesize / 512 (names < 260
    # bytes each but for PAX ones); the buffers start small and grow on -2,
    # since zeroing the worst case costs more than the scan
    most = os.path.getsize(path) // 512 + 2
    cap, name_cap, fpath = min(most, 1024), 1024 * 128, os.fsencode(path)
    while True:
        offsets, sizes = (ctypes.c_long * cap)(), (ctypes.c_long * cap)()
        names = ctypes.create_string_buffer(name_cap)
        n = lib.tar_index(fpath, offsets, sizes, names, cap, name_cap)
        if n != -2 or (cap >= most and name_cap >= os.path.getsize(path)):
            break
        cap, name_cap = min(most, cap * 8), name_cap * 8
    _check(n, path)
    raw, pos, out = names.raw, 0, []
    for i in range(n):
        end = raw.index(b"\x00", pos)
        out.append((raw[pos:end].decode("utf-8", "replace"), offsets[i], sizes[i]))
        pos = end + 1
    return out


def tfrecord_index(path: str):
    lib = _lib()
    if lib is None:
        return None
    # records are at least 16 bytes apart; the buffers grow from 1024 on -2
    most = os.path.getsize(path) // 16 + 2
    cap, fpath = min(most, 1024), os.fsencode(path)
    while True:
        offsets, sizes = (ctypes.c_long * cap)(), (ctypes.c_long * cap)()
        n = lib.tfrecord_index(fpath, offsets, sizes, cap)
        if n != -2 or cap >= most:
            break
        cap = min(most, cap * 16)
    _check(n, path)
    return list(zip(offsets[:n], sizes[:n]))
