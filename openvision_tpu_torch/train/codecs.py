"""The compressors of the JAX package's checkpoint formats, over the system
libraries through ctypes.

- zstd (``libzstd.so.1``): Orbax writes every zarr chunk, OCDBT manifest
  and B-tree node as a zstd frame. Its chunk frames carry no content size,
  so :func:`zstd_decompress` takes the size the caller knows (a zarr chunk's
  bytes) and decompresses into a buffer of that size; a frame of a size
  nobody knows (tensorstore writes large B-tree nodes so) is streamed.
  :func:`zstd_compress` writes level 1, as Orbax does.
- blosc v1 with lz4 (``liblz4.so.1``), read only: the legacy tensorstore
  checkpoints' ``{"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle":
  -1}``. :func:`blosc_decompress` parses blosc's 16-byte header and its
  table of block starts itself, decompresses each block's streams (one a
  byte of the type when blosc split the block) with ``LZ4_decompress_safe``
  and undoes the byte shuffle (or the bit shuffle tensorstore picks for
  1-byte types) with numpy. Blocks compressed with zstd
  (compressor code 4) go through :func:`zstd_decompress`.

A library is loaded at its first use and kept once found; a missing one
raises at each use, naming it, and is looked for again the next time.
Nothing falls back to another codec.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_LIBS: dict = {}
_ZSTD_UNKNOWN = 2**64 - 1
_ZSTD_ERROR = 2**64 - 2


class _Buffer(ctypes.Structure):  # ZSTD_inBuffer / ZSTD_outBuffer
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _load(name: str, soname: str):
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    for candidate in (ctypes.util.find_library(name), soname):
        if not candidate:
            continue
        try:
            lib = ctypes.CDLL(candidate)
            break
        except OSError:
            continue
    if lib is None:
        raise OSError(f"{soname} (the {name} library) was not found: the {name} codec of the "
                      "checkpoint formats needs it installed")
    if name == "zstd":
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                        ctypes.c_size_t)
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                      ctypes.c_size_t, ctypes.c_int)
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = (ctypes.c_size_t,)
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = (ctypes.c_size_t,)
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = (ctypes.c_size_t,)
        lib.ZSTD_createDStream.restype = ctypes.c_void_p
        lib.ZSTD_freeDStream.argtypes = (ctypes.c_void_p,)
        lib.ZSTD_initDStream.restype = ctypes.c_size_t
        lib.ZSTD_initDStream.argtypes = (ctypes.c_void_p,)
        lib.ZSTD_DStreamOutSize.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.restype = ctypes.c_size_t
        lib.ZSTD_decompressStream.argtypes = (ctypes.c_void_p, ctypes.POINTER(_Buffer),
                                              ctypes.POINTER(_Buffer))
    else:
        lib.LZ4_decompress_safe.restype = ctypes.c_int
        lib.LZ4_decompress_safe.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int)
    _LIBS[name] = lib
    return lib


def zstd_lib():
    return _load("zstd", "libzstd.so.1")


def lz4_lib():
    return _load("lz4", "liblz4.so.1")


def _src(data):
    """(pointer, length) of a bytes-like object, without a copy."""
    if isinstance(data, bytes):
        return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), len(data)
    view = np.frombuffer(data, np.uint8)
    return view.ctypes.data, view.nbytes


def zstd_decompress(data, size: int | None = None) -> np.ndarray:
    """The bytes (uint8 array) of the zstd frame(s) in `data`: into a
    buffer of `size` bytes where the caller knows it, else of the frame's
    recorded content size, else streamed."""
    lib = zstd_lib()
    src, n = _src(data)
    if size is None:
        size = lib.ZSTD_getFrameContentSize(src, n)
        if size == _ZSTD_UNKNOWN:
            return _zstd_stream(lib, src, n)
        if size == _ZSTD_ERROR:
            raise ValueError("zstd: not a zstd frame")
    out = np.empty(size, np.uint8)
    got = lib.ZSTD_decompress(out.ctypes.data, max(size, 1), src, n)
    if lib.ZSTD_isError(got):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(got).decode()}")
    if got != size:
        raise ValueError(f"zstd frame holds {got} bytes, expected {size}")
    return out


def _zstd_stream(lib, src, n: int) -> np.ndarray:
    """Frames of an unknown decompressed size, through a streaming context."""
    ds = lib.ZSTD_createDStream()
    lib.ZSTD_initDStream(ds)
    step, parts = lib.ZSTD_DStreamOutSize(), []
    inb = _Buffer(src, n, 0)
    try:
        while True:
            out = np.empty(step, np.uint8)
            outb = _Buffer(out.ctypes.data, step, 0)
            ret = lib.ZSTD_decompressStream(ds, ctypes.byref(outb), ctypes.byref(inb))
            if lib.ZSTD_isError(ret):
                raise ValueError(f"zstd: {lib.ZSTD_getErrorName(ret).decode()}")
            parts.append(out[:outb.pos])
            if inb.pos == n and (ret == 0 or outb.pos < step):
                if ret:
                    raise ValueError("zstd: truncated frame")
                return np.concatenate(parts)
    finally:
        lib.ZSTD_freeDStream(ds)


def zstd_compress(data, level: int = 1) -> np.ndarray:
    """One zstd frame of `data`, as a uint8 array (no copy out of the
    compressor's buffer)."""
    lib = zstd_lib()
    src, n = _src(data)
    out = np.empty(lib.ZSTD_compressBound(n), np.uint8)
    got = lib.ZSTD_compress(out.ctypes.data, out.nbytes, src, n, level)
    if lib.ZSTD_isError(got):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(got).decode()}")
    return out[:got]


# blosc v1 header flags and compressor codes (c-blosc's blosc.h)
_DOSHUFFLE, _MEMCPYED, _DOBITSHUFFLE, _DONT_SPLIT = 0x1, 0x2, 0x4, 0x10
_LZ4, _ZSTD = 1, 4
_MAX_SPLITS, _MIN_BUFFERSIZE = 16, 128


def _lz4_block(src: memoryview, size: int) -> np.ndarray:
    out = np.empty(size, np.uint8)
    raw = np.frombuffer(src, np.uint8)
    got = lz4_lib().LZ4_decompress_safe(raw.ctypes.data, out.ctypes.data, raw.nbytes, size)
    if got != size:
        raise ValueError(f"lz4: a blosc stream gave {got} bytes, expected {size}")
    return out


def _bitunshuffle(block: np.ndarray, typesize: int) -> None:
    """Undoes blosc's bit shuffle in place: the first n elements (n a
    multiple of 8) stored as one row of n bits per bit of each byte of the
    type, element i at bit i % 8 of byte i // 8 of its row; the rest as is."""
    n = len(block) // typesize // 8 * 8
    rows = block[:n * typesize].reshape(typesize, 8, n // 8)
    bits = np.unpackbits(rows, axis=-1, bitorder="little")  # (byte, bit, element)
    block[:n * typesize] = np.packbits(bits.transpose(2, 0, 1), axis=-1,
                                       bitorder="little").reshape(-1)


def blosc_decompress(data) -> np.ndarray:
    """The bytes (uint8 array) of a blosc v1 buffer (lz4 or zstd blocks;
    byte, bit or no shuffle)."""
    buf = memoryview(data)
    _, _, flags, typesize, nbytes, blocksize, cbytes = struct.unpack_from("<BBBBIII", buf, 0)
    if cbytes > len(buf):
        raise ValueError(f"blosc buffer of {len(buf)} bytes, its header says {cbytes}")
    if flags & _MEMCPYED:
        return np.frombuffer(buf[16:16 + nbytes], np.uint8).copy()
    code = flags >> 5
    if code not in (_LZ4, _ZSTD):
        raise NotImplementedError(f"blosc compressor code {code} is not supported (lz4: 1, "
                                  "zstd: 4)")
    nblocks = -(-nbytes // blocksize)
    starts = struct.unpack_from(f"<{nblocks}I", buf, 16)
    out = np.empty(nbytes, np.uint8)
    for i, start in enumerate(starts):
        bsize = min(blocksize, nbytes - i * blocksize)
        leftover = bsize < blocksize
        split = (not flags & _DONT_SPLIT and typesize <= _MAX_SPLITS
                 and blocksize // typesize >= _MIN_BUFFERSIZE and not leftover)
        nsplits = typesize if split else 1
        neblock = bsize // nsplits
        block, pos = np.empty(bsize, np.uint8), start
        for j in range(nsplits):
            csize = struct.unpack_from("<i", buf, pos)[0]
            pos += 4
            stream = buf[pos:pos + csize]
            if csize == neblock:  # stored uncompressed
                part = np.frombuffer(stream, np.uint8)
            elif code == _LZ4:
                part = _lz4_block(stream, neblock)
            else:
                part = zstd_decompress(stream, neblock)
            block[j * neblock:(j + 1) * neblock] = part
            pos += csize
        if flags & _DOSHUFFLE and typesize > 1:
            n = bsize // typesize
            block[:n * typesize] = block[:n * typesize].reshape(typesize, n).T.reshape(-1)
        elif flags & _DOBITSHUFFLE and bsize >= typesize:
            _bitunshuffle(block, typesize)
        out[i * blocksize:i * blocksize + bsize] = block
    return out


def parallel_map(fn, items, workers: int = 8) -> list:
    """[fn(x) for x in items] on a few threads: the codecs' calls release
    the GIL, so large chunks decompress and compress side by side."""
    items = list(items)
    if len(items) < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(min(workers, len(items))) as pool:
        return list(pool.map(fn, items))
