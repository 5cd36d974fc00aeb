"""ctypes bindings of the native WordPiece tokenizer (``wordpiece.cpp``).

``load_native(vocab_path)`` builds the library at first use
(``native/build.py``) and returns a :class:`NativeWordPiece` whose
``encode(text)`` gives ``data/tokenizer.py``'s ``WordPieceTokenizer``
ids for the defaults (lower case, ``[UNK]``, ``##``), or None when
``OPENVISION_NO_NATIVE`` is set, the one way to the Python path. A build
failure or a vocab the library cannot load raises.

The one semantic difference from Python: ``str.lower``'s context-dependent
rule for the Greek capital sigma (at a word's end it becomes ``ς``) is
per character in the native table, so the caller routes texts holding
U+03A3 to the Python path; ids past ``_MAX_IDS`` come back as None and go
there too.
"""

from __future__ import annotations

import ctypes
import os
import threading

from openvision_tpu_torch.native import build

CONTEXT_SENSITIVE = "Σ"  # GREEK CAPITAL LETTER SIGMA
_MAX_IDS = 8192
_LIBS: dict = {}  # loaded libraries by path; a missing one is not remembered


def disabled() -> bool:
    return bool(os.environ.get("OPENVISION_NO_NATIVE"))


def _lib() -> ctypes.CDLL:
    path = str(build.library("wordpiece"))
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        lib.wp_load.restype = ctypes.c_void_p
        lib.wp_load.argtypes = [ctypes.c_char_p]
        lib.wp_free.argtypes = [ctypes.c_void_p]
        lib.wp_encode.restype = ctypes.c_int
        lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        _LIBS[path] = lib
    return lib


class NativeWordPiece:
    """One loaded vocab. ``encode`` may run on several threads at once (the
    daemon's request handlers): the C++ side only reads the vocab, and each
    thread writes the ids into a buffer of its own (ctypes lets go of the
    GIL during the call)."""

    def __init__(self, lib: ctypes.CDLL, handle: int):
        self._lib = lib
        self._h = ctypes.c_void_p(handle)
        self._local = threading.local()

    def encode(self, text: str) -> list[int] | None:
        """Token ids, or None when there are more than the native buffer
        holds: the caller then takes the Python path, so both paths give
        the same ids at any length."""
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = self._local.buf = (ctypes.c_int32 * _MAX_IDS)()
        n = self._lib.wp_encode(self._h, text.encode("utf-8"), buf, _MAX_IDS)
        if n > _MAX_IDS:
            return None
        return buf[:n]

    def __del__(self):
        try:
            self._lib.wp_free(self._h)
        except Exception:
            pass


def load_native(vocab_path: str) -> NativeWordPiece | None:
    if disabled():
        return None
    lib = _lib()
    handle = lib.wp_load(os.fsencode(vocab_path))
    if not handle:
        raise ValueError(f"the native WordPiece could not load the vocab {vocab_path!r} "
                         "(unreadable, or no [UNK] entry)")
    return NativeWordPiece(lib, handle)
