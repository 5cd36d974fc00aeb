"""Builds the native host libraries with g++ at first use.

``library(name)`` returns the path of ``lib<name>.so`` (``wordpiece`` or
``indexer``), compiling ``<name>.cpp`` with ``g++ -O2 -std=c++17 -fPIC
-shared`` into ``build/openvision_tpu_torch/<hash>/`` at the repository root
(beside the CUDA library of ``ops/kernels.py``) unless that exact build is
there. The hash covers the source, the flags and, for the tokenizer, the
interpreter's Unicode version: ``unicode_tables.h`` is generated into the
same directory from this interpreter's ``unicodedata`` (``gen_tables.py``),
so the native and the Python tokenizers make the same character decisions.

Nothing is cached between calls but the hash: a library that is missing
(never built, or its directory deleted) is built again at the next call. A
failed build raises with the compiler's output. Each build writes to a temp
name of its own and renames it into place, so concurrent builds (threads,
input workers) never see a partial file.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import threading
import unicodedata
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "openvision_tpu_torch"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
SOURCES = {"wordpiece": "wordpiece.cpp", "indexer": "indexer.cpp"}

_lock = threading.Lock()


def cxx() -> str:
    """The host C++ compiler: $CXX, else g++ on PATH."""
    path = os.environ.get("CXX") or shutil.which("g++")
    if not path:
        raise RuntimeError("g++ not found on PATH (or $CXX): the native tokenizer and shard "
                           "indexer build with the host C++ compiler; set "
                           "OPENVISION_NO_NATIVE=1 for the Python paths")
    return path


@functools.lru_cache(maxsize=None)
def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((HERE / SOURCES[name]).read_bytes())
    if name == "wordpiece":
        h.update((HERE / "gen_tables.py").read_bytes())
        h.update(unicodedata.unidata_version.encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def _lib_path(root: Path, name: str) -> tuple[Path, str]:
    lib_path = root / f"native-{_digest(name)}" / f"lib{name}.so"
    return lib_path, str(lib_path)


def library(name: str) -> Path:
    """Path of lib<name>.so, built first if it is not there (a stat a call:
    the shard indexer asks once per shard)."""
    lib_path, text = _lib_path(BUILD_ROOT, name)
    if os.path.exists(text):
        return lib_path
    with _lock:
        if not lib_path.exists():
            _build(name, lib_path.parent, lib_path)
    return lib_path


def _build(name: str, out: Path, lib_path: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    if name == "wordpiece" and not (out / "unicode_tables.h").exists():
        from openvision_tpu_torch.native import gen_tables

        tables = out / f"unicode_tables.h.{tag}.tmp"
        gen_tables.main(str(tables))
        os.replace(tables, out / "unicode_tables.h")
    tmp = out / f"lib{name}.so.{tag}.tmp"
    cmd = [cxx(), *CXX_FLAGS, "-I", str(out), "-o", str(tmp), str(HERE / SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out / f"{name}.build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on native/{SOURCES[name]} (exit {proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-6000:]}")
    os.replace(tmp, lib_path)  # atomic: a reader never sees a partial file
