"""Build and bind the hand-written Hopper kernels in ``csrc/``.

The CUDA sources compile with nvcc into one shared library with a plain C
interface, loaded through ctypes. Nothing is built when this module is
imported: the first call to :func:`lib` builds into
``build/openvision_tpu_torch/<hash>/`` at the repository root (the hash
covers the sources and the flags, so an edited source rebuilds) and later
calls reuse it. Every C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; the wrappers in ``ops/fused_encoder.py``
raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("layernorm.cu", "gemm_bias_act.cu", "attention.cu")
HEADERS = ("common.cuh",)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "openvision_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libovt_kernels.so"

_lib = None


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else under /usr/local/cuda."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "need the CUDA toolkit to build")
    return path


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compiles the kernels unless this exact build exists; returns the .so.

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept in ``build.log`` beside the library.
    """
    out = build_dir()
    lib_path = out / LIB_NAME
    if lib_path.exists():
        return lib_path
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-6000:]}")
    os.replace(tmp, lib_path)  # atomic: a reader never sees a partial file
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        handle.ovt_layernorm.argtypes = [p, p, p, p, i, i, f, p]
        handle.ovt_gemm_bias_act.argtypes = [p, p, p, p, p, i, i, i, i, p]
        handle.ovt_attention.argtypes = [p, p, i, i, i, i, f, i, p]
        for fn in (handle.ovt_layernorm, handle.ovt_gemm_bias_act,
                   handle.ovt_attention):
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib
