"""Build and bind the hand-written Hopper kernels in ``csrc/``.

The CUDA sources compile with nvcc (one process per source, in parallel)
into one shared library with a plain C interface, loaded through ctypes.
Nothing is built when this module is imported: the first call to
:func:`lib` builds into ``build/openvision_tpu_torch/<hash>/`` at the
repository root (the hash covers the sources and the flags, so an edited
source rebuilds) and later calls reuse it. Every C entry point launches on
the stream it is given and returns ``cudaGetLastError()``; the wrappers
(``ops/fused_encoder.py``, ``ops/fused_encoder_int8.py``,
``ops/flash_attention.py``, ``ops/grad_kernels.py``) raise when it is not 0.

The wrappers share :data:`LAUNCHES` (one count per wrapper, raised by
:func:`count` right after its kernel launched) and the operand checks below:
a wrapper takes its plain version only when every tensor lies on the CPU,
and for CUDA tensors launches its kernel or raises. A kernel with a backward kernel runs inside a
``torch.autograd.Function`` (``ops/flash_attention.py``,
``ops/fused_attention.py``); the grad check below guards the ones without.

The serving daemon calls the kernels from several dispatcher threads at
once: the first build and load run under one lock (a second thread waits
for the first one's library), each build writes to a temp name of its own,
and :func:`count` raises a count under a lock, so the counts stay exact.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("layernorm.cu", "gemm_bias_act.cu", "attention.cu", "attention_bwd.cu", "gemm_grad.cu",
           "gemm_int8.cu")
HEADERS = ("common.cuh", "hopper.cuh", "attention.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "openvision_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libovt_kernels.so"

_lib = None
_lib_lock = threading.Lock()  # one build and load, whichever thread comes first
_count_lock = threading.Lock()

# Launches of each kernel; a wrapper adds one right after its kernel launched.
LAUNCHES = {"layernorm": 0, "gemm_bias_act": 0, "attention": 0, "flash_attention": 0,
            "attention_bwd_dq": 0, "attention_bwd_dkv": 0, "gemm_nn": 0, "gemm_tn": 0,
            "layernorm_bwd": 0, "colsum": 0, "gemm_int8": 0, "layernorm_quant": 0,
            "quant_rows": 0, "mlp_bwd_dual": 0}


def count(name: str) -> None:
    """Adds one launch of `name` (atomic across threads)."""
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def on_cpu(*tensors) -> bool:
    """True if every tensor is on the CPU, False if every one is on CUDA."""
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"}:
        raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {devices}")
    return False


def check_operand(name: str, t, dtype, shape=None, contiguous: bool = True) -> None:
    """Raises unless `t` is what a kernel takes: `dtype`, `shape`, 16-byte
    aligned, contiguous (or, with contiguous=False, unit stride in the last
    dim and every other stride a multiple of 8 elements), and not a tensor
    that autograd would need a backward for (a kernel wrapper has none of
    its own: the sub-blocks that have a backward kernel run inside an
    autograd Function, where grad mode is off)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if not contiguous and (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])):
        raise ValueError(
            f"{name}: the kernel takes unit stride in the last dim and other strides "
            f"that are multiples of 8 elements, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes 16-byte aligned tensors")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{name}: this wrapper has no backward kernel of its own; train through the "
            "sub-blocks (fused_encoder.mhsa_block / mlp_block, fused_attention."
            "fused_mhsa_block / fused_qkv_attention) or run under torch.inference_mode()")


def stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


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

    One nvcc per source, all started together, then one link. The
    compiler's output (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept in ``build.log`` beside the library.
    """
    out = build_dir()
    lib_path = out / LIB_NAME
    if lib_path.exists():
        return lib_path
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = out / f"{LIB_NAME}.{tag}.tmp"
    objs = [out / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(obj),
                               str(CSRC / s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [s for s, proc in zip(SOURCES, procs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("the link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(logs)
    (out / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log[-6000:]}")
    os.replace(tmp, lib_path)  # atomic: a reader never sees a partial file
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (once across threads)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _bind(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Sets each entry point's argument and return types."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.POINTER(ctypes.c_longlong)
    argtypes = {
        "ovt_layernorm": [p, p, p, p, i, i, f, p],
        "ovt_gemm_bias_act": [p, p, p, p, p, i, i, i, i, p],
        "ovt_attention": [p, p, i, i, i, i, f, i, i, i, i, p],
        "ovt_flash_attention": [p, p, p, p, p, ll, i, i, i, i, i, f, i, i, i, i, p],
        "ovt_attention_bwd_dq": [p, p, p, p, p, p, p, p, ll, i, i, i, i, i, f, i, i, i, p],
        "ovt_attention_bwd_dkv": [p, p, p, p, p, p, p, p, ll, i, i, i, i, i, f, i, i, i, p],
        "ovt_gemm_grad": [p, p, p, p, i, i, i, i, i, i, i, i, p],
        "ovt_mlp_bwd_dual": [p, p, p, p, p, p, p, p, i, i, i, p],
        "ovt_layernorm_bwd": [p, p, p, p, p, p, p, i, i, f, i, p],
        "ovt_layernorm_bwd_blocks": [i, i],
        "ovt_colsum": [p, i, p, p, i, i, i, i, p],
        "ovt_gemm_int8": [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p],
        "ovt_layernorm_quant": [p, p, p, p, p, i, i, f, p],
        "ovt_quant_rows": [p, p, p, p, i, i, p],
    }
    for name, types in argtypes.items():
        fn = getattr(handle, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return handle
