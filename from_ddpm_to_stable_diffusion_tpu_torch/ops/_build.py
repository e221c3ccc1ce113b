"""Builds ``csrc/*.cu`` into one shared library with ``nvcc`` and loads it.

The library has a plain C interface (no PyTorch headers), so a build takes
seconds. It is built at first use into ``_build/`` inside this package,
under a name keyed on a hash of the sources and flags, and reused while
neither changes. Each C entry launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, lse, B, H, Lq, Lk, d, strides[12], scale, stream
    "fdsd_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _P],
    # q, k, v, dO, lse, delta, dq, B, H, Lq, Lk, d, strides[15], scale, stream
    "fdsd_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                          _F, _P],
    # q, k, v, dO, lse, delta, dk, dv, B, H, Lq, Lk, d, strides[18], scale,
    # stream
    "fdsd_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P, _F, _P],
    # x, scale, bias, y, part, stats, B, HW, C, G, eps, silu, is_bf16,
    # threads, rows_per_chunk, n_chunks, stream
    "fdsd_group_norm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                        _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the nvcc run, None if the cached .so was used
build_log = ""         # nvcc's output (-Xptxas -v: registers, spills, smem)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfdsd_kernels_{h.hexdigest()[:16]}.so"


def load():
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *map(str, _sources())]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{build_log}")
            os.replace(tmp, path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
