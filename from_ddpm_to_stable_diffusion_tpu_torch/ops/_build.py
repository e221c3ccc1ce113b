"""Builds ``csrc/*.cu`` into one shared library with ``nvcc`` and loads it.

The library has a plain C interface (no PyTorch headers), so a build takes
seconds: one ``nvcc -c`` per source, all started together, then one link.
It is built at first use into ``_build/`` inside this package, under a name
keyed on a hash of the sources, headers and flags, and reused while none of
them changes. Each C entry launches on the stream it is given and
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # The flash kernels' mask arguments (csrc/mask.cuh), null when absent:
    # bias, q_ids, kv_ids, q_bounds, kv_bounds, lo, hi; then, after the
    # scale, the flags causal and bias_bf16.
    # q, k, v, out, lse, masks[7], B, H, Lq, Lk, d, strides[12 + 4], scale,
    # causal, bias_bf16, stream
    "fdsd_flash_fwd": [_P] * 5 + [_P] * 7 + [_I] * 5 + [_P, _F, _I, _I, _P],
    # q, k, v, dO, lse, delta, dq, dbias, masks[7], B, H, Lq, Lk, d,
    # strides[15 + 4], scale, causal, bias_bf16, stream
    "fdsd_flash_bwd_dq": [_P] * 8 + [_P] * 7 + [_I] * 5 + [_P, _F, _I, _I,
                                                            _P],
    # q, k, v, dO, lse, delta, dk, dv, masks[7], B, H, Lq, Lk, d,
    # strides[18 + 4], scale, causal, bias_bf16, stream
    "fdsd_flash_bwd_dkv": [_P] * 8 + [_P] * 7 + [_I] * 5 + [_P, _F, _I, _I,
                                                             _P],
    # q, k, v, out, lse, q_off, k_off, B, H, Lq, Lk, d, strides[12], scale,
    # seg_q, seg_k, valid_len, has_valid, causal, bounded, stream
    "fdsd_flash_fwd_pos": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                           _F, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, dO, lse, delta, dq, q_off, k_off, B, H, Lq, Lk, d, strides[15],
    # scale, seg_q, seg_k, valid_len, has_valid, causal, stream
    "fdsd_flash_bwd_pos_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _P, _F, _I, _I, _I, _I, _I, _P],
    # q, k, v, dO, lse, delta, dk, dv, q_off, k_off, B, H, Lq, Lk, d,
    # strides[18], scale, seg_q, seg_k, valid_len, has_valid, causal, stream
    "fdsd_flash_bwd_pos_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _P, _F, _I, _I, _I, _I, _I, _P],
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
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfdsd_kernels_{h.hexdigest()[:16]}.so"


def _compile(path: Path) -> str:
    """Every source to an object file in parallel, then one link; returns
    nvcc's output. The temporary files carry the process id, so two
    processes that build at once do not write into each other's files."""
    nvcc, tag = _nvcc(), f"{path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objects)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outputs = [proc.communicate()[0] for proc in procs]
        cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objects)])
        failed = [i for i, proc in enumerate(procs) if proc.returncode]
        if not failed:
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            outputs.append(link.stdout + link.stderr)
            failed = [len(procs)] if link.returncode else []
        log = "".join(outputs)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                " ".join(cmds[i]) for i in failed) + "\n" + log)
        os.replace(tmp, path)
    finally:
        for f in (*objects, tmp):
            f.unlink(missing_ok=True)
    return log


def load():
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            build_log = _compile(path)
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
