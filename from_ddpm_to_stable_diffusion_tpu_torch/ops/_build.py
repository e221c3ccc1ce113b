"""Builds the CUDA sources into two shared libraries with ``nvcc`` and loads
them: ``csrc/*.cu`` (the bf16 flash kernels and GroupNorm) and
``csrc/fp32/*.cu`` (the fp32 forms of the flash kernels, which include
``csrc/sm90.cuh`` and ``csrc/pos_tile.cuh``), each at its own first use, so
that a bf16 caller never waits for the fp32 build. The bf16 flash kernels
K1, K3 and K4 keep their templates in a header each
(``flash_attention{,_dq,_bwd}_sm90.cuh``; K3 and K4 above head dim 256
``flash_attention_wide_bwd_sm90.cuh``), as do the fp32 K1 above head
dim 160 (``fp32/flash_f32_fwd_wide.cuh``) and K3 and K4 above 128
(``fp32/flash_f32_bwd.cuh``; above 256 ``fp32/flash_f32_bwd_stream.cuh``),
and instantiate their head-dim widths in
several small sources (``*_w*.cu``), so that the instantiations compile in
parallel.

A library has a plain C interface (no PyTorch headers), so a build takes
seconds: one ``nvcc -c`` per source, all started together, then one link.
It is built into ``_build/`` inside this package, under a name keyed on a
hash of its sources, the headers and the flags, and reused while none of
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
    # q, k, v, out, lse, work, masks[7], B, H, Lq, Lk, d, strides[12 + 4],
    # scale, causal, bias_bf16, splits, stream: K1 above head dim 256
    "fdsd_flash_fwd_d512": [_P] * 6 + [_P] * 7 + [_I] * 5 + [_P, _F, _I, _I,
                                                              _I, _P],
    # q, k, v, dO, lse, delta, dq, dbias, masks[7], B, H, Lq, Lk, d,
    # strides[15 + 4], scale, causal, bias_bf16, stream
    "fdsd_flash_bwd_dq": [_P] * 8 + [_P] * 7 + [_I] * 5 + [_P, _F, _I, _I,
                                                            _P],
    # q, k, v, dO, lse, delta, dk, dv, masks[7], B, H, Lq, Lk, d,
    # strides[18 + 4], scale, causal, bias_bf16, stream
    "fdsd_flash_bwd_dkv": [_P] * 8 + [_P] * 7 + [_I] * 5 + [_P, _F, _I, _I,
                                                             _P],
    # q, k, v, out, lse, q_off, k_off, work, B, H, Lq, Lk, d, strides[12],
    # scale, seg_q, seg_k, valid_len, has_valid, causal, bounded, splits,
    # stream (work and splits: the key splits above head dim 256)
    "fdsd_flash_fwd_pos": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _P, _F, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, dO, lse, delta, dq, q_off, k_off, B, H, Lq, Lk, d, strides[15],
    # scale, seg_q, seg_k, valid_len, has_valid, causal, stream
    "fdsd_flash_bwd_pos_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _P, _F, _I, _I, _I, _I, _I, _P],
    # q, k, v, dO, lse, delta, dk, dv, q_off, k_off, B, H, Lq, Lk, d,
    # strides[18], scale, seg_q, seg_k, valid_len, has_valid, causal, stream
    "fdsd_flash_bwd_pos_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _P, _F, _I, _I, _I, _I, _I, _P],
    # x, scale, bias, y, part, plan (int32[13]), eps, silu, stream
    "fdsd_group_norm": [_P] * 6 + [_F, _I, _P],
    # is_bf16, threads, smem: K2's blocks per SM
    "fdsd_group_norm_blocks_per_sm": [_I, _I, _I],
}
_SIGNATURES_FP32 = {
    # q, k, v, out, lse, work, masks[7], B, H, Lq, Lk, d, strides[12 + 4],
    # scale, causal, splits, stream
    "fdsd_flash_fwd_f32": [_P] * 6 + [_P] * 7 + [_I] * 5 + [_P, _F, _I, _I,
                                                             _P],
    # the arguments of fdsd_flash_fwd_pos: the workspace after k_off, the
    # key splits (read above head dim 256) before the stream
    "fdsd_flash_fwd_pos_f32": _SIGNATURES["fdsd_flash_fwd_pos"],
    # q, k, v, dO, lse, delta, dq, dbias, work, masks[7], B, H, Lq, Lk, d,
    # strides[15 + 4], scale, causal, stream
    "fdsd_flash_bwd_dq_f32": [_P] * 9 + [_P] * 7 + [_I] * 5 + [_P, _F, _I,
                                                                _P],
    # q, k, v, dO, lse, delta, dk, dv, work, masks[7], B, H, Lq, Lk, d,
    # strides[18 + 4], scale, causal, stream
    "fdsd_flash_bwd_dkv_f32": [_P] * 9 + [_P] * 7 + [_I] * 5 + [_P, _F, _I,
                                                                 _P],
    # the position-masked backward entries take the arguments of their bf16
    # namesakes with the workspace after the offsets
    "fdsd_flash_bwd_pos_dq_f32": (_SIGNATURES["fdsd_flash_bwd_pos_dq"][:9]
                                  + [_P]
                                  + _SIGNATURES["fdsd_flash_bwd_pos_dq"][9:]),
    "fdsd_flash_bwd_pos_dkv_f32": (
        _SIGNATURES["fdsd_flash_bwd_pos_dkv"][:10] + [_P]
        + _SIGNATURES["fdsd_flash_bwd_pos_dkv"][10:]),
}
# library name -> (its sources' directory, its entries)
_LIBRARIES = {"kernels": (CSRC, _SIGNATURES),
              "kernels_fp32": (CSRC / "fp32", _SIGNATURES_FP32)}

# one lock a library: two threads may build the two libraries at once
_locks = {name: threading.Lock() for name in _LIBRARIES}
_libs = {}
# library name -> (wall time of its nvcc run, None if the cached .so was
# used; nvcc's output: registers, spills and shared memory from -Xptxas -v)
builds = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources(name: str = "kernels"):
    return sorted(_LIBRARIES[name][0].glob("*.cu"))


def library_path(name: str = "kernels") -> Path:
    """Where library ``name`` is built: keyed on its sources, its own headers
    and those of ``csrc/`` (the fp32 sources include them)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = {*CSRC.glob("*.cuh"), *_LIBRARIES[name][0].glob("*.cuh")}
    for src in _sources(name) + sorted(headers):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfdsd_{name}_{h.hexdigest()[:16]}.so"


def _compile(path: Path, sources) -> str:
    """Every source to an object file in parallel, then one link; returns
    nvcc's output. The temporary files carry the process id, so two
    processes that build at once do not write into each other's files."""
    nvcc, tag = _nvcc(), f"{path.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objects)]
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


def load(name: str = "kernels"):
    """Library ``name`` loaded, built first if needed: "kernels" (bf16 flash
    kernels, GroupNorm) or "kernels_fp32" (the fp32 flash kernels)."""
    with _locks[name]:
        if name in _libs:
            return _libs[name]
        path = library_path(name)
        seconds, log = None, ""
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            log = _compile(path, _sources(name))
            seconds = time.perf_counter() - t0
        builds[name] = (seconds, log)
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in _LIBRARIES[name][1].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
