"""ctypes bindings of the repository's C++ host components (port of
``io/native.py``): the CLIP BPE tokenizer and the safetensors reader of
``native/*.cpp``.

:func:`build_native` compiles ``native/<name>.cpp`` with ``g++`` at first
use into this package's ``_build/`` (the directory of the CUDA libraries,
``ops/_build.py``), under a name keyed on a hash of the source and the
flags, written to a process-unique temporary name and renamed into place,
so that concurrent builds never load a partial library. It never writes
``native/lib*.so``, which the JAX package builds and caches there.

:class:`NativeBPETokenizer` has the encode API of
``io/tokenizer.py::CLIPTokenizer``. :class:`NativeSafetensors` maps a
.safetensors file in C++ and hands out its tensors as ``torch`` tensors:
copies, or views of the mapping that keep it open while any of them lives
(``io/weights.py::load_safetensors_dict`` reads through it). The C++
reader maps the file private and read-only; its data pages are made
writable copy-on-write (``mprotect``), so a view takes a write as a view of
the Python reader's copy-on-write map does, and the file never changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
from pathlib import Path
from typing import List

import numpy as np
import torch

from ..ops._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def build_native(name: str = "bpe_tokenizer", force: bool = False) -> str:
    """``native/<name>.cpp`` compiled into ``_build/lib<name>-<hash>.so``
    (reused while the source and flags are unchanged); returns its path."""
    src = NATIVE_DIR / f"{name}.cpp"
    key = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()
                         ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{key}.so"
    if force or not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, lib)
        finally:
            tmp.unlink(missing_ok=True)
    return str(lib)


def _bind(lib, signatures) -> None:
    for name, restype, argtypes in signatures:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


class NativeBPETokenizer:
    """The CLIP BPE tokenizer of ``native/bpe_tokenizer.cpp``: ids padded to
    ``max_length`` as ``CLIPTokenizer`` gives them."""

    def __init__(self, vocab_path: str, merges_path: str,
                 max_length: int = 77):
        self._lib = ctypes.CDLL(build_native("bpe_tokenizer"))
        _bind(self._lib, [
            ("bpe_create", ctypes.c_void_p,
             [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
            ("bpe_encode", ctypes.c_int,
             [ctypes.c_void_p, ctypes.c_char_p,
              ctypes.POINTER(ctypes.c_int64)]),
            ("bpe_destroy", None, [ctypes.c_void_p]),
            ("bpe_vocab_size", ctypes.c_int64, [ctypes.c_void_p])])
        self._handle = self._lib.bpe_create(
            vocab_path.encode(), merges_path.encode(), max_length)
        if not self._handle:
            raise ValueError(
                f"failed to load vocab/merges from {vocab_path!r}, "
                f"{merges_path!r}")
        self.max_length = max_length

    @property
    def vocab_size(self) -> int:
        return int(self._lib.bpe_vocab_size(self._handle))

    def encode(self, text: str) -> List[int]:
        buf = (ctypes.c_int64 * self.max_length)()
        if self._lib.bpe_encode(self._handle, text.encode("utf-8"), buf) < 0:
            raise ValueError(f"unknown token while encoding {text!r}")
        return list(buf)

    def encode_batch(self, texts: List[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    def encode_batch_np(self, texts: List[str]) -> np.ndarray:
        return np.asarray(self.encode_batch(texts), np.int64)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.bpe_destroy(handle)
            self._handle = None


_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def _copy_on_write(lo: int, hi: int) -> None:
    """Makes the pages of [lo, hi) of a private file mapping writable: a
    write then lands in a private copy of its page."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    start = lo - lo % mmap.PAGESIZE
    if libc.mprotect(start, hi - start, mmap.PROT_READ | mmap.PROT_WRITE):
        err = ctypes.get_errno()
        raise OSError(err, f"mprotect of the mapped tensors: "
                           f"{os.strerror(err)}")


class _Mapping:
    """The C++ reader's handle of one mapped file, unmapped when the last
    object that refers to it (the reader, a view) is gone."""

    def __init__(self, lib, handle):
        self.lib, self.handle = lib, handle

    def close(self):
        if self.handle:
            self.lib.st_close(self.handle)
            self.handle = None

    def __del__(self):
        self.close()


class NativeSafetensors:
    """A .safetensors file mapped by ``native/safetensors_reader.cpp``, with
    the API of ``safetensors.safe_open`` that the readers use (``keys``,
    ``get_tensor``). ``get_tensor(name)`` returns an owning copy;
    ``copy=False`` a view of the mapping, which stays mapped while the view
    lives (a write goes to a private copy of its page). A dtype the port
    does not know raises ``ValueError``, as a file the reader cannot parse
    does; a mapping that cannot be made copy-on-write raises ``OSError``."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(build_native("safetensors_reader"))
        _bind(lib, [
            ("st_open", ctypes.c_void_p, [ctypes.c_char_p]),
            ("st_error", ctypes.c_char_p, [ctypes.c_void_p]),
            ("st_count", ctypes.c_int64, [ctypes.c_void_p]),
            ("st_name", ctypes.c_char_p, [ctypes.c_void_p, ctypes.c_int64]),
            ("st_dtype", ctypes.c_char_p, [ctypes.c_void_p, ctypes.c_int64]),
            ("st_ndim", ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64]),
            ("st_shape", None, [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64)]),
            ("st_nbytes", ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64]),
            ("st_data", ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_int64]),
            ("st_close", None, [ctypes.c_void_p])])
        self._lib = lib
        self._map = _Mapping(lib, lib.st_open(path.encode()))
        err = lib.st_error(self._map.handle)
        if err:
            self.close()
            raise ValueError(f"safetensors read failed for {path!r}: "
                             f"{err.decode()}")
        self._index = {lib.st_name(self._map.handle, i).decode(): i
                       for i in range(lib.st_count(self._map.handle))}
        spans = [(lib.st_data(self._map.handle, i),
                  lib.st_nbytes(self._map.handle, i))
                 for i in self._index.values()]
        spans = [(p, p + n) for p, n in spans if n]
        if spans:
            _copy_on_write(min(lo for lo, _ in spans),
                           max(hi for _, hi in spans))

    def keys(self):
        return list(self._index)

    def get_tensor(self, name: str, copy: bool = True) -> torch.Tensor:
        lib, h, i = self._lib, self._map.handle, self._index[name]
        st_dtype = lib.st_dtype(h, i).decode()
        dtype = _ST_DTYPES.get(st_dtype)
        if dtype is None:
            raise ValueError(f"{name}: unsupported safetensors dtype "
                             f"{st_dtype!r}")
        ndim = lib.st_ndim(h, i)
        shape = (ctypes.c_int64 * max(ndim, 1))()
        lib.st_shape(h, i, shape)
        nbytes = lib.st_nbytes(h, i)
        if not nbytes:
            return torch.empty(tuple(shape[:ndim]), dtype=dtype)
        ptr = lib.st_data(h, i)
        buf = (ctypes.c_char * nbytes).from_address(ptr)
        buf.mapping = self._map          # the view keeps the file mapped
        raw = torch.frombuffer(buf, dtype=torch.uint8)
        if copy or ptr % dtype.itemsize:
            raw = raw.clone()
        return raw.view(dtype).reshape(tuple(shape[:ndim]))

    def close(self):
        """Drops this reader's hold on the mapping: the file is unmapped
        once no view of it is left."""
        self._map = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
