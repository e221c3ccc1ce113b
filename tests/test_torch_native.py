"""The port's ``io/native.py`` (the g++-built C++ tokenizer and safetensors
reader of ``native/*.cpp``) against the port's Python tokenizer and reader
and against the JAX package's ``io/native.py``, on a synthetic vocabulary
and on a file from the port's own safetensors writer: ids equal, tensors
bit for bit. The build goes into the port's ``_build/``, never to
``native/lib*.so``, which the JAX package caches."""

import json

import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.io import native as jnative
from from_ddpm_to_stable_diffusion_tpu_torch.io import native as tnative
from from_ddpm_to_stable_diffusion_tpu_torch.io import weights as tw
from from_ddpm_to_stable_diffusion_tpu_torch.io.tokenizer import (
    CLIPTokenizer, build_simple_vocab)
from from_ddpm_to_stable_diffusion_tpu_torch.ops._build import BUILD_DIR
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

TEXTS = ["hello world", "a photo of a cat", "  Hello   WORLD  ",
         "it's the cat!!", "cat123dog", "...", "hello, world: a photo; of it.",
         ""]


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab")
    vocab, merges = build_simple_vocab(
        ["hello", "world", "cat", "photo", "of", "a", "the", "it"])
    vpath, mpath = tmp / "vocab.json", tmp / "merges.txt"
    vpath.write_text(json.dumps(vocab, ensure_ascii=False))
    mpath.write_text("\n".join(["#version: 0.2"] + [
        f"{a} {b}" for (a, b), _ in sorted(merges.items(),
                                           key=lambda kv: kv[1])]) + "\n")
    return str(vpath), str(mpath)


@pytest.mark.parametrize("name", ["bpe_tokenizer", "safetensors_reader"])
def test_build_goes_to_the_ports_build_dir(name):
    lib = tnative.build_native(name)
    assert lib.startswith(str(BUILD_DIR)) and lib.endswith(".so")
    assert str(tnative.NATIVE_DIR) not in lib
    assert tnative.build_native(name) == lib          # reused


def test_tokenizer_ids_match_python_and_jax(vocab_files):
    vpath, mpath = vocab_files
    port = tnative.NativeBPETokenizer(vpath, mpath)
    python = CLIPTokenizer.from_files(vpath, mpath)
    jax_native = jnative.NativeBPETokenizer(vpath, mpath)
    assert port.vocab_size == len(python.vocab) == jax_native.vocab_size
    for text in TEXTS:
        assert port.encode(text) == python.encode(text) == jax_native.encode(
            text), text
    got = port.encode_batch_np(TEXTS)
    assert got.dtype == np.int64 and got.shape == (len(TEXTS), 77)
    np.testing.assert_array_equal(got, np.asarray(python.encode_batch(TEXTS)))
    with pytest.raises(ValueError, match="failed to load"):
        tnative.NativeBPETokenizer("/nonexistent/v.json", "/nonexistent/m")


@pytest.fixture
def st_file(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=gen),
        "f16": torch.randn(7, generator=gen).half(),
        "bf16": torch.randn(2, 3, 4, generator=gen).bfloat16(),
        "f64": torch.randn(2, generator=gen).double(),
        "i64": torch.arange(6).reshape(2, 3),
        "i32": torch.arange(5, dtype=torch.int32),
        "i8": torch.arange(-3, 3, dtype=torch.int8),
        "u8": torch.arange(9, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
        "pre.w": torch.ones(2, 2),
    }
    path = str(tmp_path / "t.safetensors")
    tw.save_safetensors_dict(tensors, path, metadata={"format": "pt"})
    return path, tensors


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    bits = lambda t: t.reshape(-1).view(torch.uint8)    # NaN-proof
    assert torch.equal(bits(a), bits(b))


def test_reader_bit_for_bit_against_the_python_reader(st_file):
    path, tensors = st_file
    want = tw.load_safetensors_python(path)
    with tnative.NativeSafetensors(path) as f:
        assert sorted(f.keys()) == sorted(want) == sorted(tensors)
        copies = {k: f.get_tensor(k) for k in f.keys()}
        views = {k: f.get_tensor(k, copy=False) for k in f.keys()}
    for k, w in want.items():
        _equal(copies[k], w)
        _equal(views[k], w)            # the mapping outlives the reader
        _equal(w, tensors[k])


def test_native_views_are_copy_on_write(st_file):
    """A write to a view lands in a private copy of its page, as with the
    Python reader's copy-on-write map: the file and a fresh read are
    unchanged."""
    path, tensors = st_file
    got = tw.load_safetensors_dict(path)
    got["f32"].add_(1.0)
    got["i64"].zero_()
    assert torch.equal(got["f32"], tensors["f32"] + 1.0)
    again = tw.load_safetensors_dict(path)
    _equal(again["f32"], tensors["f32"])
    _equal(again["i64"], tensors["i64"])
    _equal(tw.load_safetensors_python(path)["f32"], tensors["f32"])


def test_load_safetensors_dict_reads_through_the_native_reader(
        st_file, monkeypatch):
    path, tensors = st_file
    opened = []

    class Counting(tnative.NativeSafetensors):
        def __init__(self, p):
            opened.append(p)
            super().__init__(p)

    monkeypatch.setattr(tnative, "NativeSafetensors", Counting)
    got = tw.load_safetensors_dict(path, prefix="pre.")
    assert opened == [path] and list(got) == ["w"]
    _equal(got["w"], tensors["pre.w"])
    monkeypatch.setenv("FDSD_ST_READER", "python")
    got = tw.load_safetensors_dict(path)
    assert opened == [path]                         # the Python reader
    for k, t in tensors.items():
        _equal(got[k], t)
