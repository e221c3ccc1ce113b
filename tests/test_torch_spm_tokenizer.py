"""The port's SentencePiece tokenizer and SD3 trio against the JAX package's.

Both packages keep their own copy of the pure-Python tokenizer; on the same
synthetic ``spiece.model`` (written by each package's ``build_spm_model``)
and the same synthetic CLIP vocabulary, every id must be identical: the
strings of ``tests/test_spm_tokenizer.py``, the T5 wrapper, the CLIP-L /
CLIP-G / T5 trio and its weighted form.
"""

import pytest

from from_ddpm_to_stable_diffusion_tpu.io import spm_tokenizer as jspm
from from_ddpm_to_stable_diffusion_tpu.io import tokenizer as jtok
from from_ddpm_to_stable_diffusion_tpu_torch.io import spm_tokenizer as tspm
from from_ddpm_to_stable_diffusion_tpu_torch.io import tokenizer as ttok

PIECES = [
    ("<pad>", 0.0, jspm.CONTROL), ("</s>", 0.0, jspm.CONTROL),
    ("<unk>", 0.0, jspm.UNKNOWN), ("▁", -3.0, jspm.NORMAL),
    ("▁a", -2.5, jspm.NORMAL), ("▁cat", -1.0, jspm.NORMAL),
    ("▁photo", -1.2, jspm.NORMAL), ("▁of", -1.1, jspm.NORMAL),
    ("▁ca", -4.0, jspm.NORMAL), ("t", -2.0, jspm.NORMAL),
    ("c", -5.0, jspm.NORMAL), ("a", -5.0, jspm.NORMAL),
    ("o", -5.0, jspm.NORMAL), ("f", -5.0, jspm.NORMAL),
    ("s", -3.5, jspm.NORMAL), ("▁cats", -2.2, jspm.NORMAL),
    ("▁<b>", -2.0, jspm.USER_DEFINED), ("<0x41>", -6.0, jspm.BYTE),
]
TEXTS = ["cat", "cats", "a photo of a cat", "cat zzz cat", "cat\t\n  cat",
         "", "<pad>", "a  photo\nof cats", "ｃａｔ", "a (photo:1.3) of a cat",
         "[cat] (a (photo)) of:0.5 cats"]
WORDS = ["a", "photo", "of", "cat", "cats", "1.3"]


@pytest.fixture(scope="module")
def pair():
    """(JAX trio, port trio) over one SentencePiece model file and one CLIP
    vocabulary, each read by its own package."""
    blob = jspm.build_spm_model(PIECES)
    assert tspm.build_spm_model(PIECES) == blob
    jvocab, jmerges = jtok.build_simple_vocab(WORDS)
    tvocab, tmerges = ttok.build_simple_vocab(WORDS)
    assert (jvocab, jmerges) == (tvocab, tmerges)
    j = jspm.SD3Tokenizer(jtok.CLIPTokenizer(jvocab, jmerges),
                          jspm.T5XXLTokenizer(jspm.SentencePieceUnigram(
                              jspm.parse_spm_model(blob))))
    t = tspm.SD3Tokenizer(ttok.CLIPTokenizer(tvocab, tmerges),
                          tspm.T5XXLTokenizer(tspm.SentencePieceUnigram(
                              tspm.parse_spm_model(blob))))
    return j, t


def test_proto_reader_and_piece_types_match_jax():
    blob = tspm.build_spm_model(PIECES)
    assert tspm.parse_spm_model(blob) == jspm.parse_spm_model(blob)
    assert ((tspm.NORMAL, tspm.UNKNOWN, tspm.CONTROL, tspm.USER_DEFINED,
             tspm.UNUSED, tspm.BYTE)
            == (jspm.NORMAL, jspm.UNKNOWN, jspm.CONTROL, jspm.USER_DEFINED,
                jspm.UNUSED, jspm.BYTE))


@pytest.mark.parametrize("text", TEXTS)
def test_sentencepiece_ids_match_jax(pair, text):
    j, t = pair
    assert t.t5.spm.encode(text) == j.t5.spm.encode(text)
    assert t.t5.spm.decode(t.t5.spm.encode(text)) == j.t5.spm.decode(
        j.t5.spm.encode(text))
    assert t.t5.encode(text) == j.t5.encode(text)
    assert t.t5.encode(text, pad=False) == j.t5.encode(text, pad=False)
    assert t.t5.tokenize_with_weights(text) == j.t5.tokenize_with_weights(
        text)


@pytest.mark.parametrize("text", TEXTS)
def test_sd3_trio_ids_match_jax(pair, text):
    j, t = pair
    got = t.encode(text)
    assert got == j.encode(text)
    assert len(got["l"]) == len(got["g"]) == len(got["t5xxl"]) == 77
    streams, weights = t.encode_with_weights(text)
    want_streams, want_weights = j.encode_with_weights(text)
    assert streams == want_streams and weights == want_weights


def test_unigram_without_dummy_prefix_matches_jax():
    pieces = [("<unk>", 0.0, jspm.UNKNOWN), ("ab", -1.0, jspm.NORMAL),
              ("a", -1.5, jspm.NORMAL), ("bc", -1.0, jspm.NORMAL),
              ("c", -10.0, jspm.NORMAL), ("b", -10.0, jspm.NORMAL)]
    for text in ("abc", "abcabc", "cab", "zabz"):
        assert (tspm.SentencePieceUnigram(pieces, False).encode(text)
                == jspm.SentencePieceUnigram(pieces, False).encode(text))
