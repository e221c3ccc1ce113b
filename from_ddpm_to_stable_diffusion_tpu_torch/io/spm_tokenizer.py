"""From-scratch SentencePiece unigram tokenizer (host-side, pure Python;
the port's own copy of the JAX package's ``io/spm_tokenizer.py``).

The reference wraps HuggingFace's ``T5TokenizerFast``
(/root/reference/02_stable_diffusion-3/utils.py:329-342) around Google's
`spiece.model` file. This module re-implements the two pieces that wrapper
delegates to, with zero dependencies:

- ``parse_spm_model``: a minimal protobuf wire-format reader for the
  SentencePiece ``ModelProto`` (field 1 = repeated ``SentencePiece {piece:1,
  score:2, type:3}``) — enough to load any real `spiece.model`.
- ``SentencePieceUnigram``: the unigram-LM encoder — NFKC normalize,
  whitespace collapse, ``▁`` word-boundary marker with dummy prefix, then
  Viterbi segmentation maximizing the summed piece log-probs, with the
  standard unknown-character penalty (min_score − 10) and adjacent-unknown
  merging.

Not reproduced: SentencePiece's precompiled_charsmap normalization (a DoubleArray
trie of NFKC extensions). Plain NFKC covers the cases that matter for prompts;
exotic codepoints may normalize differently from the C++ library.

``T5XXLTokenizer`` then mirrors the reference ``SDTokenizer`` semantics for
T5 (utils.py:186-226,329-342): no start token, ``</s>``=1 appended, pad=0,
padded to a 77-token minimum, and the per-word tokenize fan-out (split on
whitespace, encode each word separately, strip the per-word EOS).
"""

from __future__ import annotations

import functools
import struct
import unicodedata
from typing import Dict, List, Sequence, Tuple

# SentencePiece piece types (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_SPACE = "▁"  # ▁ — the SentencePiece word-boundary marker


# --------------------------------------------------------------------------
# Minimal protobuf wire-format reader for ModelProto
# --------------------------------------------------------------------------
def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:        # varint
        _, pos = _read_varint(data, pos)
    elif wire_type == 1:      # 64-bit
        pos += 8
    elif wire_type == 2:      # length-delimited
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire_type == 5:      # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    return pos


def _parse_sentence_piece(data: bytes) -> Tuple[str, float, int]:
    """One ``SentencePiece`` sub-message: piece(1)=string, score(2)=float,
    type(3)=enum (default NORMAL)."""
    piece, score, ptype = "", 0.0, NORMAL
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 2:
            n, pos = _read_varint(data, pos)
            piece = data[pos:pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:
            score = struct.unpack("<f", data[pos:pos + 4])[0]
            pos += 4
        elif field == 3 and wire == 0:
            ptype, pos = _read_varint(data, pos)
        else:
            pos = _skip_field(data, pos, wire)
    return piece, score, ptype


def parse_spm_model(data: bytes) -> List[Tuple[str, float, int]]:
    """Read a serialized SentencePiece ``ModelProto`` → ordered (piece,
    score, type) list; list index is the token id."""
    pieces: List[Tuple[str, float, int]] = []
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 2:  # repeated SentencePiece pieces
            n, pos = _read_varint(data, pos)
            pieces.append(_parse_sentence_piece(data[pos:pos + n]))
            pos += n
        else:
            pos = _skip_field(data, pos, wire)
    return pieces


def _encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        out.append(b | (0x80 if value else 0))
        if not value:
            return bytes(out)


def build_spm_model(pieces: Sequence[Tuple[str, float, int]]) -> bytes:
    """Serialize (piece, score, type) tuples into ModelProto bytes — the
    write-side inverse of ``parse_spm_model`` (used to synthesize test
    vocabularies; real use reads Google-trained `spiece.model` files)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        sub = bytearray()
        raw = piece.encode("utf-8")
        sub += b"\x0a" + _encode_varint(len(raw)) + raw       # piece=1
        sub += b"\x15" + struct.pack("<f", score)              # score=2
        if ptype != NORMAL:
            sub += b"\x18" + _encode_varint(ptype)             # type=3
        out += b"\x0a" + _encode_varint(len(sub)) + bytes(sub)
    return bytes(out)


# --------------------------------------------------------------------------
# Unigram-LM Viterbi encoder
# --------------------------------------------------------------------------
class SentencePieceUnigram:
    """encode(text) -> token ids via max-likelihood unigram segmentation."""

    def __init__(self, pieces: Sequence[Tuple[str, float, int]],
                 add_dummy_prefix: bool = True):
        self.pieces = list(pieces)
        self.add_dummy_prefix = add_dummy_prefix
        self.vocab: Dict[str, int] = {}
        self.scores: List[float] = []
        self.unk_id = 0
        matchable_scores = []
        for idx, (piece, score, ptype) in enumerate(self.pieces):
            self.scores.append(score)
            if ptype == UNKNOWN:
                self.unk_id = idx
            elif ptype in (NORMAL, USER_DEFINED, BYTE):
                self.vocab[piece] = idx
                matchable_scores.append(score)
        self.max_piece_len = max((len(p) for p in self.vocab), default=1)
        min_score = min(matchable_scores, default=0.0)
        self.unk_penalty = min_score - 10.0  # sentencepiece convention

    @classmethod
    def from_file(cls, path: str, **kwargs) -> "SentencePieceUnigram":
        with open(path, "rb") as f:
            return cls(parse_spm_model(f.read()), **kwargs)

    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", _SPACE)

    @functools.lru_cache(maxsize=10000)
    def _viterbi(self, s: str) -> Tuple[int, ...]:
        """Best-scoring segmentation of the normalized string ``s``."""
        n = len(s)
        best = [float("-inf")] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)  # (start, id)
        best[0] = 0.0
        for end in range(1, n + 1):
            lo = max(0, end - self.max_piece_len)
            for start in range(lo, end):
                if best[start] == float("-inf"):
                    continue
                tok = self.vocab.get(s[start:end])
                if tok is not None:
                    cand = best[start] + self.scores[tok]
                    if cand > best[end]:
                        best[end] = cand
                        back[end] = (start, tok)
            # unknown fallback: single character as <unk>
            if best[end - 1] != float("-inf"):
                cand = best[end - 1] + self.unk_penalty
                if cand > best[end]:
                    best[end] = cand
                    back[end] = (end - 1, self.unk_id)
        ids: List[int] = []
        pos = n
        while pos > 0:
            start, tok = back[pos]
            ids.append(tok)
            pos = start
        ids.reverse()
        # merge runs of adjacent unknowns into one <unk> (spm behavior)
        merged: List[int] = []
        for tok in ids:
            if tok == self.unk_id and merged and merged[-1] == self.unk_id:
                continue
            merged.append(tok)
        return tuple(merged)

    def encode(self, text: str) -> List[int]:
        s = self.normalize(text)
        return list(self._viterbi(s)) if s else []

    def decode(self, ids: Sequence[int]) -> str:
        chunks = []
        for i in ids:
            piece, _, ptype = self.pieces[i]
            if ptype in (CONTROL,):
                continue
            chunks.append("⁇" if ptype == UNKNOWN else piece)
        return "".join(chunks).replace(_SPACE, " ").strip()


# --------------------------------------------------------------------------
# T5 wrapper with the reference SDTokenizer surface
# --------------------------------------------------------------------------
class T5XXLTokenizer:
    """T5 prompt tokenizer for SD3: ids = Σ encode(word) + [</s>=1],
    zero-padded to ≥77 (utils.py:209-226,334-342; no start token, no
    max-length truncation in the reference — here capped at ``max_length``
    so downstream shapes stay static)."""

    END_ID = 1
    PAD_ID = 0

    def __init__(self, spm: SentencePieceUnigram, min_length: int = 77,
                 max_length: int = 77):
        self.spm = spm
        self.min_length = min_length
        self.max_length = max_length

    @classmethod
    def from_file(cls, path: str, **kwargs) -> "T5XXLTokenizer":
        return cls(SentencePieceUnigram.from_file(path), **kwargs)

    def encode(self, text: str, pad: bool = True) -> List[int]:
        ids: List[int] = []
        for word in text.replace("\n", " ").split(" "):
            if word:
                ids.extend(self.spm.encode(word))
        ids.append(self.END_ID)
        ids = ids[: self.max_length]
        if pad and len(ids) < self.min_length:
            ids += [self.PAD_ID] * (self.min_length - len(ids))
        return ids

    def tokenize_with_weights(self, text: str):
        return [(tok, 1.0) for tok in self.encode(text)]


class SD3Tokenizer:
    """One prompt → the three token streams SD3 conditions on
    (utils.py:234-246): CLIP-L (BOS/EOS, padded with EOS=49407), CLIP-G
    (same ids, padded with 0), T5 (</s>-terminated, padded with 0)."""

    def __init__(self, clip_tokenizer, t5_tokenizer: T5XXLTokenizer):
        self.clip = clip_tokenizer
        self.t5 = t5_tokenizer

    def encode(self, text: str) -> Dict[str, List[int]]:
        core = self.clip.encode(text, pad=False)[: self.clip.max_length]
        n_pad = self.clip.max_length - len(core)
        return {
            "l": core + [self.clip.eos_id] * n_pad,
            "g": core + [0] * n_pad,
            "t5xxl": self.t5.encode(text),
        }

    def encode_with_weights(self, text: str):
        """(streams, clip_weights): the ``(text:w)`` attention syntax
        (io/prompt_weights.py) parsed once — CLIP-L/G share one weights
        row (same core ids); T5 tokenizes the STRIPPED text and stays
        unweighted (its hidden states carry no per-token weight in the
        reference conditioning; weights act on the CLIP hidden states).
        Beyond-reference: the reference stubs all weights to 1.0
        (utils.py:206-226)."""
        from .prompt_weights import parse_weighted_segments

        segs = parse_weighted_segments(text)
        core: List[int] = []
        wts: List[float] = []
        for frag, w in segs:
            fids = self.clip.encode_fragment(frag)
            core.extend(fids)
            wts.extend([w] * len(fids))
        keep = self.clip.max_length - 2
        core, wts = core[:keep], wts[:keep]
        ids = [self.clip.bos_id] + core + [self.clip.eos_id]
        wts = [1.0] + wts + [1.0]
        n_pad = self.clip.max_length - len(ids)
        streams = {
            "l": ids + [self.clip.eos_id] * n_pad,
            "g": ids + [0] * n_pad,
            "t5xxl": self.t5.encode("".join(f for f, _ in segs)),
        }
        return streams, wts + [1.0] * n_pad
