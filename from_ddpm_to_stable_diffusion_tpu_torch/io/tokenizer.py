"""CLIP BPE tokenizer (host side, pure Python; port of ``io/tokenizer.py``).

NFC normalise -> whitespace collapse -> lower -> chunking (the special
tokens and the contractions matched literally, runs of letters, single
numerics, runs of anything else that is not whitespace) -> byte-to-printable
remap -> greedy lowest-rank pair merging with an end-of-word marker ->
BOS / EOS and padding to 77.

The JAX module chunks with the third-party ``regex`` package
(``\\p{L}``, ``\\p{N}``). This one uses the standard library only: ``re`` for
the literal alternatives and for whitespace, and a scanner over
``unicodedata.category`` for the two classes (major category ``L`` and
``N``). The two agree on every code point that the interpreter's Unicode
database assigns; ``regex`` ships a newer database, so a character assigned
after this interpreter's Unicode version is a letter there and
"anything else" here. Whitespace is ``re``'s ``\\s`` without U+001C..U+001F,
which ``regex`` does not count as whitespace. U+0345 (a combining mark whose
case folding is the letter iota) matches no alternative of the JAX module's
case-insensitive pattern and is dropped there, so it is dropped here.

Vocabulary and merges are explicit constructor arguments;
:func:`build_simple_vocab` makes a small synthetic pair for tests and runs
without the 49408-entry file.
"""

from __future__ import annotations

import functools
import json
import re
import unicodedata
from typing import Dict, List, Tuple

# the literal alternatives of the JAX module's chunk pattern, in its order
_LITERALS = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d",
    re.IGNORECASE)
_SPACE = r"[^\S\x1c-\x1f]"
_SPACES = re.compile(_SPACE + "+")
_IS_SPACE = re.compile(_SPACE)


@functools.lru_cache(maxsize=None)
def _char_class(ch: str) -> str:
    """"L" (letter), "N" (numeric), "S" (skipped: whitespace and U+0345) or
    "O" (other)."""
    major = unicodedata.category(ch)[0]
    if major in ("L", "N"):
        return major
    return "S" if ch == "\u0345" or _IS_SPACE.match(ch) else "O"


def split_chunks(text: str) -> List[str]:
    """The chunks of the JAX module's pattern, left to right: at each
    position a literal alternative if one matches there, else a run of
    letters, one numeric, or a run of characters that are neither letters,
    numerics nor whitespace; whitespace is skipped."""
    chunks, i, n = [], 0, len(text)
    while i < n:
        literal = _LITERALS.match(text, i)
        if literal:
            chunks.append(literal.group(0))
            i = literal.end()
            continue
        kind = _char_class(text[i])
        j = i + 1
        if kind in ("L", "O"):
            while j < n and _char_class(text[j]) == kind:
                j += 1
        if kind != "S":
            chunks.append(text[i:j])
        i = j
    return chunks


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """Map every byte to a printable unicode char (the GPT-2 / CLIP
    convention): control and space bytes are displaced to 256+."""
    table = {}
    special = 0
    for byte in range(256):
        if unicodedata.category(chr(byte))[0] not in ("C", "Z"):
            table[byte] = chr(byte)
        else:
            table[byte] = chr(256 + special)
            special += 1
    return table


class CLIPTokenizer:
    """encode(text) -> 77 token ids with BOS / EOS / pad."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Dict[Tuple[str, str], int],
                 max_length: int = 77,
                 bos_token: str = "<|startoftext|>",
                 eos_token: str = "<|endoftext|>"):
        self.vocab = vocab
        self.merges = merges
        self.max_length = max_length
        self.bos_id = vocab[bos_token]
        self.eos_id = vocab[eos_token]
        self.pad_id = self.eos_id
        self._bytes = bytes_to_unicode()

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str,
                   **kwargs) -> "CLIPTokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().split("\n")[1:-1]  # strip header + trailing blank
        merges = {tuple(line.split()): rank for rank, line in enumerate(lines)}
        return cls(vocab, merges, **kwargs)

    def _bpe(self, chunk: str) -> Tuple[str, ...]:
        parts = list(chunk)
        if not parts:
            return ()
        parts[-1] += "</w>"
        while len(parts) > 1:
            ranks = [self.merges[p] for p in zip(parts, parts[1:])
                     if p in self.merges]
            if not ranks:
                break
            best = min(ranks)
            # merge every (non-overlapping, left-to-right) occurrence of the
            # lowest-rank pair in one pass: the CLIP BPE convention
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (i + 1 < len(parts)
                        and self.merges.get((parts[i], parts[i + 1])) == best):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return tuple(parts)

    @functools.lru_cache(maxsize=10000)
    def _bpe_cached(self, chunk: str) -> Tuple[str, ...]:
        return self._bpe(chunk)

    def encode_fragment(self, text: str) -> List[int]:
        """BPE ids for a prompt fragment, without BOS / EOS / pad (used by
        the prompt-weight segments, ``io/prompt_weights.py``)."""
        text = unicodedata.normalize("NFC", text)
        text = _SPACES.sub(" ", text).strip().lower()
        ids: List[int] = []
        for chunk in split_chunks(text):
            mapped = "".join(self._bytes[b] for b in chunk.encode("utf-8"))
            ids.extend(self.vocab[piece] for piece in self._bpe_cached(mapped))
        return ids

    def encode(self, text: str, pad: bool = True) -> List[int]:
        ids = [self.bos_id] + self.encode_fragment(text) + [self.eos_id]
        ids = ids[: self.max_length]
        if pad:
            ids += [self.pad_id] * (self.max_length - len(ids))
        return ids

    def encode_batch(self, texts: List[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    def tokenize_with_weights(self, text: str, parse_weights: bool = False):
        """(token, weight) pairs: every weight 1.0 by default; with
        ``parse_weights=True`` the ``(text:w)`` attention syntax gives real
        per-token weights (``io/prompt_weights.py``)."""
        if not parse_weights:
            return [(tok, 1.0) for tok in self.encode(text)]
        from .prompt_weights import encode_with_weights

        ids, weights = encode_with_weights(self, text)
        return list(zip(ids, weights))

    def decode(self, ids: List[int]) -> str:
        inv_vocab = {v: k for k, v in self.vocab.items()}
        inv_bytes = {c: b for b, c in self._bytes.items()}
        text = "".join(inv_vocab.get(i, "") for i in ids)
        text = (text.replace("<|startoftext|>", "")
                    .replace("<|endoftext|>", ""))
        words = []
        for piece in text.split("</w>"):
            raw = bytes(inv_bytes[c] for c in piece if c in inv_bytes)
            words.append(raw.decode("utf-8", errors="replace"))
        return " ".join(w for w in words if w).strip()


def build_simple_vocab(words: List[str]) -> Tuple[Dict[str, int],
                                                  Dict[Tuple[str, str], int]]:
    """Character-level vocab and greedy merges over the given words: a tiny
    stand-in for the 49408-entry CLIP vocab."""
    table = bytes_to_unicode()
    vocab: Dict[str, int] = {}
    merges: Dict[Tuple[str, str], int] = {}

    def add(tok):
        if tok not in vocab:
            vocab[tok] = len(vocab)

    add("<|startoftext|>")
    add("<|endoftext|>")
    for byte in range(256):
        add(table[byte])
        add(table[byte] + "</w>")
    # learn full-word merges left to right so known words encode to one token
    for word in words:
        mapped = "".join(table[b] for b in word.encode("utf-8"))
        parts = list(mapped)
        parts[-1] += "</w>"
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            if pair not in merges:
                merges[pair] = len(merges)
            parts = [parts[0] + parts[1]] + parts[2:]
            add(parts[0])
    return vocab, merges
