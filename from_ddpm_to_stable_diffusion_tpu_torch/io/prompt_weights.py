"""Prompt attention-weight syntax: ``(text)``, ``[text]``, ``(text:1.3)``
(port of ``io/prompt_weights.py``; the parser and the encoders are the JAX
module's pure-Python code, :func:`apply_token_weights` works on tensors).

- ``(text)``   boosts attention by x1.1 (nesting multiplies),
- ``[text]``   dampens by /1.1,
- ``(text:w)`` sets an explicit weight ``w``,
- ``\\(`` ``\\)`` ``\\[`` ``\\]`` ``\\\\`` escape the literal characters.

Unbalanced brackets degrade gracefully (the open bracket is dropped, its
content keeps weight 1.0), so plain prompts round-trip unchanged.

Weights are applied to the frozen text-encoder output by scaling each
token's embedding and restoring the un-weighted per-prompt mean, which
keeps the overall activation statistics the denoiser was trained on.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import torch

_ROUND = 1.1
_SQUARE = 1.0 / 1.1

_TOKEN_RE = re.compile(
    r"\\\(|\\\)|\\\[|\\\]|\\\\"     # escaped specials
    r"|\(|\["                        # open brackets
    r"|:\s*([+-]?[\d.]+)\s*\)"       # ":1.3)" explicit-weight close
    r"|\)|\]"                        # plain closes
    r"|[^\\()\[\]:]+"                # literal run
    r"|:"                            # lone colon
)


def parse_weighted_segments(text: str) -> List[Tuple[str, float]]:
    """Parse attention syntax into [(fragment, weight), ...].

    Adjacent fragments with equal weight are merged; the concatenation of
    fragments is the prompt with the syntax characters removed.
    """
    segments: List[List] = []      # [text, weight]
    round_stack: List[int] = []    # index into segments where '(' opened
    square_stack: List[int] = []

    def scale(start: int, mult: float):
        for seg in segments[start:]:
            seg[1] *= mult

    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        explicit = m.group(1)
        if tok.startswith("\\"):
            segments.append([tok[1:], 1.0])
        elif tok == "(":
            round_stack.append(len(segments))
        elif tok == "[":
            square_stack.append(len(segments))
        elif explicit is not None:
            if round_stack:
                scale(round_stack.pop(), float(explicit))
            else:  # stray ":w)" with no open paren — keep it literal
                segments.append([tok, 1.0])
        elif tok == ")":
            if round_stack:
                scale(round_stack.pop(), _ROUND)
            else:
                segments.append([tok, 1.0])
        elif tok == "]":
            if square_stack:
                scale(square_stack.pop(), _SQUARE)
            else:
                segments.append([tok, 1.0])
        else:
            segments.append([tok, 1.0])
    # unbalanced opens: contents keep their (already applied) weights

    merged: List[Tuple[str, float]] = []
    for txt, w in segments:
        if merged and merged[-1][1] == w:
            merged[-1] = (merged[-1][0] + txt, w)
        elif txt:
            merged.append((txt, w))
    return merged or [("", 1.0)]


def encode_with_weights(tokenizer, text: str,
                        parse_weights: bool = True):
    """Encode ``text`` → (ids, weights), both length ``max_length``.

    BOS/EOS/pad carry weight 1.0. Requires the tokenizer to expose
    ``encode_fragment`` (ids without specials/padding).
    """
    ids: List[int] = [tokenizer.bos_id]
    weights: List[float] = [1.0]
    segments = (parse_weighted_segments(text) if parse_weights
                else [(text, 1.0)])
    for fragment, w in segments:
        frag_ids = tokenizer.encode_fragment(fragment)
        ids.extend(frag_ids)
        weights.extend([w] * len(frag_ids))
    ids.append(tokenizer.eos_id)
    weights.append(1.0)
    n = tokenizer.max_length
    ids, weights = ids[:n], weights[:n]
    pad = n - len(ids)
    ids += [tokenizer.pad_id] * pad
    weights += [1.0] * pad
    return ids, weights


def apply_token_weights(embeddings: torch.Tensor, weights) -> torch.Tensor:
    """Scale token embeddings by per-token weights, preserving the
    per-prompt mean activation.

    embeddings: (B, L, C); weights: (B, L) or a sequence convertible to it.
    The arithmetic is fp32; weight 1.0 everywhere is exactly the identity.
    """
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=embeddings.device)
    z = embeddings.float()
    zw = z * w[:, :, None]
    mean_before = z.mean(dim=(1, 2), keepdim=True)
    mean_after = zw.mean(dim=(1, 2), keepdim=True)
    safe = torch.where(mean_after == 0.0, torch.ones_like(mean_after),
                       mean_after)
    zw = zw * (mean_before / safe)
    return zw.to(embeddings.dtype)


def batch_encode_with_weights(tokenizer, texts: Sequence[str],
                              parse_weights: bool = True):
    """Batch version → (ids (B, L) list, weights (B, L) list)."""
    pairs = [encode_with_weights(tokenizer, t, parse_weights) for t in texts]
    return [p[0] for p in pairs], [p[1] for p in pairs]
