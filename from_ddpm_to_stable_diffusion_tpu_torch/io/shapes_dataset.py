"""Synthetic geometric-shapes datasets (own copy of the JAX package's
``io/shapes_dataset.py``, numpy only: the same index and seed give the same
bytes).

The AFHQ data the reference trains on does not ship with this repo; this
deterministic generator gives the trainers a real learnable distribution —
class 0: filled circles, 1: squares, 2: triangles, each with random size,
position and color on a dark background — so class-conditional DDPM training
can be validated end-to-end (distinct classes must emerge in CFG samples).
"""

from __future__ import annotations

import numpy as np


class ShapesDataset:
    def __init__(self, n: int, img_size: int = 64, num_classes: int = 3,
                 seed: int = 0):
        self.n = n
        self.img_size = img_size
        self.num_classes = num_classes
        self.seed = seed
        self.class_names = ["circle", "square", "triangle"][:num_classes]

    def __len__(self):
        return self.n

    def load(self, idx: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        s = self.img_size
        label = idx % self.num_classes
        img = np.full((s, s, 3), -0.9, np.float32)
        color = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        cx, cy = rng.uniform(0.3, 0.7, 2) * s
        r = rng.uniform(0.15, 0.3) * s
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        if label == 0:      # circle
            mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        elif label == 1:    # axis-aligned square
            mask = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
        else:               # upward triangle
            mask = ((yy <= cy + r)
                    & (yy >= cy - r)
                    & (np.abs(xx - cx) <= (yy - (cy - r)) / 2.0))
        img[mask] = color * 2.0 - 1.0  # shape in [-1, 1] color space
        return img, label


# --------------------------------------------------------------------------
# Captioned variant — the stage-07⁺ multimodal training distribution
# --------------------------------------------------------------------------
VLM_VOCAB = ["<pad>", "<bos>", "<eos>", "a", "small", "big",
             "red", "green", "blue", "circle", "square", "triangle",
             "what", "color", "shape", "size", "?", "describe", "it", "."]
VLM_PAD, VLM_BOS, VLM_EOS = 0, 1, 2
# every question is exactly 3 words, so with [BOS, q1, q2, q3, ...] the
# answer always starts at token index 4 — a STATIC loss/decode boundary
VQA_ANSWER_START = 4

_PALETTE = {"red": (0.9, 0.15, 0.1), "green": (0.1, 0.85, 0.2),
            "blue": (0.15, 0.25, 0.95)}


class CaptionedShapesDataset:
    """(image, caption token ids): 'a {small|big} {color} {shape}'.

    Same deterministic generator idea as :class:`ShapesDataset`, but color
    comes from a 3-word palette and size from a threshold, so every factor
    in the caption is visually grounded — a vision-language model must read
    the IMAGE to caption correctly (class-id shortcuts don't exist:
    color/size are independent of the shape class).
    """

    def __init__(self, n: int, img_size: int = 64, seed: int = 0,
                 max_len: int = 8):
        self.n = n
        self.img_size = img_size
        self.seed = seed
        self.max_len = max_len
        self.vocab = list(VLM_VOCAB)
        self.word_to_id = {w: i for i, w in enumerate(self.vocab)}

    def __len__(self):
        return self.n

    def caption_words(self, size_word, color, shape):
        return ["a", size_word, color, shape]

    def encode(self, words):
        ids = [VLM_BOS] + [self.word_to_id[w] for w in words] + [VLM_EOS]
        ids += [VLM_PAD] * (self.max_len - len(ids))
        return np.asarray(ids[: self.max_len], np.int32)

    def decode(self, ids):
        out = []
        for i in np.asarray(ids).tolist():
            if i == VLM_EOS:
                break
            if i not in (VLM_PAD, VLM_BOS):
                out.append(self.vocab[i])
        return " ".join(out)

    def load(self, idx: int):
        rng = np.random.default_rng(self.seed * 2_000_003 + idx)
        s = self.img_size
        shape = ["circle", "square", "triangle"][idx % 3]
        color = ["red", "green", "blue"][rng.integers(3)]
        r = rng.uniform(0.12, 0.34) * s
        size_word = "big" if r >= 0.23 * s else "small"
        cx, cy = rng.uniform(0.35, 0.65, 2) * s
        img = np.full((s, s, 3), -0.9, np.float32)
        rgb = np.asarray(_PALETTE[color], np.float32)
        rgb = rgb * rng.uniform(0.8, 1.0)  # brightness jitter within name
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        if shape == "circle":
            mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        elif shape == "square":
            mask = (np.abs(xx - cx) <= r) & (np.abs(yy - cy) <= r)
        else:
            mask = ((yy <= cy + r) & (yy >= cy - r)
                    & (np.abs(xx - cx) <= (yy - (cy - r)) / 2.0))
        img[mask] = rgb * 2.0 - 1.0
        return img, self.encode(self.caption_words(size_word, color, shape))


VQA_QUESTIONS = {
    "describe it .": lambda s, c, sh: ["a", s, c, sh],
    "what color ?": lambda s, c, sh: [c],
    "what shape ?": lambda s, c, sh: [sh],
    "what size ?": lambda s, c, sh: [s],
}


class VQAShapesDataset(CaptionedShapesDataset):
    """(image, [BOS | 3-word question | answer | EOS]) — the stage-07
    image+question→answer capability (MiniCPM-V chat parity), grounded:
    the answer depends on pixels AND which question was asked.  Loss and
    decoding split at the static ``VQA_ANSWER_START`` boundary."""

    def __init__(self, n: int, img_size: int = 64, seed: int = 0,
                 max_len: int = 10):
        super().__init__(n, img_size, seed, max_len)
        self.questions = list(VQA_QUESTIONS)

    def caption_words(self, size_word, color, shape):
        # idx-dependent question is chosen in encode_qa via load()
        return ["a", size_word, color, shape]

    def load(self, idx: int):
        img, _ = super().load(idx)
        # recover the attributes deterministically (same rng stream)
        rng = np.random.default_rng(self.seed * 2_000_003 + idx)
        shape = ["circle", "square", "triangle"][idx % 3]
        color = ["red", "green", "blue"][rng.integers(3)]
        r = rng.uniform(0.12, 0.34) * self.img_size
        size_word = "big" if r >= 0.23 * self.img_size else "small"
        question = self.questions[(idx // 3) % len(self.questions)]
        answer = VQA_QUESTIONS[question](size_word, color, shape)
        ids = ([VLM_BOS] + [self.word_to_id[w] for w in question.split()]
               + [self.word_to_id[w] for w in answer] + [VLM_EOS])
        ids += [VLM_PAD] * (self.max_len - len(ids))
        return img, np.asarray(ids[: self.max_len], np.int32)

    def encode_question(self, question: str):
        return np.asarray(
            [VLM_BOS] + [self.word_to_id[w] for w in question.split()],
            np.int32)

    def decode_answer(self, ids):
        out = []
        for i in np.asarray(ids).tolist()[VQA_ANSWER_START:]:
            if i == VLM_EOS:
                break
            if i != VLM_PAD:
                out.append(self.vocab[i])
        return " ".join(out)
