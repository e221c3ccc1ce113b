"""Synthetic image data and a batch loader (port of ``io/data.py``).

:class:`SyntheticImageDataset` draws each item from its own numpy seed, as
the JAX class does, so both give the same images. :class:`DataLoader` has
the same order (``default_rng(seed + epoch)`` shuffle, remainder dropped)
and yields numpy (images NHWC float32, labels int32) batches; the decode
thread pool and prefetch queue of the JAX loader are left out, since the
synthetic items need no decoding.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticImageDataset:
    """Deterministic random images in [−1, 1] (no files needed)."""

    def __init__(self, n: int, img_size: int, channels: int = 3,
                 num_classes: int = 3, seed: int = 0):
        self.n = n
        self.img_size = img_size
        self.channels = channels
        self.num_classes = num_classes
        self.seed = seed
        self.class_names = [f"class_{i}" for i in range(num_classes)]

    def __len__(self):
        return self.n

    def load(self, idx: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        img = rng.uniform(-1, 1, (self.img_size, self.img_size,
                                  self.channels)).astype(np.float32)
        return img, int(idx % self.num_classes)


class DataLoader:
    """Shuffled fixed-shape batch iterator; each pass is the next epoch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return len(self.ds) // self.batch_size

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        for s in range(0, len(self) * self.batch_size, self.batch_size):
            items = [self.ds.load(i) for i in idx[s:s + self.batch_size]]
            yield (np.stack([im for im, _ in items]),
                   np.asarray([lb for _, lb in items], np.int32))
