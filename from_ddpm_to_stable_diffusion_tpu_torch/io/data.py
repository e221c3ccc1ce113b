"""Image data and a batch loader (port of ``io/data.py``).

:class:`SyntheticImageDataset` and :class:`SyntheticVideoDataset` draw each
item from its own numpy seed, as the JAX classes do, so both give the same
images and clips. :class:`ImageFolderDataset`
reads ``root/<class>/*.png`` (Pillow, imported inside ``load``: nothing else
of the port needs it) and normalizes with the ImageNet statistics, or to
[−1, 1]. :class:`DataLoader` has the same order (``default_rng(seed +
epoch)`` shuffle, remainder dropped) and yields numpy (images NHWC float32,
labels int32) batches; the decode thread pool and prefetch queue of the JAX
loader are left out. :func:`prefetch_to_device` stages the next batches on
the card while the current step runs.
"""

from __future__ import annotations

import collections
import os
from typing import Iterator

import numpy as np
import torch

IMAGENET_MEANS = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STDS = np.asarray([0.229, 0.224, 0.225], np.float32)

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def denormalize(x):
    """Invert the ImageNet normalization of NHWC arrays."""
    return x * IMAGENET_STDS + IMAGENET_MEANS


class ImageFolderDataset:
    """`root/<class_name>/*.jpg` → (image HWC float32 normalized, label int)."""

    def __init__(self, root: str, img_size: int,
                 normalize: bool = True, to_unit_range: bool = False):
        self.root = root
        self.img_size = img_size
        self.normalize = normalize
        self.to_unit_range = to_unit_range  # [-1, 1] instead of ImageNet norm
        self.class_names = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.samples: list[tuple[str, int]] = []
        for label, cls in enumerate(self.class_names):
            cdir = os.path.join(root, cls)
            for fn in sorted(os.listdir(cdir)):
                if os.path.splitext(fn)[1].lower() in _IMG_EXTS:
                    self.samples.append((os.path.join(cdir, fn), label))
        if not self.samples:
            raise ValueError(f"no images found under {root}")

    def __len__(self):
        return len(self.samples)

    def load(self, idx: int):
        from PIL import Image

        path, label = self.samples[idx]
        with Image.open(path) as im:
            im = im.convert("RGB").resize((self.img_size, self.img_size),
                                          Image.BILINEAR)
            arr = np.asarray(im, np.float32) / 255.0
        if self.to_unit_range:
            arr = arr * 2.0 - 1.0
        elif self.normalize:
            arr = (arr - IMAGENET_MEANS) / IMAGENET_STDS
        return arr, label


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


class SyntheticVideoDataset:
    """Deterministic moving-square clips: each item is a (T, S, S, 3) clip in
    [−1, 1] whose square moves right, down or diagonally by its class label
    (0, 1, 2), so only the frames' order tells the classes apart."""

    def __init__(self, n: int, img_size: int, frames: int = 8,
                 num_classes: int = 3, seed: int = 0):
        self.n = n
        self.img_size = img_size
        self.frames = frames
        self.num_classes = num_classes
        self.seed = seed
        self.class_names = ["right", "down", "diag"][:num_classes]

    def __len__(self):
        return self.n

    def load(self, idx: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        label = int(idx % self.num_classes)
        s = self.img_size
        sq = max(2, s // 4)
        hi = max(1, s - sq - self.frames)  # the whole motion stays in frame
        x0 = int(rng.integers(0, hi))
        y0 = int(rng.integers(0, hi))
        dx, dy = [(1, 0), (0, 1), (1, 1)][label]
        color = rng.uniform(0.5, 1.0, (3,)).astype(np.float32)
        clip = np.full((self.frames, s, s, 3), -1.0, np.float32)
        for f in range(self.frames):
            xx, yy = x0 + f * dx, y0 + f * dy
            clip[f, yy:yy + sq, xx:xx + sq] = color
        return clip, label


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


def _on_card(batch, device):
    """A batch (tuple of arrays, tensors or None) copied to ``device`` from
    pinned host memory, asynchronously on the current stream."""
    def put(a):
        if a is None or (isinstance(a, torch.Tensor) and a.device == device):
            return a
        return torch.as_tensor(a).pin_memory().to(device, non_blocking=True)

    return tuple(put(a) for a in batch)


def prefetch_to_device(iterator, device=None, size: int = 2, *, mesh=None):
    """Yields the batches of ``iterator`` staged ``size`` ahead on
    ``device``: on the card each batch goes to pinned memory and is copied
    on a side stream, the consuming stream waits on the copy's event, and
    each tensor is recorded on that stream so its memory outlives the copy's
    stream. On the CPU (or with no device) the batches pass through.
    ``mesh`` (the JAX ``prefetch_to_device(iterator, mesh)``): each batch
    placed by ``parallel.shard_batch``, batch dim over the mesh's ``data``
    axis (a process-group rank keeps its slice), on the mesh's device."""
    if mesh is not None:
        from ..parallel.mesh import mesh_device, shard_batch

        device = mesh_device(mesh)
        iterator = (tuple(shard_batch(mesh, tuple(batch)))
                    for batch in iterator)
    if device is None or torch.device(device).type != "cuda":
        yield from iterator
        return
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device)
    buf = collections.deque()
    it = iter(iterator)

    def stage():
        batch = next(it)
        with torch.cuda.stream(side):
            out = _on_card(batch, device)
            done = torch.cuda.Event()
            done.record(side)
        buf.append((out, done))

    try:
        for _ in range(size):
            stage()
    except StopIteration:
        pass
    while buf:
        out, done = buf.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for a in out:
            if isinstance(a, torch.Tensor):
                a.record_stream(consumer)
        yield out
        try:
            stage()
        except StopIteration:
            continue
