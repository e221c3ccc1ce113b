"""NHWC image tensor utilities (port of ``ops/image.py``), a PNG encoder
written with the standard library, so that writing an image needs no
Pillow, and the OpenAI-CLIP preprocessing of a PIL image (Pillow imported
inside the call only)."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def rescale(x, old_range, new_range, clamp: bool = False):
    """Affine range remap, optionally clamped — e.g. uint8 [0,255] ↔ [−1,1]."""
    old_min, old_max = old_range
    new_min, new_max = new_range
    x = (x - old_min) * ((new_max - new_min) / (old_max - old_min)) + new_min
    if clamp:
        x = torch.clamp(x, new_min, new_max)
    return x


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour ×2 upsample of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[−1, 1] float image -> uint8 [0, 255], rounded half to even."""
    x = rescale(x, (-1.0, 1.0), (0.0, 255.0), clamp=True)
    return torch.round(x).to(torch.uint8)


def image_grid(images, nrow: int) -> np.ndarray:
    """Tile (N, H, W, C) into a single (rows·H, nrow·W, C) grid (host numpy)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    nrows = (n + nrow - 1) // nrow
    grid = np.zeros((nrows * h, nrow * w, c), dtype=images.dtype)
    for idx in range(n):
        r, col = divmod(idx, nrow)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[idx]
    return grid


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image) -> bytes:
    """The bytes of an 8-bit RGB PNG of a uint8 (H, W, 3) array: one IDAT
    chunk, every row with filter type 0 (none), zlib level 6."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got "
                         f"{image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, image) -> None:
    """Writes :func:`encode_png` of ``image`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


# OpenAI-CLIP inference preprocessing constants (the pip `clip` package's
# `preprocess` transform the reference's stage-05 check relies on,
# 05_clip/01_check.py:10).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(pil_image, resolution: int = 224):
    """PIL image -> (1, R, R, 3) float32 numpy, CLIP-normalized.

    Bicubic resize of the short side to ``resolution``, center crop, then
    per-channel normalization: pip clip's Compose(Resize, CenterCrop,
    ToTensor, Normalize) inference transform. Pillow is imported here only:
    the card's machine does not promise it."""
    from PIL import Image

    img = pil_image.convert("RGB")
    w, h = img.size
    scale = resolution / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)),
                     Image.Resampling.BICUBIC)
    w, h = img.size
    left, top = (w - resolution) // 2, (h - resolution) // 2
    img = img.crop((left, top, left + resolution, top + resolution))
    x = np.asarray(img, dtype=np.float32) / 255.0
    x = (x - np.asarray(CLIP_IMAGE_MEAN)) / np.asarray(CLIP_IMAGE_STD)
    return x[None].astype(np.float32)
