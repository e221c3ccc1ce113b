"""NHWC image tensor utilities (port of ``ops/image.py``)."""

from __future__ import annotations

import torch


def rescale(x, old_range, new_range, clamp: bool = False):
    """Affine range remap, optionally clamped — e.g. uint8 [0,255] ↔ [−1,1]."""
    old_min, old_max = old_range
    new_min, new_max = new_range
    x = (x - old_min) * ((new_max - new_min) / (old_max - old_min)) + new_min
    if clamp:
        x = torch.clamp(x, new_min, new_max)
    return x


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour ×2 upsample of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[−1, 1] float image -> uint8 [0, 255], rounded half to even."""
    x = rescale(x, (-1.0, 1.0), (0.0, 255.0), clamp=True)
    return torch.round(x).to(torch.uint8)
