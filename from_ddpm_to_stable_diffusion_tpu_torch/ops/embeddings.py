"""Sinusoidal time and position embeddings (port of ``ops/embeddings.py``)."""

from __future__ import annotations

import numpy as np
import torch

# Built on the host in float64 and cast once: an fp32 pow's relative error
# would be amplified by t≈1000 inside cos/sin.
_SD1_FREQS = np.power(10000.0, -np.arange(0, 160, dtype=np.float64) / 160.0)


def sd1_time_embedding(timestep):
    """SD1 UNet time feature: (B,) or scalar -> (B, 320) fp32 [cos | sin]."""
    t = torch.as_tensor(timestep, dtype=torch.float32).reshape(-1)
    freqs = torch.as_tensor(_SD1_FREQS, dtype=torch.float32, device=t.device)
    x = t[:, None] * freqs[None]
    return torch.cat([torch.cos(x), torch.sin(x)], dim=-1)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """DiT-style sinusoidal embedding: (B,) -> (B, dim) fp32 [cos | sin],
    freqs exp(−ln(max_period)·i/half) for i < half; odd dims zero-padded."""
    half = dim // 2
    t = torch.as_tensor(t).to(torch.float32).reshape(-1)
    freqs = torch.as_tensor(
        np.exp(-np.log(max_period) * np.arange(0, half, dtype=np.float64)
               / half), dtype=torch.float32, device=t.device)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def pos_embed_2d_sincos(embed_dim: int, grid_h: int, grid_w: int,
                        scale: float = 1.0) -> np.ndarray:
    """Fixed 2-D sincos position table, (grid_h*grid_w, embed_dim) host
    numpy: half the channels encode y, half x, each [sin | cos] over
    omega = 1/10000^(i/(d/4))."""
    if embed_dim % 4:
        raise ValueError("2-D sincos needs embed_dim % 4 == 0")

    def _1d(dim, pos):
        omega = 1.0 / 10000.0 ** (np.arange(dim // 2, dtype=np.float64)
                                  / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    yy, xx = np.meshgrid(np.arange(grid_h, dtype=np.float64) / scale,
                         np.arange(grid_w, dtype=np.float64) / scale,
                         indexing="ij")
    return np.concatenate([_1d(embed_dim // 2, yy), _1d(embed_dim // 2, xx)],
                          axis=1).astype(np.float32)


def crop_pos_embed(pos_embed, grid_size: int, target_h: int, target_w: int):
    """Centre-crop a (1, grid_size², D) learned position grid to
    (1, target_h·target_w, D)."""
    d = pos_embed.shape[-1]
    top = (grid_size - target_h) // 2
    left = (grid_size - target_w) // 2
    crop = pos_embed.reshape(grid_size, grid_size, d)[
        top:top + target_h, left:left + target_w]
    return crop.reshape(1, target_h * target_w, d)
