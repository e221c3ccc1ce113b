"""Sinusoidal time embeddings (port of ``ops/embeddings.py``)."""

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
