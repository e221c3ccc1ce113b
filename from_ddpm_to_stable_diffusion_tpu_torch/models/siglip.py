"""SigLIP vision tower (port of ``models/siglip.py``).

Conv patchify (VALID, stride = patch), a learned per-patch position table
sized by the input (no class token), pre-LN transformer layers with a
gelu-tanh MLP, final LN. Returns the full patch-token sequence (B, N, D).
Submodules and parameters are named after the Flax parameter paths. With a
``compute_dtype`` the parameters stay as stored and the patch conv, every
linear and the residual stream run in that dtype (Flax's ``dtype=``); the
norms keep fp32 statistics. On the card a tower over at least 512 patches
(384² images at patch 16: 576) runs its attention in the flash kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, Linear, SelfAttention


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 16
    layer_norm_eps: float = 1e-6


class SiglipEncoderLayer(nn.Module):
    def __init__(self, config: SiglipVisionConfig,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, dt = config.hidden_size, compute_dtype
        self.ln1 = LayerNorm(d, eps=config.layer_norm_eps)
        self.attn = SelfAttention(d, config.num_attention_heads,
                                  qkv_bias=True, compute_dtype=dt)
        self.ln2 = LayerNorm(d, eps=config.layer_norm_eps)
        self.fc1 = Linear(d, config.intermediate_size, compute_dtype=dt)
        self.fc2 = Linear(config.intermediate_size, d, compute_dtype=dt)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class SiglipVisionModel(nn.Module):
    """x (B, H, W, C) -> patch states (B, N, hidden). ``image_size`` sizes
    the position table (default: the config's); the input must give that
    many patches."""

    def __init__(self, config: SiglipVisionConfig = SiglipVisionConfig(),
                 image_size: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        p = config.patch_size
        n = ((image_size or config.image_size) // p) ** 2
        self.patch_embedding = Conv2d(config.num_channels, config.hidden_size,
                                      p, stride=p, compute_dtype=compute_dtype)
        self.position_embedding = nn.Parameter(
            torch.zeros(n, config.hidden_size))
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer{i}",
                            SiglipEncoderLayer(config, compute_dtype))
        self.post_ln = LayerNorm(config.hidden_size,
                                 eps=config.layer_norm_eps)

    def forward(self, x):
        h = self.patch_embedding(x)
        h = h.reshape(h.shape[0], -1, self.config.hidden_size)
        if h.shape[1] != self.position_embedding.shape[0]:
            raise ValueError(
                f"{h.shape[1]} patches for a position table of "
                f"{self.position_embedding.shape[0]}")
        h = h + self.position_embedding.to(h.dtype)
        for i in range(self.config.num_hidden_layers):
            h = getattr(self, f"layer{i}")(h)
        return self.post_ln(h)
