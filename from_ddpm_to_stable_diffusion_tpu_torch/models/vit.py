"""Vision Transformer classifier of stage 04 (port of ``models/vit.py``).

Conv patchify (a p × p stride-p 'VALID' conv), a class token, learned
positions, pre-LN blocks (fused-QKV attention with biases, a tanh-GELU MLP,
dropout after the attention, the GELU and the MLP), a final LayerNorm on
the class token and a linear head in fp32. NHWC input; submodules and
parameters are named after the Flax paths (``patch_embed``, ``cls_token``,
``pos_embed``, ``block3.attn.qkv``, ``ln_final``, ``head``). ``dtype`` is
the compute dtype of the patchify, the blocks' linears and the token stream
over fp32 parameters.

At the stage-04 operating point (128², patch 32) the blocks attend over 17
tokens, below the flash kernels' 512, so the attention is plain on every
device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, Linear, SelfAttention


def dropout(h, p: float, training: bool, data_axis=None):
    """``F.dropout``; on a process-group ``data`` axis (``data_axis``, mesh
    form (b)) the rank's slice of a mask drawn for the whole batch from
    torch's global generator, which the ranks keep in one state, so that
    the ranks together draw what one process draws on the whole batch (on
    the CPU bit for bit: ``F.dropout`` draws ``bernoulli_(1 - p)`` on the
    input's shape and multiplies by it over 1 - p)."""
    if data_axis is None or not data_axis.distributed or not training \
            or p == 0.0:
        return F.dropout(h, p, training)
    n = data_axis.n
    keep = torch.empty((h.shape[0] * n,) + tuple(h.shape[1:]), dtype=h.dtype,
                       device=h.device).bernoulli_(1.0 - p)
    return h * keep.chunk(n, 0)[data_axis.index[0]].div_(1.0 - p)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 dropout: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dropout = dropout
        self.data_axis = None      # set by a trainer's data mesh
        self.ln1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, qkv_bias=True,
                                  compute_dtype=compute_dtype)
        self.ln2 = LayerNorm(dim)
        self.fc1 = Linear(dim, mlp_dim, compute_dtype=compute_dtype)
        self.fc2 = Linear(mlp_dim, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        drop = lambda h: dropout(h, self.dropout, self.training,
                                 self.data_axis)
        x = x + drop(self.attn(self.ln1(x)))
        h = drop(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))
        return x + drop(self.fc2(h))


class ViT(nn.Module):
    """Images (B, H, W, 3) -> logits (B, num_classes) fp32; dropout is
    active in training mode (``model.train()``), as Flax's
    ``deterministic=False``."""

    def __init__(self, image_size: int = 128, patch_size: int = 32,
                 num_classes: int = 3, dim: int = 512, depth: int = 6,
                 heads: int = 8, mlp_dim: int = 1024, dropout: float = 0.1,
                 emb_dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch_size {patch_size}")
        dt = None if dtype == torch.float32 else dtype
        n = (image_size // patch_size) ** 2
        self.dtype, self.dim, self.depth = dtype, dim, depth
        self.emb_dropout = emb_dropout
        self.data_axis = None      # set by a trainer's data mesh
        self.patch_embed = Conv2d(3, dim, patch_size, stride=patch_size,
                                  compute_dtype=dt)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, dim))
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(dim, heads, mlp_dim,
                                                  dropout, dt))
        self.ln_final = LayerNorm(dim)
        self.head = Linear(dim, num_classes)

    def forward(self, x, return_features: bool = False):
        """``return_features=True`` returns the post-``ln_final`` class
        token (B, dim) in fp32 instead of the logits."""
        b = x.shape[0]
        h = self.patch_embed(x.to(self.dtype)).reshape(b, -1, self.dim)
        cls = self.cls_token.to(h.dtype).expand(b, 1, self.dim)
        h = torch.cat([cls, h], dim=1) + self.pos_embed.to(h.dtype)
        h = dropout(h, self.emb_dropout, self.training, self.data_axis)
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h)
        h = self.ln_final(h[:, 0]).float()
        return h if return_features else self.head(h)
