"""Building blocks of the SD1 models (port of ``models/layers.py``).

Activations are NHWC (images) and (B, L, C) (tokens), as in the JAX
package. Submodules are named after the Flax parameter paths (``attn1.qkv``,
``norm_in``, ...) so that :mod:`..io.from_jax` maps a Flax tree onto a
``state_dict`` by renaming leaves only. Linear and conv modules compute in
their weights' dtype, norms in fp32 statistics with the input's dtype out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.groupnorm import group_norm, layer_norm
from ..ops.image import upsample_nearest_2x


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC tensors. With channels-last weights the permutes
    are views: cuDNN reads and writes the NHWC memory as it lies."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """Parameter-owning wrapper over :func:`group_norm` (fp32 statistics)."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5, act=None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.eps, self.act)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class SelfAttention(nn.Module):
    """Fused-QKV multi-head self attention over (B, L, C); q|k|v columns."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = False,
                 out_bias: bool = True, causal: bool = False):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.out = nn.Linear(dim, dim, bias=out_bias)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.out(multi_head_attention(q, k, v, self.num_heads,
                                             causal=self.causal))


class CrossAttention(nn.Module):
    """Query from x (B, Lq, C); key and value from context (B, Lk, d_ctx)."""

    def __init__(self, dim: int, context_dim: int, num_heads: int,
                 qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.k = nn.Linear(context_dim, dim, bias=qkv_bias)
        self.v = nn.Linear(context_dim, dim, bias=qkv_bias)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, context):
        return self.out(multi_head_attention(
            self.q(x), self.k(context), self.v(context), self.num_heads))


class TransformerBlock(nn.Module):
    """Spatial transformer: GN → 1×1 in → self-attn → cross-attn → GEGLU →
    1×1 out, short residuals around each sub-layer and a long one around all.

    GEGLU's gate uses the tanh approximation of GELU because the JAX package
    does (``jax.nn.gelu`` defaults to ``approximate=True``); the original SD1
    uses the exact erf GELU, at most 4.7e-4 away per element.
    """

    def __init__(self, channels: int, context_dim: int, num_heads: int):
        super().__init__()
        c = channels
        self.norm_in = GroupNorm(c, 32, eps=1e-6)
        self.proj_in = Conv2d(c, c, 1)
        self.norm1 = LayerNorm(c)
        self.attn1 = SelfAttention(c, num_heads)
        self.norm2 = LayerNorm(c)
        self.attn2 = CrossAttention(c, context_dim, num_heads)
        self.norm3 = LayerNorm(c)
        self.geglu_in = nn.Linear(c, 8 * c)
        self.geglu_out = nn.Linear(4 * c, c)
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x, context):
        b, h, w, c = x.shape
        y = self.proj_in(self.norm_in(x)).reshape(b, h * w, c)
        y = self.attn1(self.norm1(y)) + y
        y = self.attn2(self.norm2(y), context) + y
        z, gate = self.geglu_in(self.norm3(y)).chunk(2, dim=-1)
        y = y + self.geglu_out(z * F.gelu(gate, approximate="tanh"))
        return self.proj_out(y.reshape(b, h, w, c)) + x


class Upsample(nn.Module):
    """Nearest ×2 + 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))
