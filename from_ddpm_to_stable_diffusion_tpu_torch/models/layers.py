"""Building blocks of the SD1 and tiny-SD models (port of
``models/layers.py``).

Activations are NHWC (images) and (B, L, C) (tokens), as in the JAX
package. Submodules are named after the Flax parameter paths (``attn1.qkv``,
``norm_in``, ...) so that :mod:`..io.from_jax` maps a Flax tree onto a
``state_dict`` by renaming leaves only. Norms compute fp32 statistics and
return the input's dtype.

Linear and conv modules compute in their weights' dtype (the SD1 serving
path stores bf16 weights), unless they are given a ``compute_dtype``: then
the input, weight and bias are cast to it at each call and the parameters
stay as stored, as Flax's ``dtype=`` does (the trainer's fp32 parameters
with bf16 compute, the JAX ``POLICIES["bf16"]``). ``torch.autocast`` is not
used: it would also recast the fp32 logits of the plain attention.

``int8_mm=True`` builds the attention and GEGLU projections as
:class:`..ops.quantize.QuantLinear` (W8A8 serving), as the JAX modules'
``int8_mm`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.embeddings import timestep_embedding
from ..ops.groupnorm import group_norm, layer_norm
from ..ops.image import upsample_nearest_2x
from ..ops.quantize import dense_cls


def _cast(dtype, *xs):
    return tuple(None if x is None else x.to(dtype) for x in xs)


class Linear(nn.Linear):
    """``nn.Linear`` with an optional compute dtype."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        return F.linear(*_cast(self.compute_dtype, x, self.weight, self.bias))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NHWC tensors, with an optional compute dtype. With
    channels-last weights the permutes are views: cuDNN reads and writes the
    NHWC memory as it lies.

    ``same=True`` pads like Flax's default ``padding="SAME"``: per spatial
    dim a total of (ceil(n/s) − 1)·s + k − n, the low side rounded down. For
    a stride-2 3×3 conv on an even size that is (0, 1), where ``padding=1``
    would pad (1, 1) and shift every output pixel."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 same: bool = False, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype
        self.same = same

    def forward(self, x):
        if self.same:
            pads = []
            for n, k, s in zip(x.shape[2:0:-1], self.kernel_size[::-1],
                               self.stride[::-1]):
                total = max((-(-n // s) - 1) * s + k - n, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, (0, 0, *pads))
        w, b = self.weight, self.bias
        if self.compute_dtype is not None:
            x, w, b = _cast(self.compute_dtype, x, w, b)
        return self._conv_forward(x.permute(0, 3, 1, 2), w,
                                  b).permute(0, 2, 3, 1)


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
                 out_bias: bool = True, causal: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 int8_mm: bool = False):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        dense = dense_cls(int8_mm)
        self.qkv = dense(dim, 3 * dim, bias=qkv_bias,
                         compute_dtype=compute_dtype)
        self.out = dense(dim, dim, bias=out_bias, compute_dtype=compute_dtype)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.out(multi_head_attention(q, k, v, self.num_heads,
                                             causal=self.causal))


class CrossAttention(nn.Module):
    """Query from x (B, Lq, C); key and value from context (B, Lk, d_ctx),
    or from a 2-D (B, d_ctx) context as one token (tiny-SD's label)."""

    def __init__(self, dim: int, context_dim: int, num_heads: int,
                 qkv_bias: bool = False,
                 compute_dtype: Optional[torch.dtype] = None,
                 int8_mm: bool = False):
        super().__init__()
        self.num_heads = num_heads
        dense = dense_cls(int8_mm)
        lin = lambda i, bias: dense(i, dim, bias=bias,
                                    compute_dtype=compute_dtype)
        self.q = lin(dim, qkv_bias)
        self.k = lin(context_dim, qkv_bias)
        self.v = lin(context_dim, qkv_bias)
        self.out = lin(dim, True)

    def forward(self, x, context):
        if context.dim() == 2:
            context = context[:, None, :]
        return self.out(multi_head_attention(
            self.q(x), self.k(context), self.v(context), self.num_heads))


class TransformerBlock(nn.Module):
    """Spatial transformer: GN → 1×1 in → self-attn → cross-attn → GEGLU →
    1×1 out, short residuals around each sub-layer and a long one around all.

    GEGLU's gate uses the tanh approximation of GELU because the JAX package
    does (``jax.nn.gelu`` defaults to ``approximate=True``); the original SD1
    uses the exact erf GELU, at most 4.7e-4 away per element.

    ``num_heads=None`` derives the heads from a head dim of 128, as the JAX
    block does: ``max(1, channels // 128)``.
    """

    def __init__(self, channels: int, context_dim: int,
                 num_heads: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 int8_mm: bool = False):
        super().__init__()
        c, dt = channels, compute_dtype
        heads = num_heads or max(1, c // 128)
        dense = dense_cls(int8_mm)
        self.norm_in = GroupNorm(c, 32, eps=1e-6)
        self.proj_in = Conv2d(c, c, 1, compute_dtype=dt)
        self.norm1 = LayerNorm(c)
        self.attn1 = SelfAttention(c, heads, compute_dtype=dt,
                                   int8_mm=int8_mm)
        self.norm2 = LayerNorm(c)
        self.attn2 = CrossAttention(c, context_dim, heads, compute_dtype=dt,
                                    int8_mm=int8_mm)
        self.norm3 = LayerNorm(c)
        self.geglu_in = dense(c, 8 * c, compute_dtype=dt)
        self.geglu_out = dense(4 * c, c, compute_dtype=dt)
        self.proj_out = Conv2d(c, c, 1, compute_dtype=dt)

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

    def __init__(self, channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1,
                           compute_dtype=compute_dtype)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class TimestepEmbedder(nn.Module):
    """Sinusoidal features (fp32, cast to the compute dtype) -> 2-layer SiLU
    MLP."""

    def __init__(self, hidden_size: int, freq_dim: int = 256,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.freq_dim, self.compute_dtype = freq_dim, compute_dtype
        self.fc1 = Linear(freq_dim, hidden_size, compute_dtype=compute_dtype)
        self.fc2 = Linear(hidden_size, hidden_size,
                          compute_dtype=compute_dtype)

    def forward(self, t):
        x = timestep_embedding(t, self.freq_dim)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return self.fc2(F.silu(self.fc1(x)))


class LabelEmbedder(nn.Module):
    """Class-label embedding with index 0 = unconditional: its row is
    multiplied by zero, so the CFG null branch sees a zero embedding."""

    def __init__(self, num_classes: int, d_model: int = 256,
                 hidden_size: int = 512,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.table = nn.Embedding(num_classes + 1, d_model)
        self.fc1 = Linear(d_model, hidden_size, compute_dtype=compute_dtype)
        self.fc2 = Linear(hidden_size, hidden_size,
                          compute_dtype=compute_dtype)

    def forward(self, labels):
        x = self.table(labels)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = x * (labels != 0)[..., None].to(x.dtype)
        return self.fc2(F.silu(self.fc1(x)))


class ResBlock(nn.Module):
    """GN+SiLU conv block with additive time conditioning, dropout before
    the second conv (active in training mode), and a 1×1 skip when the
    channel count changes."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 dropout: float = 0.0, num_groups: int = 32,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        self.dropout = dropout
        self.norm1 = GroupNorm(in_channels, num_groups, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1,
                            compute_dtype=dt)
        self.time_proj = Linear(time_dim, out_channels, compute_dtype=dt)
        self.norm2 = GroupNorm(out_channels, num_groups, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1,
                            compute_dtype=dt)
        self.skip = (Conv2d(in_channels, out_channels, 1, compute_dtype=dt)
                     if in_channels != out_channels else None)

    def forward(self, x, time_emb):
        h = self.conv1(self.norm1(x))
        h = h + self.time_proj(F.silu(time_emb))[:, None, None, :]
        h = F.dropout(self.norm2(h), self.dropout, self.training)
        h = self.conv2(h)
        return h + (x if self.skip is None else self.skip(x))
