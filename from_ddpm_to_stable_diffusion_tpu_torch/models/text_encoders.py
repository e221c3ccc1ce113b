"""SD3 text encoders: CLIP-L / CLIP-G with a hidden-layer tap, and the T5-XXL
encoder (port of ``models/text_encoders.py``).

Submodules and parameters are named after the Flax parameter paths. The
modules compute in the dtype their weights are stored in; norms use fp32
statistics. Three GELUs, as in the JAX package: CLIP-L quick-GELU, CLIP-G
the exact erf form, T5 the tanh approximation. T5 attention uses unscaled
logits (``scale=1.0``) and a relative-position bucket bias that block 0
computes and all blocks share. ``T5Config(int8_mm=True)`` builds T5's
q / k / v / o and wi_0 / wi_1 / wo as :class:`..ops.quantize.QuantLinear`
(W8A8 serving); the CLIP towers are not quantized.

Tensor parallelism (:func:`..parallel.sharding.apply_tp`): the CLIP
attentions and T5's q / k / v on each shard's heads (T5's relative-position
bias sliced to them), the MLPs as Megatron pairs (``fc1`` / ``wi_0`` /
``wi_1`` column, ``fc2`` / ``wo`` row), ``o`` and ``out`` row.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.groupnorm import rms_norm
from ..ops.quantize import dense_cls
from ..parallel.sharding import column, head_slices, row
from .layers import LayerNorm, Linear, SelfAttention


# --------------------------------------------------------------------------
# CLIP text model with an intermediate tap
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    hidden_act: str = "quick_gelu"  # quick_gelu | gelu


CLIP_L_CONFIG = CLIPTextConfig()
CLIP_G_CONFIG = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                               hidden_act="gelu")


class CLIPTextLayer(nn.Module):
    TP_LAYERS = {"fc1": ("column", 1), "fc2": ("row", 1)}
    tp = None

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        if config.hidden_act not in ("quick_gelu", "gelu"):
            raise ValueError(f"unknown hidden_act {config.hidden_act!r}")
        dim = config.hidden_size
        self.hidden_act = config.hidden_act
        self.ln1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, config.num_heads, qkv_bias=True,
                                  causal=True)
        self.ln2 = LayerNorm(dim)
        self.fc1 = Linear(dim, 4 * dim)
        self.fc2 = Linear(4 * dim, dim)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        if self.tp is not None:
            return x + row(self.fc2, [self._act(h) for h in column(
                self.fc1, self.ln2(x), self.tp)], self.tp)
        return x + self.fc2(self._act(self.fc1(self.ln2(x))))

    def _act(self, h):
        if self.hidden_act == "quick_gelu":
            return h * torch.sigmoid(1.702 * h)
        return F.gelu(h)


class CLIPTextModel(nn.Module):
    """Token ids (B, L) -> (last_hidden, intermediate_hidden,
    pooled_projected). ``intermediate_output`` taps the output of that layer
    (−2: the penultimate); the pooled state is the final-LN state at the
    arg-max token id (EOS), through ``text_projection`` in fp32."""

    def __init__(self, config: CLIPTextConfig = CLIP_L_CONFIG,
                 intermediate_output: Optional[int] = None):
        super().__init__()
        self.config = config
        self.tap = (None if intermediate_output is None
                    else intermediate_output % config.num_layers)
        self.token_embedding = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(config.max_positions, config.hidden_size))
        for i in range(config.num_layers):
            self.add_module(f"layer{i}", CLIPTextLayer(config))
        self.ln_final = LayerNorm(config.hidden_size)
        self.text_projection = nn.Parameter(torch.eye(config.hidden_size))

    def forward(self, tokens):
        x = self.token_embedding(tokens)
        x = x + self.position_embedding.to(x.dtype)
        intermediate = None
        for i in range(self.config.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i == self.tap:
                intermediate = x
        x = self.ln_final(x)
        eos = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos]
        pooled = pooled.float() @ self.text_projection.float()
        return x, intermediate, pooled


# --------------------------------------------------------------------------
# T5-XXL encoder
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    int8_mm: bool = False   # W8A8 projections


def t5_relative_position_bucket(relative_position, num_buckets: int = 32,
                                max_distance: int = 128):
    """Bidirectional Mesh-TF bucket map of an integer tensor of relative
    positions (key − query): half the buckets per sign; exact below
    ``num_buckets // 4``, logarithmic up to ``max_distance`` beyond."""
    num_buckets //= 2
    buckets = (relative_position > 0).to(torch.int32) * num_buckets
    rel = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    # rel = 0 is small; the clamp only keeps log(0) out of the int cast
    rel_large = max_exact + (
        torch.log(rel.clamp(min=1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int32)
    rel_large = rel_large.clamp(max=num_buckets - 1)
    return buckets + torch.where(is_small, rel.to(torch.int32), rel_large)


class T5Attention(nn.Module):
    TP_LAYERS = {"q": ("column", 1), "k": ("column", 1), "v": ("column", 1),
                 "o": ("row", 1)}
    tp = None

    def __init__(self, config: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.config = config
        self.num_heads = config.num_heads
        d = config.d_model
        dense = dense_cls(config.int8_mm)
        self.q = dense(d, d, bias=False)
        self.k = dense(d, d, bias=False)
        self.v = dense(d, d, bias=False)
        self.o = dense(d, d, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Parameter(
                torch.zeros(config.rel_buckets, config.num_heads))

    def forward(self, x, past_bias=None):
        cfg = self.config
        if hasattr(self, "relative_attention_bias"):
            pos = torch.arange(x.shape[1], device=x.device)
            bucket = t5_relative_position_bucket(
                pos[None, :] - pos[:, None], cfg.rel_buckets,
                cfg.rel_max_distance)
            # (1, H, L, L), contiguous: every block's attention reads it
            past_bias = self.relative_attention_bias[bucket.long()].permute(
                2, 0, 1)[None].contiguous()
        if self.tp is not None:
            tp = self.tp
            outs = [multi_head_attention(q, k, v, cfg.num_heads // tp.n,
                                         bias=bias, scale=1.0)
                    for q, k, v, bias in zip(
                        column(self.q, x, tp), column(self.k, x, tp),
                        column(self.v, x, tp), head_slices(past_bias, 1, tp))]
            return row(self.o, outs, tp), past_bias
        out = multi_head_attention(self.q(x), self.k(x), self.v(x),
                                   cfg.num_heads, bias=past_bias, scale=1.0)
        return self.o(out), past_bias


class T5Block(nn.Module):
    TP_LAYERS = {"wi_0": ("column", 1), "wi_1": ("column", 1),
                 "wo": ("row", 1)}
    tp = None

    def __init__(self, config: T5Config, has_relative_bias: bool = False):
        super().__init__()
        d, ff = config.d_model, config.d_ff
        dense = dense_cls(config.int8_mm)
        self.ln1_scale = nn.Parameter(torch.ones(d))
        self.attn = T5Attention(config, has_relative_bias)
        self.ln2_scale = nn.Parameter(torch.ones(d))
        self.wi_0 = dense(d, ff, bias=False)
        self.wi_1 = dense(d, ff, bias=False)
        self.wo = dense(ff, d, bias=False)

    def forward(self, x, past_bias=None):
        h, past_bias = self.attn(rms_norm(x, self.ln1_scale, eps=1e-6),
                                 past_bias)
        x = x + h
        h = rms_norm(x, self.ln2_scale, eps=1e-6)
        if self.tp is not None:
            h = row(self.wo, [
                F.gelu(a, approximate="tanh") * b for a, b in zip(
                    column(self.wi_0, h, self.tp),
                    column(self.wi_1, h, self.tp))], self.tp)
        else:
            h = self.wo(F.gelu(self.wi_0(h), approximate="tanh")
                        * self.wi_1(h))
        return x + h, past_bias


class T5Encoder(nn.Module):
    """Token ids (B, L) -> (B, L, d_model)."""

    def __init__(self, config: T5Config = T5Config()):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.d_model)
        for i in range(config.num_layers):
            self.add_module(f"block{i}", T5Block(config, i == 0))
        self.final_ln_scale = nn.Parameter(torch.ones(config.d_model))

    def forward(self, tokens):
        x = self.embed_tokens(tokens)
        past_bias = None
        for i in range(self.config.num_layers):
            x, past_bias = getattr(self, f"block{i}")(x, past_bias)
        return rms_norm(x, self.final_ln_scale, eps=1e-6)


# --------------------------------------------------------------------------
# SD3 conditioning assembly
# --------------------------------------------------------------------------
def assemble_sd3_cond(l_hidden, l_pooled, g_hidden, g_pooled, t5_out):
    """(B,77,768) | (B,77,1280) -> pad to 4096 -> ‖ T5 (B,77,4096) along
    the sequence => context (B,154,4096); pooled = l | g => (B,2048)."""
    lg = torch.cat([l_hidden, g_hidden], dim=-1)
    lg = F.pad(lg, (0, 4096 - lg.shape[-1]))
    context = torch.cat([lg, t5_out.to(lg.dtype)], dim=1)
    return context, torch.cat([l_pooled, g_pooled], dim=-1)
