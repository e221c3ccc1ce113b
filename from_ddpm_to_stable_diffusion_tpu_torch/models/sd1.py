"""SD1 models: CLIP text encoder, UNet, VAE encoder and decoder (port of
``models/sd1.py``).

Topology, submodule names and NHWC layouts follow the JAX modules one to
one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import upsample_nearest_2x
from ..parallel.sharding import column, row, row_replicated
from .layers import (Conv2d, GroupNorm, LayerNorm, SelfAttention,
                     TransformerBlock, Upsample)

SD1_LATENT_SCALE = 0.18215


def _dtype(module: nn.Module) -> torch.dtype:
    """The compute dtype: the dtype the module's first weight is stored in."""
    return next(module.parameters()).dtype


# --------------------------------------------------------------------------
# CLIP text encoder
# --------------------------------------------------------------------------
class CLIPTextLayer(nn.Module):
    TP_LAYERS = {"fc1": ("column", 1), "fc2": ("row", 1)}
    tp = None

    def __init__(self, dim: int = 768, num_heads: int = 12):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, qkv_bias=True, causal=True)
        self.ln2 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        quick_gelu = lambda h: h * torch.sigmoid(1.702 * h)
        if self.tp is not None:
            return x + row(self.fc2, [quick_gelu(h) for h in column(
                self.fc1, self.ln2(x), self.tp)], self.tp)
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class CLIPText(nn.Module):
    """Token ids (B, 77) -> final-LN states (B, 77, 768)."""

    def __init__(self, vocab_size: int = 49408, num_positions: int = 77,
                 embed_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12):
        super().__init__()
        self.num_layers = num_layers
        self.token_embedding = nn.Embedding(vocab_size, embed_dim)
        self.position_value = nn.Parameter(torch.zeros(num_positions,
                                                       embed_dim))
        for i in range(num_layers):
            self.add_module(f"layer{i}", CLIPTextLayer(embed_dim, num_heads))
        self.ln_final = LayerNorm(embed_dim)

    def forward(self, tokens):
        x = self.token_embedding(tokens)
        x = x + self.position_value.to(x.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
        return self.ln_final(x)


# --------------------------------------------------------------------------
# Diffusion UNet
# --------------------------------------------------------------------------
class SD1ResBlock(nn.Module):
    """GN+SiLU+conv, additive time, GN+SiLU+conv, 1×1 skip. Under TP the
    time projection is row-parallel on the replicated embedding."""

    TP_LAYERS = {"time_proj": ("row", 1)}
    tp = None

    def __init__(self, in_channels: int, out_channels: int, time_dim: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, 32, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_proj = nn.Linear(time_dim, out_channels)
        self.norm2 = GroupNorm(out_channels, 32, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.skip = (Conv2d(in_channels, out_channels, 1)
                     if in_channels != out_channels else None)

    def forward(self, x, time_emb):
        h = self.conv1(self.norm1(x))
        t = (self.time_proj(F.silu(time_emb)) if self.tp is None else
             row_replicated(self.time_proj, F.silu(time_emb), self.tp))
        h = h + t[:, None, None, :]
        h = self.conv2(self.norm2(h))
        return h + (x if self.skip is None else self.skip(x))


class SD1UNet(nn.Module):
    """ε-prediction UNet. x: (B, H/8, W/8, 4) NHWC; context: (B, 77, d_ctx);
    time_feat: (B, 320) :func:`sd1_time_embedding` features. ``int8_mm``:
    the TransformerBlocks' attention and GEGLU projections in W8A8 int8.
    Under TP the time MLP is Megatron's pair (time_fc1 column, time_fc2
    row)."""

    TP_LAYERS = {"time_fc1": ("column", 1), "time_fc2": ("row", 1)}
    tp = None

    def __init__(self, model_channels: int = 320, context_dim: int = 768,
                 num_heads: int = 8, int8_mm: bool = False):
        super().__init__()
        self.int8_mm = int8_mm
        ch = model_channels
        tdim = 4 * ch
        self.time_fc1 = nn.Linear(320, tdim)
        self.time_fc2 = nn.Linear(tdim, tdim)

        def res(name, cin, cout):
            self.add_module(name, SD1ResBlock(cin, cout, tdim))

        def att(name, c):
            self.add_module(name, TransformerBlock(c, context_dim, num_heads,
                                                   int8_mm=int8_mm))

        def down(name, c):
            self.add_module(name, Conv2d(c, c, 3, stride=2, padding=1))

        self.enc0_conv = Conv2d(4, ch, 3, padding=1)
        skips = [ch]
        cin = ch
        for i, (mult, kind) in enumerate(
                [(1, "ra"), (1, "ra"), (1, "d"), (2, "ra"), (2, "ra"),
                 (2, "d"), (4, "ra"), (4, "ra"), (4, "d"), (4, "r"),
                 (4, "r")], start=1):
            if kind == "d":
                down(f"enc{i}_down", cin)
            else:
                res(f"enc{i}_res", cin, mult * ch)
                if kind == "ra":
                    att(f"enc{i}_att", mult * ch)
                cin = mult * ch
            skips.append(cin)

        res("mid_res1", 4 * ch, 4 * ch)
        att("mid_att", 4 * ch)
        res("mid_res2", 4 * ch, 4 * ch)

        cin = 4 * ch
        for i, (mult, has_att, has_up) in enumerate(
                [(4, False, False), (4, False, False), (4, False, True),
                 (4, True, False), (4, True, False), (4, True, True),
                 (2, True, False), (2, True, False), (2, True, True),
                 (1, True, False), (1, True, False), (1, True, False)]):
            res(f"dec{i}_res", cin + skips.pop(), mult * ch)
            cin = mult * ch
            if has_att:
                att(f"dec{i}_att", cin)
            if has_up:
                self.add_module(f"dec{i}_up", Upsample(cin))

        self.final_norm = GroupNorm(ch, 32, act="silu")
        self.final_conv = Conv2d(ch, 4, 3, padding=1)

    def forward(self, x, context, time_feat):
        dt = _dtype(self)
        if self.tp is not None:
            t = row(self.time_fc2, [F.silu(h) for h in column(
                self.time_fc1, time_feat.to(dt), self.tp)], self.tp)
        else:
            t = self.time_fc2(F.silu(self.time_fc1(time_feat.to(dt))))
        h = self.enc0_conv(x.to(dt))
        skips = [h]
        for i in range(1, 12):
            if hasattr(self, f"enc{i}_down"):
                h = getattr(self, f"enc{i}_down")(h)
            else:
                h = getattr(self, f"enc{i}_res")(h, t)
                if hasattr(self, f"enc{i}_att"):
                    h = getattr(self, f"enc{i}_att")(h, context)
            skips.append(h)

        h = self.mid_res2(self.mid_att(self.mid_res1(h, t), context), t)

        for i in range(12):
            h = getattr(self, f"dec{i}_res")(
                torch.cat([h, skips.pop()], dim=-1), t)
            if hasattr(self, f"dec{i}_att"):
                h = getattr(self, f"dec{i}_att")(h, context)
            if hasattr(self, f"dec{i}_up"):
                h = getattr(self, f"dec{i}_up")(h)

        return self.final_conv(self.final_norm(h)).float()


# --------------------------------------------------------------------------
# VAE
# --------------------------------------------------------------------------
class VAEResBlock(nn.Module):
    """GN+SiLU+conv ×2 with a 1×1 skip; no time input."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, 32, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(out_channels, 32, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.skip = (Conv2d(in_channels, out_channels, 1)
                     if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return h + (x if self.skip is None else self.skip(x))


class VAEAttentionBlock(nn.Module):
    """GN + one-head self-attention over the h·w tokens."""

    def __init__(self, channels: int = 512):
        super().__init__()
        self.norm = GroupNorm(channels, 32)
        self.attn = SelfAttention(channels, 1, qkv_bias=True)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.attn(self.norm(x).reshape(b, h * w, c))
        return x + y.reshape(b, h, w, c)


class _Downsample(Conv2d):
    """Stride-2 3x3 conv after an asymmetric (0, 1, 0, 1) pad: right and
    bottom only, no other padding, whatever the size (Flax ``SAME`` and
    ``padding=1`` both differ from it on odd sizes)."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return super().forward(F.pad(x, (0, 0, 0, 1, 0, 1)))


class VAEEncoder(nn.Module):
    """Image (B, H, W, 3) in [-1, 1] and noise (B, H/8, W/8, 4) -> scaled
    latent: z = (mean + std * noise) * SD1_LATENT_SCALE in fp32, the
    log-variance clamped to [-30, 20]."""

    _RES = [(128, 128), (128, 128), (128, 256), (256, 256), (256, 512),
            (512, 512), (512, 512), (512, 512), (512, 512), (512, 512)]
    _DOWN = {1: ("down0", 128), 3: ("down1", 256), 5: ("down2", 512)}

    def __init__(self):
        super().__init__()
        self.conv_in = Conv2d(3, 128, 3, padding=1)
        for i, (cin, cout) in enumerate(self._RES):
            self.add_module(f"res{i}", VAEResBlock(cin, cout))
        for name, channels in self._DOWN.values():
            self.add_module(name, _Downsample(channels))
        self.mid_attn = VAEAttentionBlock(512)
        self.norm_out = GroupNorm(512, 32, act="silu")
        self.conv_out = Conv2d(512, 8, 3, padding=1)
        self.conv_quant = Conv2d(8, 8, 1)

    def forward(self, x, noise):
        h = self.conv_in(x.to(_dtype(self)))
        for i in range(9):
            h = getattr(self, f"res{i}")(h)
            if i in self._DOWN:
                h = getattr(self, self._DOWN[i][0])(h)
        h = self.res9(self.mid_attn(h))
        h = self.conv_quant(self.conv_out(self.norm_out(h)))
        mean, log_var = h.float().chunk(2, dim=-1)
        std = torch.exp(0.5 * log_var.clamp(-30.0, 20.0))
        return (mean + std * noise.float()) * SD1_LATENT_SCALE


class VAEDecoder(nn.Module):
    """Scaled latent (B, H/8, W/8, 4) -> image (B, H, W, 3) in [−1, 1]."""

    _RES = [(512, 512)] * 8 + [(512, 256), (256, 256), (256, 256),
                               (256, 128), (128, 128), (128, 128)]

    def __init__(self):
        super().__init__()
        self.conv_in1 = Conv2d(4, 4, 1)
        self.conv_in2 = Conv2d(4, 512, 3, padding=1)
        self.mid_attn = VAEAttentionBlock(512)
        for i, (cin, cout) in enumerate(self._RES):
            self.add_module(f"res{i}", VAEResBlock(cin, cout))
        self.up0_conv = Conv2d(512, 512, 3, padding=1)
        self.up1_conv = Conv2d(512, 512, 3, padding=1)
        self.up2_conv = Conv2d(256, 256, 3, padding=1)
        self.norm_out = GroupNorm(128, 32, act="silu")
        self.conv_out = Conv2d(128, 3, 3, padding=1)

    def forward(self, z):
        h = self.conv_in1((z / SD1_LATENT_SCALE).to(_dtype(self)))
        h = self.mid_attn(self.res0(self.conv_in2(h)))
        ups = {4: self.up0_conv, 7: self.up1_conv, 10: self.up2_conv}
        for i in range(1, 14):
            h = getattr(self, f"res{i}")(h)
            if i in ups:
                h = ups[i](upsample_nearest_2x(h))
        return self.conv_out(self.norm_out(h)).float()
