"""Class-conditional tiny diffusion UNet (port of ``models/tiny_unet.py``).

Same topology and submodule names as the JAX module, so
:func:`..io.from_jax.load_jax_params` fills it from a Flax tree: channel
ladder base·[1,2,2,2] over 64×64, 8 encoder stages with skip-concat, an
attention bottleneck, 8 decoder stages and a GN+SiLU tail; a sinusoidal
timestep MLP, and the class label cross-attended as one context token (label
0 is the CFG null). NHWC; ``dtype`` is the compute dtype of every linear and
conv over fp32 parameters, and the output is fp32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import (Conv2d, GroupNorm, LabelEmbedder, ResBlock,
                     TimestepEmbedder, TransformerBlock, Upsample)

# (name, kind, channel index): the encoder below enc0_conv; "r" ResBlock to
# mult[i], "ra" ResBlock + TransformerBlock, "d" stride-2 conv. Every stage
# pushes a skip.
_ENCODER = [("enc1", "ra", 0), ("enc2", "d", 0), ("enc3", "ra", 1),
            ("enc4", "d", 1), ("enc5", "ra", 2), ("enc6", "d", 2),
            ("enc7", "r", 3)]
# (name, channel index, attention, upsample): each pops one skip first.
_DECODER = [("dec0", 2, False, False), ("dec1", 2, False, True),
            ("dec2", 1, True, False), ("dec3", 1, True, True),
            ("dec4", 0, True, False), ("dec5", 0, True, True),
            ("dec6", 0, True, False), ("dec7", 0, True, False)]


class TinyUNet(nn.Module):
    """Predicts ε for x_t (B, H, W, C) given t (B,) and class labels (B,)."""

    def __init__(self, out_channels: int = 3, base_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 2, 2, 2),
                 num_classes: int = 10, dropout: float = 0.0,
                 time_emb_dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        mult = [base_channels * m for m in channel_mult]
        dt = None if dtype == torch.float32 else dtype
        self.dtype = dtype
        self.time_embedding = TimestepEmbedder(time_emb_dim, 256,
                                               compute_dtype=dt)
        self.label_embedding = LabelEmbedder(num_classes, 256, time_emb_dim,
                                             compute_dtype=dt)

        def res(name, cin, cout):
            self.add_module(name, ResBlock(cin, cout, time_emb_dim, dropout,
                                           compute_dtype=dt))

        def att(name, c):
            self.add_module(name, TransformerBlock(c, time_emb_dim,
                                                   compute_dtype=dt))

        self.enc0_conv = Conv2d(out_channels, mult[0], 3,
                                padding=1, compute_dtype=dt)
        skips, c = [mult[0]], mult[0]
        for name, kind, i in _ENCODER:
            if kind == "d":
                self.add_module(f"{name}_down", Conv2d(
                    c, mult[i], 3, stride=2, same=True, compute_dtype=dt))
            else:
                res(f"{name}_res", c, mult[i])
                if kind == "ra":
                    att(f"{name}_att", mult[i])
            c = mult[i]
            skips.append(c)

        res("mid_res1", c, mult[3])
        att("mid_att", mult[3])
        res("mid_res2", mult[3], mult[3])
        c = mult[3]

        for name, i, has_att, has_up in _DECODER:
            res(f"{name}_res", c + skips.pop(), mult[i])
            c = mult[i]
            if has_att:
                att(f"{name}_att", c)
            if has_up:
                self.add_module(f"{name}_up", Upsample(c, compute_dtype=dt))

        self.tail_norm = GroupNorm(c, 32, act="silu")
        self.tail_conv = Conv2d(c, out_channels, 3, padding=1,
                                compute_dtype=dt)

    def forward(self, x, t, labels):
        time = self.time_embedding(t)
        context = self.label_embedding(labels)
        h = self.enc0_conv(x.to(self.dtype))
        skips = [h]
        for name, kind, _ in _ENCODER:
            if kind == "d":
                h = getattr(self, f"{name}_down")(h)
            else:
                h = getattr(self, f"{name}_res")(h, time)
                if kind == "ra":
                    h = getattr(self, f"{name}_att")(h, context)
            skips.append(h)

        h = self.mid_res1(h, time)
        h = self.mid_res2(self.mid_att(h, context), time)

        for name, _, has_att, has_up in _DECODER:
            h = getattr(self, f"{name}_res")(torch.cat([h, skips.pop()], -1),
                                             time)
            if has_att:
                h = getattr(self, f"{name}_att")(h, context)
            if has_up:
                h = getattr(self, f"{name}_up")(h)

        return self.tail_conv(self.tail_norm(h)).float()
