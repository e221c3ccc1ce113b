"""Class-conditional video diffusion UNet (port of
``models/tiny_video_unet.py``).

Factorised space / time attention over (B, T, H, W, C) clips: every 2-D op
(convs, GroupNorm, the spatial TransformerBlocks) runs with the frames
folded into the batch, (B·T, H, W, C); :class:`TemporalAttention` folds the
spatial positions into the batch instead, (B·H·W, T, C), and adds sinusoidal
frame positions. Downsampling is spatial only and every frame shares the
weights. Submodules are named after the Flax parameter paths, so
:func:`..io.from_jax.load_jax_params` fills the model from a Flax tree.

At 32² frames the level-0 spatial attentions (``enc1_att``, ``dec2_att``)
see 1024 tokens and take the flash kernels on the card (K1, and K3 / K4 in
the backward, at head dim = the base channels); the 16² and 8² levels, the
one-token cross-attention and the temporal attention stay plain
(``ops/attention.py``). Trains through
``DDPMTrainer(model=TinyVideoUNet(...), sample_shape=(T, H, W, 3))``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.embeddings import timestep_embedding
from .layers import (Conv2d, GroupNorm, LabelEmbedder, LayerNorm, ResBlock,
                     SelfAttention, TimestepEmbedder, TransformerBlock,
                     Upsample)


class TemporalAttention(nn.Module):
    """Self-attention over the frame axis at every spatial position of a
    (B, T, H, W, C) clip, with sinusoidal frame positions added to the
    tokens; residual."""

    def __init__(self, channels: int, num_heads: int = 4,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm = LayerNorm(channels)
        self.attn = SelfAttention(channels, num_heads,
                                  compute_dtype=compute_dtype)

    def forward(self, x):
        b, t, h, w, c = x.shape
        pos = timestep_embedding(torch.arange(t, device=x.device), c)
        if self.compute_dtype is not None:
            pos = pos.to(self.compute_dtype)
        y = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c) + pos[None]
        y = self.attn(self.norm(y))
        return x + y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)


class TinyVideoUNet(nn.Module):
    """Predicts ε for a clip x_t (B, T, H, W, C) given t (B,) and class
    labels (B,); ``dtype`` is the compute dtype of every linear and conv
    over fp32 parameters, and the output is fp32. The input has
    ``out_channels`` channels, as in the JAX module's use."""

    def __init__(self, out_channels: int = 3, base_channels: int = 64,
                 channel_mult: Sequence[int] = (1, 2, 2),
                 num_classes: int = 10, dropout: float = 0.0,
                 time_emb_dim: int = 256, temporal_heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        m = [base_channels * k for k in channel_mult]
        dt = None if dtype == torch.float32 else dtype
        self.dtype = dtype
        self.time_embedding = TimestepEmbedder(time_emb_dim, 256,
                                               compute_dtype=dt)
        self.label_embedding = LabelEmbedder(num_classes, 128, time_emb_dim,
                                             compute_dtype=dt)
        res = lambda cin, cout: ResBlock(cin, cout, time_emb_dim, dropout,
                                         compute_dtype=dt)
        att = lambda c: TransformerBlock(c, time_emb_dim, compute_dtype=dt)
        tatt = lambda c: TemporalAttention(c, temporal_heads,
                                           compute_dtype=dt)
        down = lambda cin, cout: Conv2d(cin, cout, 3, stride=2, same=True,
                                        compute_dtype=dt)

        self.enc0_conv = Conv2d(out_channels, m[0], 3, padding=1,
                                compute_dtype=dt)
        self.enc1_res, self.enc1_att, self.enc1_tatt = (
            res(m[0], m[0]), att(m[0]), tatt(m[0]))
        self.enc2_down = down(m[0], m[1])
        self.enc3_res, self.enc3_att, self.enc3_tatt = (
            res(m[1], m[1]), att(m[1]), tatt(m[1]))
        self.enc4_down = down(m[1], m[2])
        self.enc5_res = res(m[2], m[2])
        self.mid_res1, self.mid_att, self.mid_tatt, self.mid_res2 = (
            res(m[2], m[2]), att(m[2]), tatt(m[2]), res(m[2], m[2]))
        self.dec0_res = res(2 * m[2], m[2])
        self.dec0_up = Upsample(m[2], compute_dtype=dt)
        self.dec1_res, self.dec1_att, self.dec1_tatt = (
            res(m[2] + m[1], m[1]), att(m[1]), tatt(m[1]))
        self.dec1_up = Upsample(m[1], compute_dtype=dt)
        self.dec2_res, self.dec2_att, self.dec2_tatt = (
            res(m[1] + m[0], m[0]), att(m[0]), tatt(m[0]))
        self.tail_norm = GroupNorm(m[0], 16, act="silu")
        self.tail_conv = Conv2d(m[0], out_channels, 3, padding=1,
                                compute_dtype=dt)

    def forward(self, x, t, labels):
        b, nt = x.shape[:2]
        # frames share the clip's (t, label) conditioning
        time = self.time_embedding(t).repeat_interleave(nt, dim=0)
        ctx = self.label_embedding(labels).repeat_interleave(nt, dim=0)
        fold = lambda v: v.reshape(b * nt, *v.shape[2:])
        unfold = lambda v: v.reshape(b, nt, *v.shape[1:])

        def block(name, s):
            s = getattr(self, f"{name}_att")(
                getattr(self, f"{name}_res")(s, time), ctx)
            return fold(getattr(self, f"{name}_tatt")(unfold(s)))

        s = self.enc0_conv(fold(x.to(self.dtype)))
        skips = [block("enc1", s)]
        skips.append(block("enc3", self.enc2_down(skips[-1])))
        skips.append(self.enc5_res(self.enc4_down(skips[-1]), time))

        s = self.mid_res1(skips[-1], time)
        s = fold(self.mid_tatt(unfold(self.mid_att(s, ctx))))
        s = self.mid_res2(s, time)

        cat = lambda a: torch.cat([a, skips.pop()], dim=-1)
        s = self.dec0_up(self.dec0_res(cat(s), time))
        s = self.dec1_up(block("dec1", cat(s)))
        s = block("dec2", cat(s))
        return unfold(self.tail_conv(self.tail_norm(s))).float()
