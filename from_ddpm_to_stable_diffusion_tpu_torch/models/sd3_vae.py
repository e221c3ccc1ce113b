"""SD3 16-channel VAE encoder, decoder and latent format (port of
``models/sd3_vae.py``).

ch = 128, multipliers (1, 2, 4, 4), two res blocks per level in the
encoder and three in the decoder, mid ResNet / attention / ResNet, z = 16;
NHWC, fp32 norm statistics, built on the SD1 port's ``VAEResBlock``,
``VAEAttentionBlock`` and its stride-2 downsample with the asymmetric
(0, 1, 0, 1) pad. :class:`SDVAE` pairs them with the reparameterised
encode (mean + std * noise, the log-variance clamped to [-30, 20]), as
``SD3Inferencer.vae_encode`` does on the serving path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.image import upsample_nearest_2x
from .layers import Conv2d, GroupNorm
from .sd1 import VAEAttentionBlock, VAEResBlock, _Downsample


class SD3LatentFormat:
    scale_factor: float = 1.5305
    shift_factor: float = 0.0609

    @classmethod
    def process_in(cls, latent):
        return (latent - cls.shift_factor) * cls.scale_factor

    @classmethod
    def process_out(cls, latent):
        return (latent / cls.scale_factor) + cls.shift_factor

    # 16-channel latent -> approximate RGB, for cheap previews
    PREVIEW_FACTORS = np.asarray([
        [-0.0645, 0.0177, 0.1052], [0.0028, 0.0312, 0.0650],
        [0.1848, 0.0762, 0.0360], [0.0944, 0.0360, 0.0889],
        [0.0897, 0.0506, -0.0364], [-0.0020, 0.1203, 0.0284],
        [0.0855, 0.0118, 0.0283], [-0.0539, 0.0658, 0.1047],
        [-0.0057, 0.0116, 0.0700], [-0.0412, 0.0281, -0.0039],
        [0.1106, 0.1171, 0.1220], [-0.0248, 0.0682, -0.0481],
        [0.0815, 0.0846, 0.1207], [-0.0120, -0.0055, -0.0867],
        [-0.0749, -0.0634, -0.0456], [-0.1418, -0.1457, -0.1259]],
        dtype=np.float32)

    @classmethod
    def decode_latent_to_preview(cls, x0):
        """(B, H, W, 16) NHWC latent -> uint8 (B, H, W, 3) preview."""
        x0 = torch.as_tensor(x0, dtype=torch.float32)
        img = x0 @ torch.as_tensor(cls.PREVIEW_FACTORS, device=x0.device)
        return ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


class SD3VAEEncoder(nn.Module):
    """Image (B, H, W, 3) in [-1, 1] -> (B, H/8, W/8, 2 z) mean | log_var,
    fp32."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 16):
        super().__init__()
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        self.conv_in = Conv2d(3, ch, 3, padding=1)
        cin = ch
        for i_level, mult in enumerate(ch_mult):
            cout = ch * mult
            for i_block in range(num_res_blocks):
                self.add_module(f"down{i_level}_block{i_block}",
                                VAEResBlock(cin, cout))
                cin = cout
            if i_level != len(ch_mult) - 1:
                self.add_module(f"down{i_level}_downsample",
                                _Downsample(cout))
        self.mid_block1 = VAEResBlock(cin, cin)
        self.mid_attn = VAEAttentionBlock(cin)
        self.mid_block2 = VAEResBlock(cin, cin)
        self.norm_out = GroupNorm(cin, 32, act="silu")
        self.conv_out = Conv2d(cin, 2 * z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for i_level in range(len(self.ch_mult)):
            for i_block in range(self.num_res_blocks):
                h = getattr(self, f"down{i_level}_block{i_block}")(h)
            if i_level != len(self.ch_mult) - 1:
                h = getattr(self, f"down{i_level}_downsample")(h)
        h = self.mid_block2(self.mid_attn(self.mid_block1(h)))
        return self.conv_out(self.norm_out(h)).float()


class SD3VAEDecoder(nn.Module):
    """Latent (B, H/8, W/8, z) -> image (B, H, W, 3) fp32 in about [−1, 1]."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 16,
                 out_channels: int = 3):
        super().__init__()
        self.ch_mult, self.num_res_blocks = tuple(ch_mult), num_res_blocks
        cin = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, cin, 3, padding=1)
        self.mid_block1 = VAEResBlock(cin, cin)
        self.mid_attn = VAEAttentionBlock(cin)
        self.mid_block2 = VAEResBlock(cin, cin)
        for i_level in reversed(range(len(ch_mult))):
            cout = ch * ch_mult[i_level]
            for i_block in range(num_res_blocks + 1):
                self.add_module(f"up{i_level}_block{i_block}",
                                VAEResBlock(cin, cout))
                cin = cout
            if i_level != 0:
                self.add_module(f"up{i_level}_upsample",
                                Conv2d(cout, cout, 3, padding=1))
        self.norm_out = GroupNorm(cin, 32, act="silu")
        self.conv_out = Conv2d(cin, out_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z.to(self.conv_in.weight.dtype))
        h = self.mid_block2(self.mid_attn(self.mid_block1(h)))
        for i_level in reversed(range(len(self.ch_mult))):
            for i_block in range(self.num_res_blocks + 1):
                h = getattr(self, f"up{i_level}_block{i_block}")(h)
            if i_level != 0:
                h = getattr(self, f"up{i_level}_upsample")(
                    upsample_nearest_2x(h))
        return self.conv_out(self.norm_out(h)).float()


class SDVAE(nn.Module):
    """Paired encoder / decoder with the reparameterised encode. The modules
    compute in their weights' dtype (cast the pair for bf16); the JAX
    ``rng`` is ``noise`` (a standard-normal array of the latent's shape) or
    a draw from ``generator``."""

    def __init__(self):
        super().__init__()
        self.encoder = SD3VAEEncoder()
        self.decoder = SD3VAEDecoder()

    def encode(self, image, noise=None,
               generator: Optional[torch.Generator] = None):
        mean, log_var = self.encoder(image).chunk(2, dim=-1)
        std = torch.exp(0.5 * log_var.clamp(-30.0, 20.0))
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
        return mean + std * torch.as_tensor(noise, dtype=mean.dtype,
                                            device=mean.device)

    def decode(self, latent):
        return self.decoder(latent)

    def forward(self, image, noise=None,
                generator: Optional[torch.Generator] = None):
        return self.decode(self.encode(image, noise, generator))
