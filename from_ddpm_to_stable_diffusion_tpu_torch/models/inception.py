"""InceptionV3 pool3 feature extractor, the canonical FID featurizer (port
of ``models/inception.py``).

pytorch-fid's "FID Inception" variant of torchvision's InceptionV3: 299^2
input, 2048-d pool3 output, NHWC, inference only. Its quirks, kept:
- the branch_pool average pools exclude padding (count_include_pad=False);
- the LAST InceptionE (Mixed_7c) max-pools its pool branch (3 x 3, stride
  1, padding 1);
- inputs in [0, 1] are scaled to [-1, 1]; the features are the mean over H
  and W.

The BatchNorms are folded into a per-channel affine at import time
(``io/weights_inception.py``), so each :class:`BasicConv2d` is conv (no
bias) -> affine -> relu. Its affine is the module's own ``weight`` and
``bias``: the Flax ``scale`` leaf reaches it through ``io/from_jax.py``'s
renames, ``import_inception_fid``'s ``bn_scale`` through its rules, and
``jax_params_from_module`` turns it back into ``scale``. The convolutions
are cuDNN's (XLA's in the JAX package); on the card fp32 convolutions use
TF32 unless ``torch.backends.cudnn.allow_tf32`` is off (torch's default is
on).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


def _nchw(fn, x, *args, **kw):
    """``fn`` (a torch pool or resize on NCHW) applied to NHWC ``x``."""
    return fn(x.permute(0, 3, 1, 2), *args, **kw).permute(0, 2, 3, 1)


class BasicConv2d(nn.Module):
    """conv (no bias) + folded-BatchNorm affine + relu. ``padding`` is
    (pad H, pad W), each symmetric."""

    def __init__(self, in_channels: int, features: int,
                 kernel: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1),
                 padding: Sequence[int] = (0, 0),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(in_channels, features, tuple(kernel),
                           stride=tuple(strides), padding=tuple(padding),
                           bias=False, compute_dtype=compute_dtype)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x * self.weight.to(x.dtype) + self.bias.to(x.dtype))


def _avg_pool_3x3(x):
    # FID variant: padding excluded from the divisor
    return _nchw(F.avg_pool2d, x, 3, stride=1, padding=1,
                 count_include_pad=False)


def _max_pool(x, window=3, stride=2):
    return _nchw(F.max_pool2d, x, window, stride=stride)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, dt = in_channels, dict(compute_dtype=compute_dtype)
        self.branch1x1 = BasicConv2d(c, 64, (1, 1), **dt)
        self.branch5x5_1 = BasicConv2d(c, 48, (1, 1), **dt)
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2), **dt)
        self.branch3x3dbl_1 = BasicConv2d(c, 64, (1, 1), **dt)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1),
                                          **dt)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1),
                                          **dt)
        self.branch_pool = BasicConv2d(c, pool_features, (1, 1), **dt)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3(x))
        return torch.cat([b1, b5, bd, bp], dim=-1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, dt = in_channels, dict(compute_dtype=compute_dtype)
        self.branch3x3 = BasicConv2d(c, 384, (3, 3), strides=(2, 2), **dt)
        self.branch3x3dbl_1 = BasicConv2d(c, 64, (1, 1), **dt)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1),
                                          **dt)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), strides=(2, 2),
                                          **dt)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=-1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, c7, dt = in_channels, channels_7x7, dict(compute_dtype=compute_dtype)
        h_pad, v_pad = (0, 3), (3, 0)   # 1x7, 7x1
        self.branch1x1 = BasicConv2d(c, 192, (1, 1), **dt)
        self.branch7x7_1 = BasicConv2d(c, c7, (1, 1), **dt)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=h_pad, **dt)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=v_pad, **dt)
        self.branch7x7dbl_1 = BasicConv2d(c, c7, (1, 1), **dt)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=v_pad, **dt)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=h_pad, **dt)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=v_pad, **dt)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=h_pad,
                                          **dt)
        self.branch_pool = BasicConv2d(c, 192, (1, 1), **dt)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3(x))
        return torch.cat([b1, b7, bd, bp], dim=-1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, dt = in_channels, dict(compute_dtype=compute_dtype)
        self.branch3x3_1 = BasicConv2d(c, 192, (1, 1), **dt)
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), strides=(2, 2), **dt)
        self.branch7x7x3_1 = BasicConv2d(c, 192, (1, 1), **dt)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3),
                                         **dt)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0),
                                         **dt)
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), strides=(2, 2),
                                         **dt)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=-1)


class InceptionE(nn.Module):
    """``pool="max"`` in Mixed_7c (the last): the FID quirk."""

    def __init__(self, in_channels: int, pool: str = "avg",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if pool not in ("avg", "max"):
            raise ValueError(f"pool must be avg|max: {pool}")
        self.pool = pool
        c, dt = in_channels, dict(compute_dtype=compute_dtype)
        h_pad, v_pad = (0, 1), (1, 0)
        self.branch1x1 = BasicConv2d(c, 320, (1, 1), **dt)
        self.branch3x3_1 = BasicConv2d(c, 384, (1, 1), **dt)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=h_pad, **dt)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=v_pad, **dt)
        self.branch3x3dbl_1 = BasicConv2d(c, 448, (1, 1), **dt)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1),
                                          **dt)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=h_pad,
                                           **dt)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=v_pad,
                                           **dt)
        self.branch_pool = BasicConv2d(c, 192, (1, 1), **dt)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=-1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=-1)
        if self.pool == "max":
            pooled = _nchw(F.max_pool2d, x, 3, stride=1, padding=1)
        else:
            pooled = _avg_pool_3x3(x)
        bp = self.branch_pool(pooled)
        return torch.cat([b1, b3, bd, bp], dim=-1)


class InceptionV3FID(nn.Module):
    """(B, 299, 299, 3) in [0, 1] -> (B, 2048) pool3 features."""

    def __init__(self, normalize_input: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.normalize_input = normalize_input
        dt = dict(compute_dtype=None if dtype == torch.float32 else dtype)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), strides=(2, 2), **dt)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3), **dt)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1), **dt)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1), **dt)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3), **dt)
        self.Mixed_5b = InceptionA(192, 32, **dt)
        self.Mixed_5c = InceptionA(256, 64, **dt)
        self.Mixed_5d = InceptionA(288, 64, **dt)
        self.Mixed_6a = InceptionB(288, **dt)
        self.Mixed_6b = InceptionC(768, 128, **dt)
        self.Mixed_6c = InceptionC(768, 160, **dt)
        self.Mixed_6d = InceptionC(768, 160, **dt)
        self.Mixed_6e = InceptionC(768, 192, **dt)
        self.Mixed_7a = InceptionD(768, **dt)
        self.Mixed_7b = InceptionE(1280, **dt)
        self.Mixed_7c = InceptionE(2048, pool="max", **dt)

    def forward(self, x):
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = _max_pool(self.Conv2d_2b_3x3(x))
        x = self.Conv2d_3b_1x1(x)
        x = _max_pool(self.Conv2d_4a_3x3(x))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(1, 2))   # adaptive avg pool to 1x1


def resize_for_fid(images: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of (B, H, W, 3) images to 299^2 in fp32, at half-pixel
    centres (align_corners=False) and antialiased when it downsamples: what
    the JAX package's ``jax.image.resize(method="bilinear")`` computes. Its
    docstring cites pytorch-fid's ``F.interpolate`` contract, which does not
    antialias: from 512^2 the two differ by up to ~0.5 (ROADMAP.md, faults of
    the reference); the port follows the JAX package."""
    return _nchw(F.interpolate, images.float(), size=(299, 299),
                 mode="bilinear", align_corners=False, antialias=True)
