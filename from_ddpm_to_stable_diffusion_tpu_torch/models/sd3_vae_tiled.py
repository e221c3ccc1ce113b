"""Streamed (row-strip) SD3 VAE decode with a bounded live set (port of
``models/sd3_vae_tiled.py``).

It runs the port's :class:`.sd3_vae.SD3VAEDecoder` module, parameters and
all, as a stream of row strips whose live set is two whole buffers of the
ladder plus one strip's workspace, so that a batch decodes at once where a
whole-image decode of each image would hold its whole activation ladder:

- The head (``conv_in``, mid res / attention / res) runs whole at latent
  resolution through the decoder's own modules: its attention is global
  over all h·w tokens (K1 at head dim 512 on the card) and its GroupNorms
  take K2.
- Every GroupNorm of the upsampling ladder is two passes: the whole
  buffer's fp32 statistics (mean and E[x²], the variance E[x²] - mean²,
  summed over chunks of rows so that no fp32 copy of the buffer exists), then,
  per strip, the affine and SiLU fused in front of a VALID cuDNN conv.
  In the JAX package these statistics and the strip programs are XLA code
  (``_gn_stats``, ``_strip_conv``), not its Pallas GroupNorm, so the plain
  PyTorch here is their faithful port, not a fallback from K2.
- Buffers carry a 1-pixel zero border. A strip reads its rows with the
  halo, so each conv is VALID and the same arithmetic as the padded
  whole-image conv; the border positions are set to zero after the
  activation, because the whole-image conv zero-pads its input, which
  comes after GroupNorm and SiLU.

The output is fp32 NHWC, the whole-image decode's up to rounding
(``tests/test_torch_sd3_serving.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.image import upsample_nearest_2x
from .sd3_vae import SD3VAEDecoder


def _interior(buf):
    return buf[:, 1:-1, 1:-1, :]


# rows per chunk of the statistics pass: fixed, so that the statistics, and
# with them the output, do not depend on the strip height
STATS_ROWS = 64


def _gn_stats(buf, groups: int, eps: float):
    """Per-channel (B, C) fp32 mean and rstd of the interior of ``buf``
    over groups of channels: mean and E[x²] accumulated in fp32 over chunks
    of :data:`STATS_ROWS` rows, var = E[x²] - mean²."""
    b, hp, wp, c = buf.shape
    h, w, cg = hp - 2, wp - 2, c // groups
    s1 = torch.zeros(b, groups, device=buf.device)
    s2 = torch.zeros(b, groups, device=buf.device)
    for r in range(0, h, STATS_ROWS):
        x = buf[:, 1 + r:1 + min(h, r + STATS_ROWS), 1:-1].float()
        x = x.reshape(b, -1, groups, cg)
        s1 += x.sum(dim=(1, 3))
        s2 += x.square().sum(dim=(1, 3))
    n = h * w * cg
    mean = s1 / n
    rstd = torch.rsqrt(s2 / n - mean.square() + eps)
    return (mean.repeat_interleave(cg, dim=1),
            rstd.repeat_interleave(cg, dim=1))


def _conv_valid(y, conv):
    """The 3x3 (or 1x1) conv of ``conv`` (a port ``Conv2d``), VALID, on an
    NHWC tensor in the conv's dtype."""
    out = F.conv2d(y.permute(0, 3, 1, 2), conv.weight, conv.bias)
    return out.permute(0, 2, 3, 1)


def _new_buffer(like, channels):
    b, hp, wp, _ = like.shape
    return torch.zeros((b, hp, wp, channels), dtype=like.dtype,
                       device=like.device)


def _stream_gn_conv(xbuf, norm, conv, *, strip, act=True, skipbuf=None,
                    skip=None):
    """GroupNorm (``norm``'s affine, SiLU when ``act``) then ``conv``, strip
    by strip, plus the residual from ``skipbuf`` (through the 1x1 ``skip``
    conv if given): a new zero-bordered buffer."""
    b, hp, wp, _ = xbuf.shape
    h, w = hp - 2, wp - 2
    outbuf = _new_buffer(xbuf, conv.out_channels)
    mean, rstd = _gn_stats(xbuf, norm.num_groups, norm.eps)
    mean, rstd = mean[:, None, None, :], rstd[:, None, None, :]
    scale, bias = norm.weight.float(), norm.bias.float()
    cols = torch.arange(wp, device=xbuf.device)
    col_ok = ((cols >= 1) & (cols <= w))[None, None, :, None]
    for r in range(0, h, strip):
        s = min(strip, h - r)
        y = (xbuf[:, r:r + s + 2].float() - mean) * rstd * scale + bias
        if act:
            y = F.silu(y)
        rows = torch.arange(r - 1, r + s + 1, device=xbuf.device)
        row_ok = ((rows >= 0) & (rows < h))[None, :, None, None]
        y = torch.where(row_ok & col_ok, y, 0.0)
        t = _conv_valid(y.to(xbuf.dtype), conv)
        if skipbuf is not None:
            sk = skipbuf[:, r + 1:r + 1 + s, 1:-1]
            t = t + (sk if skip is None else _conv_valid(sk, skip))
        outbuf[:, r + 1:r + 1 + s, 1:-1] = t
    return outbuf


def _stream_plain_conv(xbuf, conv, *, strip):
    """A 3x3 conv with no norm in front (after the upsample: the zero
    border is already the conv's input padding), strip by strip."""
    h = xbuf.shape[1] - 2
    outbuf = _new_buffer(xbuf, conv.out_channels)
    for r in range(0, h, strip):
        s = min(strip, h - r)
        outbuf[:, r + 1:r + 1 + s, 1:-1] = _conv_valid(
            xbuf[:, r:r + s + 2], conv)
    return outbuf


def _stream_res_block(xbuf, block, *, strip):
    """``VAEResBlock`` streamed: GN + SiLU + conv twice, the skip (1x1 conv
    where the channels change) folded into the second conv's strips."""
    h = _stream_gn_conv(xbuf, block.norm1, block.conv1, strip=strip)
    return _stream_gn_conv(h, block.norm2, block.conv2, strip=strip,
                           skipbuf=xbuf, skip=block.skip)


def _upsample_buf(xbuf):
    """Nearest 2x of the interior into a fresh zero-bordered buffer."""
    return F.pad(upsample_nearest_2x(_interior(xbuf)), (0, 0, 1, 1, 1, 1))


def tiled_decode(decoder: SD3VAEDecoder, z: torch.Tensor, *,
                 strip: int = 128,
                 image_batch: Optional[int] = None) -> torch.Tensor:
    """``decoder(z)`` with a bounded live set: z (B, h, w, 16), already
    through ``SD3LatentFormat.process_out``, on the decoder's device.
    ``strip``: output rows per streamed conv. ``image_batch``: decode in
    sub-batches of this many images. Returns fp32 NHWC, equal to the
    whole-image decode up to rounding."""
    if image_batch and z.shape[0] > image_batch:
        return torch.cat([tiled_decode(decoder, z[i:i + image_batch],
                                       strip=strip)
                          for i in range(0, z.shape[0], image_batch)])
    d = decoder
    h = d.conv_in(z.to(d.conv_in.weight.dtype))
    h = d.mid_block2(d.mid_attn(d.mid_block1(h)))
    buf = F.pad(h, (0, 0, 1, 1, 1, 1))
    for i_level in reversed(range(len(d.ch_mult))):
        for i_block in range(d.num_res_blocks + 1):
            buf = _stream_res_block(
                buf, getattr(d, f"up{i_level}_block{i_block}"), strip=strip)
        if i_level != 0:
            buf = _stream_plain_conv(_upsample_buf(buf),
                                     getattr(d, f"up{i_level}_upsample"),
                                     strip=strip)
    out = _stream_gn_conv(buf, d.norm_out, d.conv_out, strip=strip)
    return _interior(out).float()
