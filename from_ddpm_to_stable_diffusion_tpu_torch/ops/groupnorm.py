"""GroupNorm (+ optional fused SiLU) over channels-last activations,
LayerNorm and RMSNorm (port of ``ops/groupnorm.py``).

:func:`group_norm` launches the CUDA kernel (``csrc/groupnorm.cu``) on a
CUDA tensor, always: the JAX package's batch >= 8 / VMEM-fit rule for its
Pallas kernel is a TPU measurement and is not carried over. On a CPU tensor
it runs the plain versions, which follow the JAX package's XLA formulas per
dtype: two-pass fp32 statistics for fp32 input, one-pass E[x²]−E[x]²
(clamped at 0) for bf16 input.

:func:`group_norm` is differentiable through :class:`GroupNormFunction`,
whose backward is :func:`group_norm_bwd_plain`, the port of the JAX
package's ``_fused_bwd``. That backward is XLA code there, not a Pallas
kernel, so plain PyTorch is its counterpart here on every device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build


def _apply_act(out, act):
    if act == "silu":
        return out * torch.sigmoid(out)
    if act is not None:
        raise ValueError(f"unknown act {act!r}")
    return out


def group_norm_plain(x, num_groups, scale, bias, eps=1e-5, act=None):
    """Two-pass fp32 statistics (JAX ``_group_norm_xla``)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), unbiased=False, keepdim=True)
    xhat = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    out = xhat * scale.float() + bias.float()
    return _apply_act(out, act).to(x.dtype)


def group_norm_plain_one_pass(x, num_groups, scale, bias, eps=1e-5,
                              act=None):
    """Per-channel sums over space, then group sums, var = E[x²]−E[x]²
    clamped at 0 (JAX ``_group_norm_xla_lane_aligned``, its bf16 path)."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xf = x.reshape(b, -1, c).float()
    inv_n = 1.0 / (xf.shape[1] * cg)
    gsum = xf.sum(dim=1).reshape(b, num_groups, cg).sum(-1)
    gsq = (xf * xf).sum(dim=1).reshape(b, num_groups, cg).sum(-1)
    mean_g = gsum * inv_n
    var_g = torch.clamp(gsq * inv_n - mean_g * mean_g, min=0.0)
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(cg, dim=-1)
    inv_c = inv_g.repeat_interleave(cg, dim=-1)
    mul = inv_c * scale.float()[None, :]
    add = bias.float()[None, :] - mean_c * mul
    out = xf * mul[:, None, :] + add[:, None, :]
    return _apply_act(out, act).to(x.dtype).reshape(x.shape)


def launch_config(batch: int, hw: int, channels: int, itemsize: int,
                  n_sm: int = 132):
    """(threads, rows_per_chunk, n_chunks) for the kernel's (chunks, B) grid.

    Each thread owns one 16-byte vector of channels, so the block size is a
    multiple of both the vectors per row and the warp size; chunks of rows
    are sized so that the grid has about four blocks per SM.
    """
    vec = 16 // itemsize
    if channels % vec:
        raise ValueError(f"C={channels} is not a multiple of {vec}")
    vpr = channels // vec
    base = vpr * 32 // math.gcd(vpr, 32)
    # the statistics pass keeps (n, mean[vec], M2[vec]) per thread in 48 KB
    max_threads = min(1024, 48 * 1024 // ((2 * vec + 1) * 4))
    if base > max_threads:
        raise ValueError(f"C={channels}: needs {base} threads per block")
    threads = base * max(1, 256 // base)
    rows_par = threads // vpr
    n_chunks = max(1, min(-(-4 * n_sm // batch), -(-hw // rows_par)))
    rows_per_chunk = -(-hw // n_chunks)
    return threads, rows_per_chunk, -(-hw // rows_per_chunk)


def group_norm_cuda(x, num_groups, scale, bias, eps=1e-5, act=None):
    """The CUDA kernel on a contiguous channels-last (B, ..., C) tensor."""
    if not x.is_cuda:
        raise ValueError("group_norm_cuda needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_cuda takes bf16 or fp32, not {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm_cuda needs a contiguous 16-byte-aligned x")
    if act not in (None, "silu"):
        raise ValueError(f"unknown act {act!r}")
    b, c = x.shape[0], x.shape[-1]
    hw = x.numel() // (b * c)
    if c % num_groups:
        raise ValueError(f"C={c} is not a multiple of {num_groups} groups")
    for p in (scale, bias):
        if (p.device != x.device or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError("scale and bias must be contiguous fp32 (C,) "
                             "tensors on x's device")
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    threads, rows, n_chunks = launch_config(b, hw, c, x.element_size(), n_sm)
    lib = _build.load()
    y = torch.empty_like(x)
    part = torch.empty(b * n_chunks * num_groups * 3, device=x.device,
                       dtype=torch.float32)
    stats = torch.empty(b * num_groups * 2, device=x.device,
                        dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fdsd_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        part.data_ptr(), stats.data_ptr(), b, hw, c, num_groups, eps,
        int(act == "silu"), int(x.dtype == torch.bfloat16), threads, rows,
        n_chunks, stream)
    _build.check(err, "fdsd_group_norm")
    group_norm_cuda.launches += 1
    return y


group_norm_cuda.launches = 0


def group_norm_forward(x, num_groups, scale, bias, eps=1e-5, act=None):
    """The kernel on a CUDA tensor, the plain version of x's dtype on CPU."""
    if x.is_cuda:
        return group_norm_cuda(x.contiguous(), num_groups,
                               scale.float().contiguous(),
                               bias.float().contiguous(), eps, act)
    if x.dtype == torch.bfloat16:
        return group_norm_plain_one_pass(x, num_groups, scale, bias, eps, act)
    return group_norm_plain(x, num_groups, scale, bias, eps, act)


def group_norm_bwd_plain(x, scale, bias, dy, num_groups, eps=1e-5, act=None):
    """(dx, dscale, dbias) of :func:`group_norm` (JAX ``_fused_bwd``):
    recomputes one-pass fp32 statistics with per-channel partials, the
    variance clamped at 0, and follows the SiLU chain when ``act='silu'``."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xf = x.reshape(b, -1, c).float()
    n = xf.shape[1] * cg

    def group_mean(v):                    # (B, S, C) -> (B, 1, C)
        g = v.sum(dim=1).reshape(b, num_groups, cg).sum(-1) / n
        return g.repeat_interleave(cg, dim=-1)[:, None, :]

    mean_c = group_mean(xf)
    var_c = group_mean(xf * xf) - mean_c * mean_c
    inv_c = torch.rsqrt(torch.clamp(var_c, min=0.0) + eps)
    xhat = (xf - mean_c) * inv_c
    dyf = dy.reshape(b, -1, c).float()
    if act == "silu":
        z = xhat * scale.float() + bias.float()
        sig = torch.sigmoid(z)
        dyf = dyf * sig * (1.0 + z * (1.0 - sig))
    dscale = (dyf * xhat).sum(dim=(0, 1)).to(scale.dtype)
    dbias = dyf.sum(dim=(0, 1)).to(bias.dtype)
    dxhat = dyf * scale.float()
    dx = inv_c * (dxhat - group_mean(dxhat) - xhat * group_mean(dxhat * xhat))
    return dx.reshape(x.shape).to(x.dtype), dscale, dbias


class GroupNormFunction(torch.autograd.Function):
    """Forward: :func:`group_norm_forward`, saving x, scale and bias.
    Backward: :func:`group_norm_bwd_plain` (the JAX ``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, act)
        return group_norm_forward(x, num_groups, scale, bias, eps, act)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        return (*group_norm_bwd_plain(x, scale, bias, dy, *ctx.cfg),
                None, None, None)


def group_norm(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5,
               act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm over the last (channel) axis of an N...C tensor, fp32
    statistics, output in the input dtype; ``act='silu'`` fuses the SiLU.
    Differentiable in x, scale and bias."""
    if x.shape[-1] % num_groups:
        raise ValueError(f"C={x.shape[-1]} is not a multiple of {num_groups}")
    return GroupNormFunction.apply(x, scale, bias, num_groups, eps, act)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 statistics and affine, output
    in x's dtype; ``scale`` and ``bias`` may each be None."""
    return F.layer_norm(x.float(), x.shape[-1:],
                        None if scale is None else scale.float(),
                        None if bias is None else bias.float(),
                        eps).to(x.dtype)


def rms_norm(x, scale=None, eps: float = 1e-6):
    """RMSNorm over the last axis (the MMDiT's qk-norm, T5's layer norm): no
    mean subtraction, fp32 statistics, output in x's dtype."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if scale is not None:
        out = out * scale.float()
    return out.to(x.dtype)
