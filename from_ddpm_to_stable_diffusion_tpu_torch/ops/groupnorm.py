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

import ctypes
import math
from typing import NamedTuple, Optional

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


GN_SMEM = 232448       # bytes of shared memory one block may use (H100)
GN_THREADS = 512       # the block size the plan aims at
GN_PIECES = 8          # pieces a unit is loaded in where it stays resident
GN_SLOT_BYTES = 32768  # a slot of the ring where the rows stream
GN_STAGES = 6          # the ring's slots
GN_MAX_SLOTS = 32      # the kernel tracks each slot's phase in one bit


class GroupNormPlan(NamedTuple):
    """One launch of the K2 kernel (``csrc/groupnorm.cu``): ``grid`` blocks
    of ``threads``, each owning ``units_per_block`` units of at most
    ``rows_per_chunk`` rows (a batch's rows in ``chunks`` chunks), loaded in
    pieces of ``rows_per_piece`` rows into ``stages`` slots of shared
    memory, ``smem`` bytes in all; ``resident``: every piece keeps its own
    slot, so x is read once."""
    threads: int
    chunks: int
    rows_per_chunk: int
    grid: int
    units_per_block: int
    rows_per_piece: int
    stages: int
    resident: bool
    smem: int


def _up16(n: int) -> int:
    return (n + 15) & ~15


def group_norm_plan(batch: int, hw: int, channels: int, groups: int,
                    itemsize: int, n_sm: int = 132) -> GroupNormPlan:
    """The launch plan of the K2 kernel on ``n_sm`` SMs, one block per SM.

    Each thread owns one 16-byte vector of channels and every
    ``threads / (C / vec)``-th row, so the block size is a multiple of the
    vectors per row and of the warp, near ``GN_THREADS``; a piece is a
    multiple of those row residues. Each batch's rows are cut into as many
    chunks as there are blocks per batch; where a block's rows fit its
    shared memory (in at most ``GN_MAX_SLOTS`` pieces, ``GN_PIECES`` a
    unit) they stay there between the statistics and the normalisation,
    else they stream through ``GN_STAGES`` slots of about ``GN_SLOT_BYTES``
    and are read twice. ``smem`` follows the kernel's layout: the slots'
    mbarriers, the groups' (mean, rstd), the affine, each channel's (mean,
    M2), two sums per channel of each thread, the slots.
    """
    vec = 16 // itemsize
    if channels % vec:
        raise ValueError(f"C={channels} is not a multiple of {vec}")
    vpr = channels // vec
    base = vpr * 32 // math.gcd(vpr, 32)
    threads = base * max(1, GN_THREADS // base)
    if threads > 1024:
        raise ValueError(f"C={channels}: needs {threads} threads per block")
    rows_par = threads // vpr
    row_bytes = channels * itemsize
    chunks = max(1, n_sm // batch)
    rpc = -(-hw // chunks)
    chunks = -(-hw // rpc)
    grid = min(n_sm, batch * chunks)
    upb = -(-(batch * chunks) // grid)

    def smem(stages, rpp):
        return (_up16(8 * stages) + _up16(8 * groups)
                + 2 * _up16(8 * channels) + 2 * _up16(4 * threads * vec)
                + stages * rpp * row_bytes)

    rpp = rows_par * -(-(-(-rpc // GN_PIECES)) // rows_par)
    stages = upb * -(-rpc // rpp)
    if stages <= GN_MAX_SLOTS and smem(stages, rpp) <= GN_SMEM:
        return GroupNormPlan(threads, chunks, rpc, grid, upb, rpp, stages,
                             True, smem(stages, rpp))
    rpp = rows_par * max(1, GN_SLOT_BYTES // row_bytes // rows_par)
    stages = GN_STAGES
    while stages and smem(stages, rpp) > GN_SMEM:
        stages -= 1
    if not stages:
        raise ValueError(f"C={channels}: a piece does not fit shared memory")
    return GroupNormPlan(threads, chunks, rpc, grid, upb, rpp, stages, False,
                         smem(stages, rpp))


_plans = {}
_scratch = {}


def _launch_plan(x, dev, b, hw, c, groups):
    """The plan of this shape and dtype on card ``dev``, made once: the plan,
    the scratch floats it needs, its int32 array for the C entry (and its
    address) and the library. Raises where the card cannot hold the grid at
    once (the launch is cooperative)."""
    key = (b, hw, c, groups, x.dtype, dev)
    got = _plans.get(key)
    if got is None:
        bf16 = int(x.dtype == torch.bfloat16)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = group_norm_plan(b, hw, c, groups, x.element_size(), n_sm)
        lib = _build.load()
        per_sm = lib.fdsd_group_norm_blocks_per_sm(bf16, plan.threads,
                                                   plan.smem)
        if per_sm * n_sm < plan.grid:
            raise RuntimeError(
                f"group_norm_cuda: {plan.grid} blocks of {plan.threads} "
                f"threads and {plan.smem} B do not fit {n_sm} SMs at once "
                f"({per_sm} per SM)")
        args = (ctypes.c_int * 13)(
            b, hw, c, groups, bf16, plan.threads, plan.chunks,
            plan.rows_per_chunk, plan.grid, plan.rows_per_piece, plan.stages,
            int(plan.resident), plan.smem)
        got = _plans[key] = (plan, 2 * b * groups * plan.chunks, args,
                             ctypes.cast(args, ctypes.c_void_p).value, lib)
    return got


def _partials(dev, stream, n):
    """The partials' scratch of one stream, at least ``n`` floats: the
    kernels of one stream run one after another, so each call on it reuses
    the same buffer, which every call writes before it reads."""
    buf = _scratch.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = _scratch[(dev, stream)] = torch.empty(
            n, device=torch.device("cuda", dev), dtype=torch.float32)
    return buf


def group_norm_cuda(x, num_groups, scale, bias, eps=1e-5, act=None):
    """The CUDA kernel on a contiguous channels-last (B, ..., C) tensor: one
    cooperative launch per call (see :func:`group_norm_plan`)."""
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
    dev = x.get_device()
    for p in (scale, bias):
        if (p.get_device() != dev or p.dtype != torch.float32
                or p.shape != (c,) or not p.is_contiguous()):
            raise ValueError("scale and bias must be contiguous fp32 (C,) "
                             "tensors on x's device")
    _, n_part, _, args, lib = _launch_plan(x, dev, b, hw, c, num_groups)
    # the raw handle of the current stream, without a Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev)
    y = torch.empty_like(x)
    err = lib.fdsd_group_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        _partials(dev, stream, n_part).data_ptr(), args, eps,
        int(act == "silu"), stream)
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
