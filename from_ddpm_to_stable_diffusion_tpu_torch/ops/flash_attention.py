"""Flash-attention forward over (B, H, L, D) (port of ``ops/flash_attention.py``).

On CUDA tensors :func:`flash_attention_forward` launches the kernel of
``csrc/flash_attention.cu``, which stands in for both Pallas forward bodies
of the JAX package (``_fwd_kernel_wide`` and ``_fwd_kernel``). On CPU
tensors it runs :func:`flash_attention_plain`. Same contract as the JAX
forward: ``out`` in the input dtype with shape (B, H, Lq, D), ``lse`` fp32
with shape (B, H, Lq).

The kernel reads q, k and v through their strides (only the head dim must
be contiguous), so the fused-QKV projection's q|k|v column slices go in
without a copy, and it writes ``out`` into (B, Lq, H, D) memory returned as
a (B, H, Lq, D) view, so merging heads afterwards is free.

Not ported yet (see ROADMAP.md): additive bias, causal and segment-id
masks, and the backward kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# head dims the kernel is instantiated for: padded to 48, 80 or 512
_KERNEL_HEAD_DIMS = (40, 48, 72, 80, 512)


def flash_attention_plain(q, k, v, scale: Optional[float] = None):
    """(out, lse) in plain PyTorch: fp32 logits and softmax statistics, the
    probabilities cast to v's dtype before the PV product, as the kernels do."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _check_operand(name, x, like):
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(f"{name} must be on {like.device} in {like.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]):
        raise ValueError(f"{name}: the head dim must be contiguous and the "
                         f"other strides multiples of 8, got {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def flash_attention_cuda(q, k, v, scale: Optional[float] = None):
    """The CUDA kernel: (out, lse) for bf16 (B, H, L, D) CUDA tensors."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, L, D)")
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernel takes bf16, not {q.dtype}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape or lk == 0:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"head dim {d}: the kernel takes "
                                  f"{_KERNEL_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q)
    if scale is None:
        scale = d ** -0.5
    out = torch.empty((b, lq, h, d), device=q.device,
                      dtype=q.dtype).transpose(1, 2)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    strides = (ctypes.c_longlong * 12)(
        *(s for x in (q, k, v, out) for s in x.stride()[:3]))
    lib = _build.load()
    err = lib.fdsd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, lq, lk, d, ctypes.cast(strides, ctypes.c_void_p),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fdsd_flash_fwd")
    flash_attention_cuda.launches += 1
    return out, lse


flash_attention_cuda.launches = 0


def flash_attention_forward(q, k, v, scale: Optional[float] = None):
    """(out, lse): the kernel on CUDA tensors, the plain version on CPU."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale)


def flash_attention(q, k, v, bias=None, segment_ids=None,
                    causal: bool = False, scale: Optional[float] = None):
    """Flash attention over (B, H, L, D); returns (B, H, Lq, D)."""
    if bias is not None or segment_ids is not None or causal:
        raise NotImplementedError(
            "bias, segment_ids and causal masks are not ported yet")
    return flash_attention_forward(q, k, v, scale)[0]
