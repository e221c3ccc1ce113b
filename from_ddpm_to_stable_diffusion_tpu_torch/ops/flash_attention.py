"""Flash attention over (B, H, L, D), forward and backward, and the
position-masked forward and backward with the split-KV joint attention built
on them (port of ``ops/flash_attention.py``).

Forward: on CUDA tensors :func:`flash_attention_forward` launches the kernel
of ``csrc/flash_attention.cu``, which stands in for both Pallas forward
bodies of the JAX package (``_fwd_kernel_wide`` and ``_fwd_kernel``). On CPU
tensors it runs :func:`flash_attention_plain`. Same contract as the JAX
forward: ``out`` in the input dtype with shape (B, H, Lq, D), ``lse`` fp32
with shape (B, H, Lq).

Backward: :func:`flash_attention_backward` launches the two kernels of
``csrc/flash_attention_bwd.cu`` (dq, and dk with dv; the Pallas
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``) on CUDA tensors and runs
:func:`flash_attention_bwd_plain` on CPU tensors. Both recompute the
probabilities under the forward's saved lse; delta = Σ dO·out is a plain
fp32 reduction, as the JAX package computes it in XLA.
:func:`flash_attention` is differentiable through :class:`FlashAttention`.

The kernels read q, k, v and dO through their strides (only the head dim
must be contiguous), so the fused-QKV projection's q|k|v column slices go in
without a copy, and they write ``out``, dq, dk and dv into (B, L, H, D)
memory returned as (B, H, L, D) views, so merging heads afterwards is free.

Position-masked forward: :func:`flash_attention_pos` masks by global
position (two offset segments per side, ``valid_len``, causal, the ragged
key tail) and returns (out, lse); on CUDA tensors it launches the kernel of
``csrc/flash_attention_pos.cu`` (the Pallas ``_fwd_kernel_pos``), on CPU
tensors :func:`flash_attention_pos_plain`. Position-masked backward:
:func:`flash_bwd_pos` gives (dq, dk, dv) of one query block against one key
block under a caller-supplied *global* lse and delta, with the same masks;
on CUDA tensors the two kernels of ``csrc/flash_attention_pos_bwd.cu`` (the
Pallas ``_bwd_dq_kernel_pos`` and ``_bwd_dkv_kernel_pos``), on CPU tensors
:func:`flash_bwd_pos_plain`. :func:`joint_flash_attention` is the MMDiT's
attention over [context | x] without concatenation: four position-masked
calls merged exactly through their log-sum-exps by
:func:`merge_attention_partials`, and in the backward four
:func:`flash_bwd_pos` calls under the merged lse whose partial gradients
add up (:class:`JointFlashAttention`).

Not ported yet (see ROADMAP.md): the additive bias, causal and segment-id
masks of :func:`flash_attention`, forward and backward (B2).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# head dims the forward kernel is instantiated for: padded to 48, 80, 128
# or 512; the backward kernels take head dim 128 (tiny-SD's UNet)
_KERNEL_HEAD_DIMS = (40, 48, 72, 80, 128, 512)
_BWD_HEAD_DIMS = (128,)
_POS_HEAD_DIMS = (64, 128)
NEG_INF = -1e30   # lse of a row with no visible key


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


def flash_attention_bwd_plain(q, k, v, out, lse, g,
                              scale: Optional[float] = None):
    """(dq, dk, dv) in plain PyTorch, the kernels' contract: P rebuilt in
    fp32 as exp(scale·QKᵀ − lse), delta = Σ_d dO·out in fp32, and P and dS
    cast to the input dtype before the products that take them."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse[..., None])
    delta = (gf * out.float()).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), gf)
    ds = (p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta)).to(q.dtype)
    dq = torch.matmul(ds.float(), kf) * scale
    dk = torch.matmul(ds.float().transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operand(name, x, like):
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(f"{name} must be on {like.device} in {like.dtype}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]):
        raise ValueError(f"{name}: the head dim must be contiguous and the "
                         f"other strides multiples of 8, got {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check_qkv(q, k, v, fn, head_dims):
    """(b, h, lq, lk, d) after the checks every kernel wrapper makes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, L, D)")
    if not q.is_cuda:
        raise ValueError(f"{fn} needs CUDA tensors")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernels take bf16, not {q.dtype}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape or lk == 0:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if d not in head_dims:
        raise NotImplementedError(f"head dim {d}: {fn} takes {head_dims}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q)
    return b, h, lq, lk, d


def _blhd(like, n):
    """Empty (B, H, n, D) view of (B, n, H, D) memory."""
    b, h, _, d = like.shape
    return torch.empty((b, n, h, d), device=like.device,
                       dtype=like.dtype).transpose(1, 2)


def _strides(*xs):
    return (ctypes.c_longlong * (3 * len(xs)))(
        *(s for x in xs for s in x.stride()[:3]))


def flash_attention_cuda(q, k, v, scale: Optional[float] = None):
    """The CUDA kernel: (out, lse) for bf16 (B, H, L, D) CUDA tensors."""
    b, h, lq, lk, d = _check_qkv(q, k, v, "flash_attention_cuda",
                                 _KERNEL_HEAD_DIMS)
    if scale is None:
        scale = d ** -0.5
    out = _blhd(q, lq)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    strides = _strides(q, k, v, out)
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


def _check_bwd(q, k, v, g, lse, delta, head_dims=_BWD_HEAD_DIMS):
    dims = _check_qkv(q, k, v, "the flash backward kernels", head_dims)
    _check_operand("dO", g, q)
    if g.shape != q.shape:
        raise ValueError(f"dO {tuple(g.shape)} must be {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != q.shape[:3] or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 (B, H, Lq)")
    return dims


def flash_attention_bwd_dq_cuda(q, k, v, g, lse, delta,
                                scale: Optional[float] = None):
    """K3: dq from bf16 CUDA q, k, v, dO (= ``g``) and fp32 (B, H, Lq)
    ``lse`` and ``delta`` = Σ_d dO·out."""
    b, h, lq, lk, d = _check_bwd(q, k, v, g, lse, delta)
    scale = d ** -0.5 if scale is None else scale
    dq = _blhd(q, lq)
    strides = _strides(q, k, v, g, dq)
    err = _build.load().fdsd_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, lq, lk, d,
        ctypes.cast(strides, ctypes.c_void_p), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fdsd_flash_bwd_dq")
    flash_attention_bwd_dq_cuda.launches += 1
    return dq


def flash_attention_bwd_dkv_cuda(q, k, v, g, lse, delta,
                                 scale: Optional[float] = None):
    """K4: (dk, dv) from the inputs of :func:`flash_attention_bwd_dq_cuda`."""
    b, h, lq, lk, d = _check_bwd(q, k, v, g, lse, delta)
    scale = d ** -0.5 if scale is None else scale
    dk, dv = _blhd(k, lk), _blhd(v, lk)
    strides = _strides(q, k, v, g, dk, dv)
    err = _build.load().fdsd_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        lq, lk, d, ctypes.cast(strides, ctypes.c_void_p), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fdsd_flash_bwd_dkv")
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dkv_cuda.launches = 0


def _kernel_operand(g, dtype):
    """``g`` as the kernels can read it: in ``dtype``, copied only when its
    head dim is not contiguous, another stride is not a multiple of 8 or it
    is not 16-byte aligned."""
    g = g.to(dtype)
    if (g.stride(-1) != 1 or any(s % 8 for s in g.stride()[:-1])
            or g.data_ptr() % 16):
        g = g.contiguous()
    return g


def flash_attention_bwd_cuda(q, k, v, out, lse, g,
                             scale: Optional[float] = None):
    """(dq, dk, dv) for bf16 CUDA tensors through K3 and K4, with ``out``
    and ``lse`` from :func:`flash_attention_cuda` and ``g`` = dO. A dO whose
    head dim is not contiguous (or whose other strides are not multiples
    of 8) is copied first; the kernels read it through its strides
    otherwise. delta = Σ_d dO·out is a plain fp32 reduction."""
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} must be {tuple(q.shape)}")
    g = _kernel_operand(g, q.dtype)
    delta = (g.float() * out.float()).sum(-1)
    lse = lse.contiguous()
    dq = flash_attention_bwd_dq_cuda(q, k, v, g, lse, delta, scale)
    return (dq, *flash_attention_bwd_dkv_cuda(q, k, v, g, lse, delta, scale))


def flash_attention_backward(q, k, v, out, lse, g,
                             scale: Optional[float] = None):
    """(dq, dk, dv): the kernels on CUDA tensors, the plain version on CPU."""
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, out, lse, g, scale)
    return flash_attention_bwd_plain(q, k, v, out, lse, g, scale)


class FlashAttention(torch.autograd.Function):
    """Forward: :func:`flash_attention_forward`, saving q, k, v, out, lse.
    Backward: :func:`flash_attention_backward` (the JAX ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, lse, g, ctx.scale),
                None)


def flash_attention(q, k, v, bias=None, segment_ids=None,
                    causal: bool = False, scale: Optional[float] = None):
    """Flash attention over (B, H, L, D); returns (B, H, Lq, D).
    Differentiable in q, k and v."""
    if bias is not None or segment_ids is not None or causal:
        raise NotImplementedError(
            "bias, segment_ids and causal masks are not ported yet")
    return FlashAttention.apply(q, k, v, scale)


# --------------------------------------------------------------------------
# Position-masked forward and backward, and the split-KV joint attention
# --------------------------------------------------------------------------
def _positions(n: int, offsets, seg: int):
    """Global positions of local indices 0..n-1: ``offsets[0] + idx`` below
    ``seg``, ``offsets[1] + idx - seg`` from it on."""
    idx = torch.arange(n, device=offsets.device)
    return torch.where(idx < seg, offsets[0] + idx, offsets[1] + (idx - seg))


def _pos_args(q, k, scale, seg_q, seg_k, stability):
    if stability not in ("online", "bounded"):
        raise ValueError(f"stability must be online|bounded: {stability}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    seg_q = q.shape[2] if seg_q is None else int(seg_q)
    seg_k = k.shape[2] if seg_k is None else int(seg_k)
    return scale, seg_q, seg_k


def _visible(lq, lk, q_offsets, kv_offsets, seg_q, seg_k, causal, valid_len):
    """(Lq, Lk) bool: which key each query sees, from explicit positions."""
    col_pos = _positions(lk, kv_offsets, seg_k)
    visible = torch.ones((lq, lk), dtype=torch.bool, device=col_pos.device)
    if valid_len is not None:
        visible &= (col_pos < valid_len)[None, :]
    if causal:
        row_pos = _positions(lq, q_offsets, seg_q)
        visible &= col_pos[None, :] <= row_pos[:, None]
    return visible


def flash_attention_pos_plain(q, k, v, q_offsets, kv_offsets, *,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              seg_q: Optional[int] = None,
                              seg_k: Optional[int] = None,
                              valid_len: Optional[int] = None,
                              stability: str = "online"):
    """(out, lse) of :func:`flash_attention_pos` in plain PyTorch: explicit
    positions and mask, fp32 logits and softmax, the probabilities cast to
    v's dtype before the PV product. A row with no visible key gives
    out = 0 and lse = -1e30. Both stabilities compute the same function, so
    ``stability`` is only validated."""
    scale, seg_q, seg_k = _pos_args(q, k, scale, seg_q, seg_k, stability)
    lq, lk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    visible = _visible(lq, lk, q_offsets, kv_offsets, seg_q, seg_k, causal,
                       valid_len)
    s = s.masked_fill(~visible, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * visible
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / safe_l
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF),
                      m + torch.log(safe_l))
    return out.to(q.dtype), lse.squeeze(-1)


def _check_pos(q, scale, q_offsets, kv_offsets):
    if not scale > 0:
        raise ValueError(f"scale must be positive, got {scale}")
    for name, off in (("q_offsets", q_offsets), ("kv_offsets", kv_offsets)):
        if (off.device != q.device or off.dtype != torch.int32
                or off.shape != (2,) or not off.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 (2,) tensor "
                             f"on {q.device}")


def flash_attention_pos_cuda(q, k, v, q_offsets, kv_offsets, *,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             seg_q: Optional[int] = None,
                             seg_k: Optional[int] = None,
                             valid_len: Optional[int] = None,
                             stability: str = "online"):
    """K5: (out, lse) for bf16 (B, H, L, D) CUDA tensors, D 64 or 128. The
    offsets are int32 (2,) tensors on q's device; the kernel reads them, so
    nothing waits for the host."""
    b, h, lq, lk, d = _check_qkv(q, k, v, "flash_attention_pos_cuda",
                                 _POS_HEAD_DIMS)
    scale, seg_q, seg_k = _pos_args(q, k, scale, seg_q, seg_k, stability)
    _check_pos(q, scale, q_offsets, kv_offsets)
    out = _blhd(q, lq)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    strides = _strides(q, k, v, out)
    err = _build.load().fdsd_flash_fwd_pos(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), q_offsets.data_ptr(), kv_offsets.data_ptr(), b, h,
        lq, lk, d, ctypes.cast(strides, ctypes.c_void_p), scale, seg_q, seg_k,
        0 if valid_len is None else int(valid_len), int(valid_len is not None),
        int(bool(causal)), int(stability == "bounded"),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fdsd_flash_fwd_pos")
    flash_attention_pos_cuda.launches += 1
    return out, lse


flash_attention_pos_cuda.launches = 0


def flash_attention_pos(q, k, v, q_offsets, kv_offsets, **kw):
    """Flash attention with global-position masking: (out, lse).

    q (B, H, Lq, D) and k, v (B, H, Lk, D) are local blocks of a longer
    sequence; ``q_offsets`` / ``kv_offsets`` are int32 (2,) tensors with the
    global offsets of the two contiguous segments each block is made of
    (boundary at local index ``seg_q`` / ``seg_k``; the default is one
    span). Masked: keys at a position >= ``valid_len`` (if given), and keys
    after the query's position when ``causal``. lse is fp32 (B, H, Lq); a
    fully masked row gives lse = -1e30 and out = 0. ``stability``:
    "online" keeps a running max, "bounded" a fixed max of 0 (exact while
    |scale*q.k| stays inside the fp32 exp range, as qk-norm guarantees).
    Not differentiable by itself (see :func:`flash_bwd_pos`). The kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if q.is_cuda:
        return flash_attention_pos_cuda(q, k, v, q_offsets, kv_offsets, **kw)
    return flash_attention_pos_plain(q, k, v, q_offsets, kv_offsets, **kw)


def flash_bwd_pos_plain(q, k, v, g, lse, delta, q_offsets, kv_offsets, *,
                        causal: bool = False, scale: Optional[float] = None,
                        seg_q: Optional[int] = None,
                        seg_k: Optional[int] = None,
                        valid_len: Optional[int] = None):
    """(dq, dk, dv) of :func:`flash_bwd_pos` in plain PyTorch: explicit
    positions and mask, P = exp(scale·QKᵀ − lse) in fp32 where the key is
    visible and 0 elsewhere (selected, so a row whose lse is -1e30 stays
    finite), dS = P·(dO·Vᵀ − delta), and P and dS cast to the input dtype
    before the products that take them, as the kernels do."""
    scale, seg_q, seg_k = _pos_args(q, k, scale, seg_q, seg_k, "online")
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    visible = _visible(q.shape[2], k.shape[2], q_offsets, kv_offsets, seg_q,
                       seg_k, causal, valid_len)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(visible, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _pos_bwd_args(q, k, v, g, lse, delta, q_offsets, kv_offsets, scale, seg_q,
                  seg_k):
    dims = _check_bwd(q, k, v, g, lse, delta, _POS_HEAD_DIMS)
    scale, seg_q, seg_k = _pos_args(q, k, scale, seg_q, seg_k, "online")
    _check_pos(q, scale, q_offsets, kv_offsets)
    return dims, scale, seg_q, seg_k


def flash_bwd_pos_dq_cuda(q, k, v, g, lse, delta, q_offsets, kv_offsets, *,
                          causal: bool = False, scale: Optional[float] = None,
                          seg_q: Optional[int] = None,
                          seg_k: Optional[int] = None,
                          valid_len: Optional[int] = None):
    """K6: dq of :func:`flash_bwd_pos` for bf16 (B, H, L, D) CUDA tensors,
    D 64 or 128; ``lse`` and ``delta`` contiguous fp32 (B, H, Lq), the
    offsets int32 (2,) tensors on q's device."""
    (b, h, lq, lk, d), scale, seg_q, seg_k = _pos_bwd_args(
        q, k, v, g, lse, delta, q_offsets, kv_offsets, scale, seg_q, seg_k)
    dq = _blhd(q, lq)
    strides = _strides(q, k, v, g, dq)
    err = _build.load().fdsd_flash_bwd_pos_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), q_offsets.data_ptr(),
        kv_offsets.data_ptr(), b, h, lq, lk, d,
        ctypes.cast(strides, ctypes.c_void_p), scale, seg_q, seg_k,
        0 if valid_len is None else int(valid_len), int(valid_len is not None),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fdsd_flash_bwd_pos_dq")
    flash_bwd_pos_dq_cuda.launches += 1
    return dq


def flash_bwd_pos_dkv_cuda(q, k, v, g, lse, delta, q_offsets, kv_offsets, *,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           seg_q: Optional[int] = None,
                           seg_k: Optional[int] = None,
                           valid_len: Optional[int] = None):
    """K7: (dk, dv) from the inputs of :func:`flash_bwd_pos_dq_cuda`."""
    (b, h, lq, lk, d), scale, seg_q, seg_k = _pos_bwd_args(
        q, k, v, g, lse, delta, q_offsets, kv_offsets, scale, seg_q, seg_k)
    dk, dv = _blhd(k, lk), _blhd(v, lk)
    strides = _strides(q, k, v, g, dk, dv)
    err = _build.load().fdsd_flash_bwd_pos_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        q_offsets.data_ptr(), kv_offsets.data_ptr(), b, h, lq, lk, d,
        ctypes.cast(strides, ctypes.c_void_p), scale, seg_q, seg_k,
        0 if valid_len is None else int(valid_len), int(valid_len is not None),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "fdsd_flash_bwd_pos_dkv")
    flash_bwd_pos_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_pos_dq_cuda.launches = 0
flash_bwd_pos_dkv_cuda.launches = 0


def flash_bwd_pos(q, k, v, g, lse, delta, q_offsets, kv_offsets, **kw):
    """(dq, dk, dv) of a local block of queries against a local block of
    keys under the *global* softmax: ``lse`` is the log-sum-exp (B, H, Lq)
    fp32 of the merged forward over every key block, ``delta`` = Σ_d dO·out
    (B, H, Lq) fp32 with the merged ``out``, ``g`` = dO. Masks, offsets,
    ``seg_q`` / ``seg_k``, ``valid_len`` and ``causal`` as in
    :func:`flash_attention_pos` (the backward is the same function for both
    stabilities). The contributions of several key blocks add up: dq over
    the key blocks a query block saw, dk and dv over the query blocks that
    saw a key block. The kernels on CUDA tensors (dO is copied only when
    they cannot read it through its strides), the plain version on CPU
    tensors."""
    if not q.is_cuda:
        return flash_bwd_pos_plain(q, k, v, g, lse, delta, q_offsets,
                                   kv_offsets, **kw)
    g = _kernel_operand(g, q.dtype)
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = flash_bwd_pos_dq_cuda(q, k, v, g, lse, delta, q_offsets, kv_offsets,
                               **kw)
    return (dq, *flash_bwd_pos_dkv_cuda(q, k, v, g, lse, delta, q_offsets,
                                        kv_offsets, **kw))


def merge_attention_partials(o1, lse1, o2, lse2):
    """Combine two attention partials over disjoint key sets exactly,
    through their log-sum-exps: (out, lse)."""
    m = torch.maximum(lse1, lse2)
    w1, w2 = torch.exp(lse1 - m), torch.exp(lse2 - m)
    denom = w1 + w2
    out = (o1 * (w1 / denom)[..., None].to(o1.dtype)
           + o2 * (w2 / denom)[..., None].to(o2.dtype))
    return out, m + torch.log(denom)


class JointFlashAttention(torch.autograd.Function):
    """Forward of :func:`joint_flash_attention`, saving q, k, v of both
    streams and both merged outputs and log-sum-exps. Backward (the JAX
    ``_joint_vjp_bwd``): each of the four partials' :func:`flash_bwd_pos`
    runs under the merged lse and delta = Σ_d dO·out of its query stream;
    the two partial gradients of each input, in the input dtype, are added
    in fp32 and rounded once more."""

    @staticmethod
    def forward(ctx, qc, kc, vc, qx, kx, vx, scale, stability):
        z = torch.zeros(2, dtype=torch.int32, device=qc.device)
        f = lambda q, k, v: flash_attention_pos(q, k, v, z, z, scale=scale,
                                                stability=stability)
        o_c, lse_c = merge_attention_partials(*f(qc, kc, vc), *f(qc, kx, vx))
        o_x, lse_x = merge_attention_partials(*f(qx, kc, vc), *f(qx, kx, vx))
        ctx.save_for_backward(qc, kc, vc, qx, kx, vx, o_c, o_x, lse_c, lse_x)
        ctx.scale = scale
        return o_c, o_x

    @staticmethod
    def backward(ctx, g_c, g_x):
        qc, kc, vc, qx, kx, vx, o_c, o_x, lse_c, lse_x = ctx.saved_tensors
        z = torch.zeros(2, dtype=torch.int32, device=qc.device)
        bwd = lambda q, k, v, g, lse, delta: flash_bwd_pos(
            q, k, v, g, lse, delta, z, z, scale=ctx.scale)
        delta_c = (g_c.float() * o_c.float()).sum(-1)
        delta_x = (g_x.float() * o_x.float()).sum(-1)
        dqc1, dkc1, dvc1 = bwd(qc, kc, vc, g_c, lse_c, delta_c)
        dqc2, dkx1, dvx1 = bwd(qc, kx, vx, g_c, lse_c, delta_c)
        dqx1, dkc2, dvc2 = bwd(qx, kc, vc, g_x, lse_x, delta_x)
        dqx2, dkx2, dvx2 = bwd(qx, kx, vx, g_x, lse_x, delta_x)
        add = lambda a, b: (a.float() + b.float()).to(a.dtype)
        return (add(dqc1, dqc2), add(dkc1, dkc2), add(dvc1, dvc2),
                add(dqx1, dqx2), add(dkx1, dkx2), add(dvx1, dvx2), None, None)


def joint_flash_attention(qc, kc, vc, qx, kx, vx,
                          scale: Optional[float] = None,
                          stability: str = "online"):
    """Joint attention over [context | x] without concatenation or padding.
    All tensors (B, H, L, D); returns (out_c, out_x): each query stream
    attends over both key streams, as four :func:`flash_attention_pos`
    calls merged by :func:`merge_attention_partials`; equal to attention
    over the concatenated sequence up to floating-point reassociation.
    Differentiable in all six tensors."""
    if scale is None:
        scale = qx.shape[-1] ** -0.5
    return JointFlashAttention.apply(qc, kc, vc, qx, kx, vx, scale, stability)
