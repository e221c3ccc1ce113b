"""Flash attention over (B, H, L, D), forward and backward, and the
position-masked forward and backward with the split-KV joint attention built
on them (port of ``ops/flash_attention.py``).

Forward: on CUDA tensors :func:`flash_attention_forward` launches K1, which
stands in for both Pallas forward bodies of the JAX package
(``_fwd_kernel_wide`` and ``_fwd_kernel``): in bf16 the TMA / wgmma kernel of
``csrc/flash_attention_sm90.cu`` at every head dim but 512, and at 512 the
TMA / wgmma kernel of ``csrc/flash_attention.cu``, whose keys the host
splits over several blocks when the query tiles alone would not fill the
card (:func:`k1_route`, :func:`k1_d512_splits`). On CPU tensors it runs
:func:`flash_attention_plain`. Same contract as the JAX forward: ``out`` in
the input dtype with shape (B, H, Lq, D), ``lse`` fp32 with shape
(B, H, Lq).

Backward: :func:`flash_attention_backward` launches K3 (dq, the Pallas
``_bwd_dq_kernel``: in bf16 the TMA / wgmma kernel of
``csrc/flash_attention_dq_sm90.cu``, :func:`k3_route`) and K4 (dk with dv,
the Pallas ``_bwd_dkv_kernel``: in bf16 the TMA / wgmma kernel of
``csrc/flash_attention_bwd_sm90.cu``, :func:`k4_route`) on CUDA tensors and
runs :func:`flash_attention_bwd_plain` on CPU tensors. Both recompute the
probabilities under the forward's saved lse; delta = Σ dO·out is a plain
fp32 reduction, as the JAX package computes it in XLA.
:func:`flash_attention` is differentiable through :class:`FlashAttention`.

The kernels read q, k, v and dO through their strides (only the head dim
must be contiguous), so the fused-QKV projection's q|k|v column slices go in
without a copy, and they write ``out``, dq, dk and dv into (B, L, H, D)
memory returned as (B, H, L, D) views, so merging heads afterwards is free.

Position-masked forward: :func:`flash_attention_pos` masks by global
position (two offset segments per side, ``valid_len``, causal, the ragged
key tail) and returns (out, lse); on CUDA tensors it launches K5 (the Pallas
``_fwd_kernel_pos``: in bf16 the position-mask form of the TMA / wgmma kernel
of ``csrc/flash_attention_sm90.cu``, :func:`k5_route`), on CPU tensors
:func:`flash_attention_pos_plain`. Position-masked backward:
:func:`flash_bwd_pos` gives (dq, dk, dv) of one query block against one key
block under a caller-supplied *global* lse and delta, with the same masks;
on CUDA tensors K6 (dq, the Pallas ``_bwd_dq_kernel_pos``: in bf16 the
position-mask form of the TMA / wgmma kernel of
``csrc/flash_attention_dq_sm90.cu``, :func:`k6_route`) and K7 (dk with dv,
the Pallas ``_bwd_dkv_kernel_pos``: in bf16 the position-mask form of the
TMA / wgmma kernel of ``csrc/flash_attention_bwd_sm90.cu``,
:func:`k7_route`), on CPU
tensors :func:`flash_bwd_pos_plain`. :func:`joint_flash_attention` is the MMDiT's
attention over [context | x] without concatenation: four position-masked
calls merged exactly through their log-sum-exps by
:func:`merge_attention_partials`, and in the backward four
:func:`flash_bwd_pos` calls under the merged lse whose partial gradients
add up (:class:`JointFlashAttention`).

Masks of :func:`flash_attention` (the Pallas ``_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` in their bias, causal and
segment-id forms): an additive bias read through its strides (dbias from the
dq kernel's dS tiles), ``causal`` (col <= row from index 0 on both sides) and
``segment_ids`` with tile skipping from per-tile id ranges; they compose, in
the kernels at head dims 64 and 128. A row that sees no key gives out = 0
and lse = -1e30, and the backward selects masked probabilities to 0.

Dtypes: every kernel has a bf16 form (tensor cores, ``csrc/*.cu``) and an
fp32 form (``csrc/fp32/*.cu``; out, lse and the gradients fp32, as the
Pallas kernels ask for ``Precision.HIGHEST`` on fp32 inputs). They run on
the tensor cores with a three-term TF32 split (every operand x as
tf32(x) + tf32(x - tf32(x)), three wgmma passes per product,
``_F32_PASSES``), after a pre-pass that writes the terms, transposed where
a product reduces over the sequence, into a workspace the wrapper
allocates (:func:`f32_forward_work`, :func:`f32_backward_work`). Nothing
is rounded below fp32's precision but the split's own ~2^-22 of each
product. The fp32 forms are a shared library of their own, built when an
fp32 launch first asks for it. They cover the head dims the port's fp32
defaults reach (``_FP32_*`` below), without a mask, causal, or (K1 at 64,
T5) a bias alone; with segment ids, another bias form or another head dim,
an fp32 CUDA tensor raises ``NotImplementedError``. Each wrapper counts
its launches by dtype in ``.dtypes`` beside ``.launches``; each, as it runs
more than one kernel, also by kernel in ``.routes``, and K1 by head dim in
``.head_dims``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from . import _build

# head dims the forward kernel is instantiated for: padded to 48, 64, 80,
# 128, 160 (the sm90 kernel; 160 is the SD1 UNet's level-2 attention from
# 768^2) or 512 (the d512 one); the backward kernels, and the masked forms of
# all three, take 64 (SigLIP, the TinyVLM decoder, T5) and 128 (tiny-SD's
# UNet)
_KERNEL_HEAD_DIMS = (40, 48, 64, 72, 80, 128, 160, 512)
_BWD_HEAD_DIMS = (64, 128)
_MASK_HEAD_DIMS = (64, 128)
_POS_HEAD_DIMS = (64, 128)
# the fp32 forms: K1 at every forward head dim, causal at 64 (TinyVLM's
# decoder) and with a bias at 64 (T5, forward only), K3 / K4 at 64 and 128
# and causal at 64, K5 / K6 / K7 at 64
_FP32_HEAD_DIMS = _KERNEL_HEAD_DIMS
_FP32_BWD_HEAD_DIMS = (64, 128)
_FP32_CAUSAL_HEAD_DIMS = (64,)
_FP32_BIAS_HEAD_DIMS = (64,)
_FP32_POS_HEAD_DIMS = (64,)
NEG_INF = -1e30   # lse of a row with no visible key
# (query tile, key tile) of K1, K3 and K4 (the sm90 kernels): the sizes the
# segment-id tile bounds and ranges handed to each kernel are built at
_FWD_TILES, _DQ_TILES, _DKV_TILES = (128, 128), (128, 64), (64, 128)
# K1 at head dim 512 (bf16 and fp32): 64-query blocks, 64-key tiles, at most
# 4 key splits
_D512_TILE, _D512_MAX_SPLITS = 64, 4
# The fp32 forward (csrc/fp32/flash_f32_fwd.cu): TF32 passes per product, and
# the group of keys v's transposed terms are padded to (and permuted within)
_F32_PASSES, _F32_KEY_GROUP = 3, 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _wide(x):
    """``x`` in the plain versions' working precision: fp32, or fp64 when
    it is fp64, so that fp64 inputs give an fp64 reference."""
    return x if x.dtype == torch.float64 else x.float()


def _visible_pairs(lq, lk, segment_ids, causal, device):
    """Bool mask broadcastable to (B, H, Lq, Lk) of the pairs the masks
    admit, or None without masks. Causal is the kernels' rule: col <= row
    from index 0 on both sides (top-left aligned, unlike ``plain_attention``,
    which aligns bottom-right; the two agree for Lq = Lk)."""
    visible = None
    if causal:
        row = torch.arange(lq, device=device)[:, None]
        visible = (torch.arange(lk, device=device)[None, :] <= row)[None, None]
    if segment_ids is not None:
        q_ids, kv_ids = segment_ids
        same = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
        visible = same if visible is None else visible & same
    return visible


def flash_attention_plain(q, k, v, scale: Optional[float] = None, *,
                          bias=None, segment_ids=None, causal: bool = False):
    """(out, lse) in plain PyTorch: fp32 logits and softmax statistics, the
    probabilities cast to v's dtype before the PV product, as the kernels do.
    ``bias`` is added in fp32 after the scale; ``segment_ids`` = (q_ids
    (B, Lq), kv_ids (B, Lk)) admits same-id pairs only; ``causal`` admits
    col <= row. A masked probability is selected to 0, so a row that sees no
    key gives out = 0 and lse = -1e30. fp64 inputs are computed in fp64
    throughout: the reference the fp32 kernels are held to on the card."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + _wide(bias)
    visible = _visible_pairs(q.shape[2], k.shape[2], segment_ids, causal,
                             q.device)
    if visible is None and bias is None:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        out = torch.matmul(_wide(p.to(v.dtype)), _wide(v)) / l
        return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)
    if visible is not None:
        s = s.masked_fill(~visible, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    p = torch.where(s > NEG_INF, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(_wide(p.to(v.dtype)), _wide(v)) / safe_l
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF),
                      m + torch.log(safe_l))
    return out.to(q.dtype), lse.squeeze(-1)


def _reduce_dbias(ds, bias):
    """dS (B, H, Lq, Lk) fp32 summed over the axes ``bias`` is broadcast
    over, in the bias's shape and dtype."""
    return ds.sum_to_size(bias.shape).to(bias.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, g,
                              scale: Optional[float] = None, *, bias=None,
                              segment_ids=None, causal: bool = False,
                              need_dbias: bool = False):
    """(dq, dk, dv) in plain PyTorch, the kernels' contract: P rebuilt in
    fp32 as exp(scale·QKᵀ + bias − lse) and selected to 0 where the masks of
    :func:`flash_attention_plain` hide the key, delta = Σ_d dO·out in fp32,
    and P and dS cast to the input dtype before the products that take them.
    With ``need_dbias`` also dbias: dS in fp32 summed over the axes the bias
    is broadcast over, in the bias's dtype, as a fourth value."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = _wide(q), _wide(k), _wide(v), _wide(g)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + _wide(bias)
    p = torch.exp(s - lse[..., None])
    visible = _visible_pairs(q.shape[2], k.shape[2], segment_ids, causal,
                             q.device)
    if bias is not None:
        hidden = s <= NEG_INF
        visible = ~hidden if visible is None else visible & ~hidden
    if visible is not None:
        p = torch.where(visible, p, torch.zeros_like(p))
    delta = (gf * _wide(out)).sum(-1, keepdim=True)
    dv = torch.matmul(_wide(p.to(v.dtype)).transpose(-1, -2), gf)
    ds32 = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta)
    ds = ds32.to(q.dtype)
    dq = torch.matmul(_wide(ds), kf) * scale
    dk = torch.matmul(_wide(ds).transpose(-1, -2), qf) * scale
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if need_dbias:
        return (*grads, _reduce_dbias(ds32, bias))
    return grads


# --------------------------------------------------------------------------
# Segment ids: tile bounds, loop ranges and the seg_max_kv_blocks hint
# --------------------------------------------------------------------------
def _seg_bounds(ids, block: int):
    """(B, n, 2) int32 [min, max] id of each ``block``-wide tile of ``ids``
    (B, L); the last tile is padded with -1, the id of no real token (the
    JAX ``_seg_inputs``)."""
    b, n = ids.shape
    pad = _cdiv(n, block) * block - n
    tiles = torch.nn.functional.pad(ids.to(torch.int32), (0, pad),
                                    value=-1).reshape(b, -1, block)
    return torch.stack([tiles.amin(2), tiles.amax(2)], dim=-1).contiguous()


def _seg_block_ranges(q_bounds, kv_bounds):
    """First and last overlapping tile of the other axis, per tile: (q_lo,
    q_hi) each (B, n_q) over key tiles and (k_lo, k_hi) each (B, n_k) over
    query tiles; [0, 0] where nothing overlaps (the kernels' own overlap
    test then skips tile 0). The JAX ``_seg_block_ranges``."""
    overlap = ((q_bounds[:, :, None, 0] <= kv_bounds[:, None, :, 1])
               & (kv_bounds[:, None, :, 0] <= q_bounds[:, :, None, 1]))

    def ranges(ov):
        n = ov.shape[-1]
        any_ = ov.any(-1)
        first = ov.int().argmax(-1)
        last = n - 1 - ov.flip(-1).int().argmax(-1)
        zero = torch.zeros_like(first)
        return (torch.where(any_, first, zero).to(torch.int32).contiguous(),
                torch.where(any_, last, zero).to(torch.int32).contiguous())

    return (*ranges(overlap), *ranges(overlap.transpose(1, 2)))


def _check_segment_ids(segment_ids, b, lq, lk, device):
    q_ids, kv_ids = segment_ids
    if (tuple(q_ids.shape) != (b, lq) or tuple(kv_ids.shape) != (b, lk)
            or q_ids.device != device or kv_ids.device != device):
        raise ValueError(f"segment_ids must be (q_ids ({b}, {lq}), kv_ids "
                         f"({b}, {lk})) on {device}")
    return (q_ids.to(torch.int32).contiguous(),
            kv_ids.to(torch.int32).contiguous())


def _seg_kernel_args(segment_ids, q, lk, tiles, over: str):
    """The six int32 arrays of ``csrc/mask.cuh`` at a kernel's own tile
    sizes: ids, tile bounds and the loop range of the blocks of a grid that
    runs over ``over`` ("q" for K1 and K3, "k" for K4)."""
    b, _, lq, _ = q.shape
    q_ids, kv_ids = _check_segment_ids(segment_ids, b, lq, lk, q.device)
    q_bounds, kv_bounds = _seg_bounds(q_ids, tiles[0]), _seg_bounds(kv_ids,
                                                                    tiles[1])
    q_lo, q_hi, k_lo, k_hi = _seg_block_ranges(q_bounds, kv_bounds)
    lo, hi = (q_lo, q_hi) if over == "q" else (k_lo, k_hi)
    return [q_ids, kv_ids, q_bounds, kv_bounds, lo, hi]


def _jax_blocks(lq: int, lk: int, d: int, block_q: int = 1024,
                block_k: int = 1024):
    """The JAX package's block sizes for these lengths (``_flash_fwd``): the
    units ``seg_max_kv_blocks`` is given in."""
    if d > 256:
        block_q, block_k = min(block_q, 512), min(block_k, 512)
    block_q = min(block_q, _cdiv(lq, 128) * 128)
    block_k = min(block_k, _cdiv(lk, 128) * 128)
    if block_q >= lq and lq >= 512:      # _occupancy_block_q
        block_q = _cdiv(block_q // 2, 128) * 128
    return block_q, block_k


def check_seg_hint(segment_ids, lq: int, lk: int, d: int,
                   seg_max_kv_blocks: Optional[int], has_bias: bool) -> None:
    """Validates ``seg_max_kv_blocks`` as the JAX package does for concrete
    ids, forward and backward: the hint, in units of the JAX key block,
    must cover the key blocks any query block's segments overlap, and the
    bound derived from it the query blocks any key block's overlap. The
    kernels here walk each block's own range whatever the hint says, so it
    changes no result; an undersized one is still the caller's error."""
    if segment_ids is None or seg_max_kv_blocks is None:
        return
    if has_bias:
        raise ValueError(
            "seg_max_kv_blocks with bias is unsupported (dbias tiles "
            "outside the truncated grid would stay unwritten)")
    block_q, block_k = _jax_blocks(lq, lk, d)
    n_q, n_k = _cdiv(lq, block_q), _cdiv(lk, block_k)
    hint = int(seg_max_kv_blocks)
    nq_side = (hint if block_q == block_k
               else _cdiv((2 * hint - 1) * block_k, block_q) + 1)
    q_lo, q_hi, k_lo, k_hi = _seg_block_ranges(
        _seg_bounds(segment_ids[0], block_q),
        _seg_bounds(segment_ids[1], block_k))
    for lo, hi, extent, full, axis in (
            (q_lo, q_hi, min(n_k, hint), n_k, "k blocks per q block"),
            (k_lo, k_hi, min(n_q, nq_side), n_q, "q blocks per k block")):
        needed = int((hi - lo + 1).max())
        if extent < full and extent < needed:
            raise ValueError(
                f"truncated grid extent {extent} < {needed} required by "
                f"this packing layout (max overlapping {axis}); raise "
                "seg_max_kv_blocks")


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _readable(x) -> bool:
    """Can the kernels read ``x`` through its strides? The head dim
    contiguous, every other stride a multiple of 16 bytes (8 bf16 or 4 fp32
    elements) and the start 16-byte aligned."""
    vec = 16 // x.element_size()
    return (x.stride(-1) == 1 and not any(s % vec for s in x.stride()[:-1])
            and x.data_ptr() % 16 == 0)


def _check_operand(name, x, like):
    if x.device != like.device or x.dtype != like.dtype:
        raise ValueError(f"{name} must be on {like.device} in {like.dtype}")
    if not _readable(x):
        raise ValueError(
            f"{name}: the head dim must be contiguous, the other strides "
            f"multiples of {16 // x.element_size()} and the start 16-byte "
            f"aligned, got strides {x.stride()}")


def _check_qkv(q, k, v, fn, head_dims=None, fp32_dims=()):
    """(b, h, lq, lk, d) after the checks every kernel wrapper makes.
    ``head_dims`` are the bf16 form's, ``fp32_dims`` the fp32 form's; with
    none, the caller checks the head dim (K1: :func:`k1_route`)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, L, D)")
    if not q.is_cuda:
        raise ValueError(f"{fn} needs CUDA tensors")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the flash kernels take bf16 or fp32, not {q.dtype}")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape or lk == 0:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if head_dims is not None:
        if q.dtype == torch.float32 and d not in fp32_dims:
            raise NotImplementedError(
                f"head dim {d} in fp32: the fp32 form of {fn} takes "
                f"{fp32_dims}" + (f"; pass bf16 tensors (it takes "
                                  f"{head_dims})" if d in head_dims else ""))
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


def _lse_like(q):
    """Empty fp32 (B, H, Lq) row statistics for q."""
    return torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)


def _strides(*xs, bias=None):
    """(batch, head, seq) element strides of each tensor, then the bias's
    four (zeros without one), as a C array."""
    flat = [s for x in xs for s in x.stride()[:3]]
    flat += [0, 0, 0, 0] if bias is None else list(bias.stride())
    return (ctypes.c_longlong * len(flat))(*flat)


def _mask_args(q, lk, bias, segment_ids, causal, fn, tiles, over):
    """What a masked launch passes besides q, k, v: the bias expanded to
    (B, H, Lq, Lk) without a copy (stride 0 on its broadcast axes; cast to
    fp32 first if it is neither fp32 nor bf16), its pointer, the six segment
    pointers and the two flags. The segment tensors are returned too: the
    caller holds them until its kernel is enqueued, so that no output it
    allocates meanwhile takes their memory."""
    b, h, lq, d = q.shape
    masked = bias is not None or segment_ids is not None or causal
    if masked and d not in _MASK_HEAD_DIMS:
        raise NotImplementedError(
            f"head dim {d}: the masked forms of {fn} take {_MASK_HEAD_DIMS}")
    keep = []
    if bias is not None:
        if bias.device != q.device:
            raise ValueError(f"bias must be on {q.device}")
        if bias.dtype not in (torch.float32, torch.bfloat16):
            bias = bias.float()
        if bias.dim() != 4:
            raise ValueError("bias must be 4-D, broadcastable to "
                             f"({b}, {h}, {lq}, {lk})")
        bias = bias.expand(b, h, lq, lk)
        keep.append(bias)
    seg = [None] * 6
    if segment_ids is not None:
        seg = _seg_kernel_args(segment_ids, q, lk, tiles, over)
        keep += seg
    ptrs = [None if bias is None else bias.data_ptr(),
            *(None if t is None else t.data_ptr() for t in seg)]
    flags = (int(bool(causal)),
             int(bias is not None and bias.dtype == torch.bfloat16))
    return bias, ptrs, flags, keep


def _count_launch(fn, q, bias=None, segment_ids=None, causal=False,
                  route=None):
    """One more launch of ``fn``'s kernel: in ``fn.launches``, by q's dtype
    in ``fn.dtypes``, where ``fn`` has masked forms by form (causal, bias,
    segment ids) in ``fn.forms``, by ``route`` in ``fn.routes``, and (K1) by
    head dim in ``fn.head_dims``."""
    fn.launches += 1
    if route is not None:
        fn.routes[route] += 1
    fn.dtypes["fp32" if q.dtype == torch.float32 else "bf16"] += 1
    if hasattr(fn, "forms"):
        fn.forms[(bool(causal), bias is not None,
                  segment_ids is not None)] += 1
    if hasattr(fn, "head_dims"):
        fn.head_dims[q.shape[-1]] += 1


def _check_fp32_form(fn, d, causal, bias, segments,
                     bias_dims=()) -> None:
    """Raises for the forms of ``fn`` that exist in bf16 only. ``bias_dims``:
    the head dims at which its fp32 form takes a bias, alone (K1: T5's)."""
    if bias and not segments and not causal and d in bias_dims:
        return
    if bias or segments:
        also = (f", or a bias alone at head dims {bias_dims}" if bias_dims
                else "")
        raise NotImplementedError(
            f"{fn}: the bias and segment-id forms take bf16 only; pass bf16 "
            f"q, k, v (fp32 runs without a mask or with causal=True{also})")
    if causal and d not in _FP32_CAUSAL_HEAD_DIMS:
        raise NotImplementedError(
            f"{fn}: causal=True in fp32 takes head dims "
            f"{_FP32_CAUSAL_HEAD_DIMS}; pass bf16 q, k, v at head dim {d}")


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def k1_route(dtype, d: int, causal: bool = False, bias: bool = False,
             segments: bool = False) -> str:
    """Which K1 kernel a CUDA launch of this dtype, head dim and form runs:
    "sm90" (``csrc/flash_attention_sm90.cu``, TMA and wgmma: bf16 at every
    head dim but 512, every mask form at 64 and 128), "d512" (the TMA /
    wgmma kernel of ``csrc/flash_attention.cu``, bf16 at 512 without a mask)
    or "fp32" (``csrc/fp32/flash_f32_fwd.cu``: TMA and TF32 wgmma, three
    passes; at 512 with the keys split as :func:`k1_d512_splits` says; causal
    or a bias alone at 64). Raises ``NotImplementedError`` naming what the
    kernels take for any other."""
    fn = "flash_attention_cuda"
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the flash kernels take bf16 or fp32, not {dtype}")
    if dtype == torch.float32:
        if d not in _FP32_HEAD_DIMS:
            raise NotImplementedError(
                f"head dim {d} in fp32: the fp32 form of {fn} takes "
                f"{_FP32_HEAD_DIMS}")
        _check_fp32_form(fn, d, causal, bias, segments, _FP32_BIAS_HEAD_DIMS)
        return "fp32"
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"head dim {d}: {fn} takes "
                                  f"{_KERNEL_HEAD_DIMS}")
    if (causal or bias or segments) and d not in _MASK_HEAD_DIMS:
        raise NotImplementedError(
            f"head dim {d}: the masked forms of {fn} take {_MASK_HEAD_DIMS}")
    return "d512" if d == 512 else "sm90"


def _bwd_route(fn, dtype, d: int, causal: bool, bias: bool,
               segments: bool) -> str:
    """The route of K3 or K4: "sm90" for bf16 at head dims 64 and 128 in every
    form, "fp32" for fp32 at 64 and 128 without a mask or causal at 64;
    raises for anything else."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the flash kernels take bf16 or fp32, not {dtype}")
    if dtype == torch.float32:
        if d not in _FP32_BWD_HEAD_DIMS:
            raise NotImplementedError(
                f"head dim {d} in fp32: the fp32 form of {fn} takes "
                f"{_FP32_BWD_HEAD_DIMS}")
        _check_fp32_form(fn, d, causal, bias, segments)
        return "fp32"
    if d not in _BWD_HEAD_DIMS:
        raise NotImplementedError(f"head dim {d}: {fn} takes "
                                  f"{_BWD_HEAD_DIMS}")
    return "sm90"


def k3_route(dtype, d: int, causal: bool = False, bias: bool = False,
             segments: bool = False) -> str:
    """Which K3 kernel a CUDA launch of this dtype, head dim and form runs:
    "sm90" (``csrc/flash_attention_dq_sm90.cu``, TMA and wgmma: bf16 at head
    dims 64 and 128 in every form) or "fp32" (``csrc/fp32/flash_f32_bwd.cu``:
    64 and 128 without a mask, causal at 64). Raises
    ``NotImplementedError`` naming what the kernels take for any other."""
    return _bwd_route("flash_attention_bwd_dq_cuda", dtype, d, causal, bias,
                      segments)


def k4_route(dtype, d: int, causal: bool = False, bias: bool = False,
             segments: bool = False) -> str:
    """Which K4 kernel a CUDA launch of this dtype, head dim and form runs:
    "sm90" (``csrc/flash_attention_bwd_sm90.cu``, TMA and wgmma: bf16 at head
    dims 64 and 128 in every form) or "fp32" (``csrc/fp32/flash_f32_bwd.cu``:
    64 and 128 without a mask, causal at 64). Raises
    ``NotImplementedError`` naming what the kernels take for any other."""
    return _bwd_route("flash_attention_bwd_dkv_cuda", dtype, d, causal, bias,
                      segments)


def _pos_route(fn, dtype, d: int) -> str:
    """The route of a position-masked kernel (K5, K6, K7), whatever its
    masks:
    "sm90" for bf16 at head dims 64 and 128, "fp32" for fp32 at 64; raises
    for anything else."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the flash kernels take bf16 or fp32, not {dtype}")
    if dtype == torch.float32:
        if d not in _FP32_POS_HEAD_DIMS:
            raise NotImplementedError(
                f"head dim {d} in fp32: the fp32 form of {fn} takes "
                f"{_FP32_POS_HEAD_DIMS}" + (
                    f"; pass bf16 tensors (it takes {_POS_HEAD_DIMS})"
                    if d in _POS_HEAD_DIMS else ""))
        return "fp32"
    if d not in _POS_HEAD_DIMS:
        raise NotImplementedError(f"head dim {d}: {fn} takes "
                                  f"{_POS_HEAD_DIMS}")
    return "sm90"


def k5_route(dtype, d: int, causal: bool = False, valid_len: bool = False,
             segments: bool = False, bounded: bool = False) -> str:
    """Which K5 kernel a CUDA launch of this dtype, head dim and form runs
    (the form: causal, a ``valid_len``, two segments on a side, the bounded
    softmax): "sm90" (the position-mask form of
    ``csrc/flash_attention_sm90.cu``, TMA and wgmma: bf16 at head dims 64 and
    128 in every form) or "fp32" (``csrc/fp32/flash_f32_fwd.cu``, TMA and
    TF32 wgmma, three passes: 64 in every form). Raises ``NotImplementedError`` naming what the kernels take
    for any other."""
    return _pos_route("flash_attention_pos_cuda", dtype, d)


def k6_route(dtype, d: int, causal: bool = False, valid_len: bool = False,
             segments: bool = False) -> str:
    """Which K6 kernel a CUDA launch of this dtype, head dim and form runs:
    "sm90" (the position-mask form of ``csrc/flash_attention_dq_sm90.cu``,
    TMA and wgmma: bf16 at head dims 64 and 128 in every form) or "fp32"
    (``csrc/fp32/flash_f32_bwd.cu``: 64 in every form). Raises
    ``NotImplementedError`` naming what the kernels take for any other."""
    return _pos_route("flash_bwd_pos_dq_cuda", dtype, d)


def k7_route(dtype, d: int, causal: bool = False, valid_len: bool = False,
             segments: bool = False) -> str:
    """Which K7 kernel a CUDA launch of this dtype, head dim and form runs:
    "sm90" (the position-mask form of ``csrc/flash_attention_bwd_sm90.cu``,
    TMA and wgmma: bf16 at head dims 64 and 128 in every form) or "fp32"
    (``csrc/fp32/flash_f32_bwd.cu``: 64 in every form). Raises
    ``NotImplementedError`` naming what the kernels take for any other."""
    return _pos_route("flash_bwd_pos_dkv_cuda", dtype, d)


def k1_d512_splits(b: int, h: int, lq: int, lk: int, n_sm: int) -> int:
    """How many blocks share the keys of one 64-query tile in the d = 512
    kernels (bf16 and fp32): 1 when the B·H·⌈Lq/64⌉ query tiles fill the ``n_sm`` SMs, else as
    many as fit beside them (at most 4, at most one per 64-key tile), so
    that no split is left without a key tile."""
    tiles = b * h * _cdiv(lq, _D512_TILE)
    n_kt = _cdiv(lk, _D512_TILE)
    want = max(1, min(_D512_MAX_SPLITS, n_sm // tiles, n_kt))
    return _cdiv(n_kt, _cdiv(n_kt, want))


def f32_forward_work(b: int, h: int, lq: int, lk: int, d: int,
                     splits: int = 1) -> int:
    """Floats of the fp32 forward's workspace: the hi / lo terms of q
    (2, B, H, Lq, d), k (2, B, H, Lk, d) and v transposed (2, B, H, d, Lk8),
    Lk8 = Lk rounded up to ``_F32_KEY_GROUP``; at d = 512 with key splits
    also the partial outputs and lse (splits, B·H·Lq, 513)."""
    lk8 = _cdiv(lk, _F32_KEY_GROUP) * _F32_KEY_GROUP
    n = 2 * b * h * d * (lq + lk + lk8)
    if d == 512 and splits > 1:
        n += splits * b * h * lq * 513
    return n


def f32_backward_work(b: int, h: int, lq: int, lk: int, d: int) -> int:
    """Floats of the fp32 backward's workspace, one layout for K3 / K6 and
    K4 / K7: the hi / lo terms of q, k, v and dO as rows (2, B, H, L, d),
    then k transposed (2, B, H, d, Lk8) for dq and q and dO transposed
    (2, B, H, d, Lq8) for dk / dv, L8 = L rounded up to ``_F32_KEY_GROUP``."""
    l8 = lambda n: _cdiv(n, _F32_KEY_GROUP) * _F32_KEY_GROUP
    return 2 * b * h * d * (2 * lq + 2 * lk + l8(lk) + 2 * l8(lq))


def _f32_work(q, lk, splits=1):
    b, h, lq, d = q.shape
    return torch.empty(f32_forward_work(b, h, lq, lk, d, splits),
                       device=q.device, dtype=torch.float32)


def _f32_bwd_work(q, lk):
    b, h, lq, d = q.shape
    return torch.empty(f32_backward_work(b, h, lq, lk, d), device=q.device,
                       dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tma_operand(x):
    """``x`` as a TMA tensor map can describe it: copied only when a stride
    is 0 on an axis longer than 1 (an expanded tensor)."""
    if any(st == 0 and n > 1 for st, n in zip(x.stride(), x.shape)):
        return x.contiguous()
    return x


def flash_attention_cuda(q, k, v, scale: Optional[float] = None, *,
                         bias=None, segment_ids=None, causal: bool = False):
    """K1, the CUDA kernel: (out, lse) for bf16 or fp32 (B, H, L, D) CUDA
    tensors, with the masks of :func:`flash_attention_plain` (head dim 64 or
    128; in fp32 ``causal`` or a ``bias`` alone, at head dim 64). Which
    kernel runs: :func:`k1_route`; launches are counted by route in
    ``.routes`` and by head dim in ``.head_dims``."""
    b, h, lq, lk, d = _check_qkv(q, k, v, "flash_attention_cuda")
    route = k1_route(q.dtype, d, bool(causal), bias is not None,
                     segment_ids is not None)
    if scale is None:
        scale = d ** -0.5
    if route == "fp32":
        if bias is not None:   # fp32, expanded to (B, H, Lq, Lk) unmoved
            bias, _, _, _held = _mask_args(q, lk, bias.float(), None, False,
                                           "flash_attention_cuda",
                                           _FWD_TILES, "q")
        out = _blhd(q, lq)
        lse = _lse_like(q)
        strides = _strides(q, k, v, out, bias=bias)
        splits = (k1_d512_splits(b, h, lq, lk, _sm_count(q.device))
                  if d == 512 else 1)
        work = _f32_work(q, lk, splits)
        err = _build.load("kernels_fp32").fdsd_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), work.data_ptr(),
            None if bias is None else bias.data_ptr(), b, h, lq, lk, d,
            ctypes.cast(strides, ctypes.c_void_p), float(scale),
            int(bool(causal)), splits, _stream(q))
        _build.check(err, "fdsd_flash_fwd_f32")
        _count_launch(flash_attention_cuda, q, bias, causal=causal,
                      route=route)
        return out, lse
    q, k, v = _tma_operand(q), _tma_operand(k), _tma_operand(v)
    if route == "d512":
        splits = k1_d512_splits(b, h, lq, lk, _sm_count(q.device))
        out, lse = _flash_fwd_d512(q, k, v, scale, splits)
        _count_launch(flash_attention_cuda, q, route=route)
        return out, lse
    bias, ptrs, flags, _held = _mask_args(
        q, lk, bias, segment_ids, causal, "flash_attention_cuda", _FWD_TILES,
        "q")
    out = _blhd(q, lq)
    lse = _lse_like(q)
    strides = _strides(q, k, v, out, bias=bias)
    lib = _build.load()
    err = lib.fdsd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *ptrs, b, h, lq, lk, d,
        ctypes.cast(strides, ctypes.c_void_p), float(scale), *flags,
        _stream(q))
    _build.check(err, "fdsd_flash_fwd")
    _count_launch(flash_attention_cuda, q, bias, segment_ids, causal, route)
    return out, lse


def _flash_fwd_d512(q, k, v, scale: float, splits: int):
    """(out, lse) from the d = 512 kernel with its keys split over
    ``splits`` blocks per query tile (1 to 4; with more than one, an fp32
    workspace of partial outputs that a second kernel merges by their lse).
    q, k, v: bf16 CUDA (B, H, L, 512), checked by the caller."""
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    out = _blhd(q, lq)
    lse = _lse_like(q)
    work = (torch.empty(splits * b * h * lq * 513, device=q.device,
                        dtype=torch.float32) if splits > 1 else None)
    strides = _strides(q, k, v, out)
    err = _build.load().fdsd_flash_fwd_d512(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), None if work is None else work.data_ptr(), b, h, lq,
        lk, ctypes.cast(strides, ctypes.c_void_p), float(scale), int(splits),
        _stream(q))
    _build.check(err, "fdsd_flash_fwd_d512")
    return out, lse


flash_attention_cuda.launches = 0
flash_attention_cuda.forms = collections.Counter()
flash_attention_cuda.dtypes = collections.Counter()
flash_attention_cuda.routes = collections.Counter()
flash_attention_cuda.head_dims = collections.Counter()


def flash_attention_forward(q, k, v, scale: Optional[float] = None, **masks):
    """(out, lse): the kernel on CUDA tensors, the plain version on CPU.
    ``masks``: ``bias``, ``segment_ids``, ``causal``."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, scale, **masks)
    return flash_attention_plain(q, k, v, scale, **masks)


def _check_bwd(q, k, v, g, lse, delta, head_dims=_BWD_HEAD_DIMS,
               fp32_dims=_FP32_BWD_HEAD_DIMS):
    """(b, h, lq, lk, d) after the checks of :func:`_check_qkv` and those of
    dO, lse and delta; with ``head_dims`` None the caller checks the head
    dim (K3, K4, K6, K7: :func:`k3_route`, :func:`k4_route`,
    :func:`k6_route`, :func:`k7_route`)."""
    dims = _check_qkv(q, k, v, "the flash backward kernels", head_dims,
                      fp32_dims)
    _check_operand("dO", g, q)
    if g.shape != q.shape:
        raise ValueError(f"dO {tuple(g.shape)} must be {tuple(q.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != q.shape[:3] or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 (B, H, Lq)")
    return dims


def flash_attention_bwd_dq_cuda(q, k, v, g, lse, delta,
                                scale: Optional[float] = None, *, bias=None,
                                segment_ids=None, causal: bool = False,
                                need_dbias: bool = False):
    """K3: dq from bf16 or fp32 CUDA q, k, v, dO (= ``g``) and fp32
    (B, H, Lq) ``lse`` and ``delta`` = Σ_d dO·out, under the masks of the
    forward. Which kernel runs: :func:`k3_route`; launches are counted by
    route in ``.routes``.
    With ``need_dbias`` returns (dq, dS): the kernel also writes dS = the
    bias's gradient before any reduction, fp32 (B, H, Lq, Lk), every tile
    once and zeros where it skips one."""
    b, h, lq, lk, d = _check_bwd(q, k, v, g, lse, delta, head_dims=None)
    route = k3_route(q.dtype, d, bool(causal), bias is not None,
                     segment_ids is not None)
    scale = d ** -0.5 if scale is None else scale
    if need_dbias and bias is None:
        raise ValueError("need_dbias without a bias")
    if route == "fp32":
        dq = _blhd(q, lq)
        strides = _strides(q, k, v, g, dq)
        work = _f32_bwd_work(q, lk)
        err = _build.load("kernels_fp32").fdsd_flash_bwd_dq_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), work.data_ptr(),
            b, h, lq, lk, d, ctypes.cast(strides, ctypes.c_void_p),
            float(scale), int(bool(causal)), _stream(q))
        _build.check(err, "fdsd_flash_bwd_dq_f32")
        _count_launch(flash_attention_bwd_dq_cuda, q, causal=causal,
                      route=route)
        return dq
    q, k, v, g = (_tma_operand(x) for x in (q, k, v, g))
    bias, ptrs, flags, _held = _mask_args(
        q, lk, bias, segment_ids, causal, "flash_attention_bwd_dq_cuda",
        _DQ_TILES, "q")
    dq = _blhd(q, lq)
    ds = (torch.empty((b, h, lq, lk), device=q.device, dtype=torch.float32)
          if need_dbias else None)
    strides = _strides(q, k, v, g, dq, bias=bias)
    err = _build.load().fdsd_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        None if ds is None else ds.data_ptr(), *ptrs, b, h, lq, lk, d,
        ctypes.cast(strides, ctypes.c_void_p), float(scale), *flags,
        _stream(q))
    _build.check(err, "fdsd_flash_bwd_dq")
    _count_launch(flash_attention_bwd_dq_cuda, q, bias, segment_ids, causal,
                  route)
    return (dq, ds) if need_dbias else dq


def flash_attention_bwd_dkv_cuda(q, k, v, g, lse, delta,
                                 scale: Optional[float] = None, *, bias=None,
                                 segment_ids=None, causal: bool = False):
    """K4: (dk, dv) from the inputs of :func:`flash_attention_bwd_dq_cuda`.
    Which kernel runs: :func:`k4_route`; launches are counted by route in
    ``.routes``."""
    b, h, lq, lk, d = _check_bwd(q, k, v, g, lse, delta, head_dims=None)
    route = k4_route(q.dtype, d, bool(causal), bias is not None,
                     segment_ids is not None)
    scale = d ** -0.5 if scale is None else scale
    if route == "fp32":
        dk, dv = _blhd(k, lk), _blhd(v, lk)
        strides = _strides(q, k, v, g, dk, dv)
        work = _f32_bwd_work(q, lk)
        err = _build.load("kernels_fp32").fdsd_flash_bwd_dkv_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            work.data_ptr(), b, h, lq, lk, d,
            ctypes.cast(strides, ctypes.c_void_p), float(scale),
            int(bool(causal)), _stream(q))
        _build.check(err, "fdsd_flash_bwd_dkv_f32")
        _count_launch(flash_attention_bwd_dkv_cuda, q, causal=causal,
                      route=route)
        return dk, dv
    q, k, v, g = (_tma_operand(x) for x in (q, k, v, g))
    bias, ptrs, flags, _held = _mask_args(
        q, lk, bias, segment_ids, causal, "flash_attention_bwd_dkv_cuda",
        _DKV_TILES, "k")
    dk, dv = _blhd(k, lk), _blhd(v, lk)
    strides = _strides(q, k, v, g, dk, dv, bias=bias)
    err = _build.load().fdsd_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *ptrs, b, h, lq, lk, d, ctypes.cast(strides, ctypes.c_void_p),
        float(scale), *flags, _stream(q))
    _build.check(err, "fdsd_flash_bwd_dkv")
    _count_launch(flash_attention_bwd_dkv_cuda, q, bias, segment_ids, causal,
                  route)
    return dk, dv


flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dkv_cuda.launches = 0
flash_attention_bwd_dq_cuda.forms = collections.Counter()
flash_attention_bwd_dkv_cuda.forms = collections.Counter()
flash_attention_bwd_dq_cuda.dtypes = collections.Counter()
flash_attention_bwd_dkv_cuda.dtypes = collections.Counter()
flash_attention_bwd_dq_cuda.routes = collections.Counter()
flash_attention_bwd_dkv_cuda.routes = collections.Counter()


def _kernel_operand(g, dtype):
    """``g`` as the kernels can read it: in ``dtype``, copied only when its
    head dim is not contiguous, another stride is not a multiple of 16 bytes
    or it is not 16-byte aligned."""
    g = g.to(dtype)
    return g if _readable(g) else g.contiguous()


def flash_attention_bwd_cuda(q, k, v, out, lse, g,
                             scale: Optional[float] = None, *, bias=None,
                             segment_ids=None, causal: bool = False,
                             need_dbias: bool = False):
    """(dq, dk, dv) for bf16 or fp32 CUDA tensors through K3 and K4, with
    ``out`` and ``lse`` from :func:`flash_attention_cuda` under the same
    masks and ``g`` = dO. A dO whose head dim is not contiguous (or whose
    other strides are not multiples of 16 bytes) is copied first; the
    kernels read it through its strides otherwise. delta = Σ_d dO·out is a
    plain fp32 reduction. With ``need_dbias`` a fourth value: K3's dS tiles summed over
    the bias's broadcast axes and cast to its dtype, plain PyTorch as the
    JAX package leaves it to XLA."""
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} must be {tuple(q.shape)}")
    g = _kernel_operand(g, q.dtype)
    delta = (g.float() * out.float()).sum(-1)
    lse = lse.contiguous()
    masks = dict(bias=bias, segment_ids=segment_ids, causal=causal)
    dq = flash_attention_bwd_dq_cuda(q, k, v, g, lse, delta, scale, **masks,
                                     need_dbias=need_dbias)
    dkv = flash_attention_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, **masks)
    if need_dbias:
        dq, ds = dq
        return (dq, *dkv, _reduce_dbias(ds, bias))
    return (dq, *dkv)


def flash_attention_backward(q, k, v, out, lse, g,
                             scale: Optional[float] = None, **masks):
    """(dq, dk, dv[, dbias]): the kernels on CUDA tensors, the plain version
    on CPU. ``masks``: ``bias``, ``segment_ids``, ``causal``,
    ``need_dbias``."""
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, out, lse, g, scale, **masks)
    return flash_attention_bwd_plain(q, k, v, out, lse, g, scale, **masks)


class FlashAttention(torch.autograd.Function):
    """Forward: :func:`flash_attention_forward`, saving q, k, v, out, lse and
    the bias and segment ids. Backward: :func:`flash_attention_backward`
    (the JAX ``_vjp_bwd``); dbias only when the bias needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_ids, kv_ids, causal, scale):
        segment_ids = None if q_ids is None else (q_ids, kv_ids)
        out, lse = flash_attention_forward(
            q, k, v, scale, bias=bias, segment_ids=segment_ids, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse, bias, q_ids, kv_ids)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, bias, q_ids, kv_ids = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        grads = flash_attention_backward(
            q, k, v, out, lse, g, ctx.scale, bias=bias,
            segment_ids=None if q_ids is None else (q_ids, kv_ids),
            causal=ctx.causal, need_dbias=need_dbias)
        return (*grads[:3], grads[3] if need_dbias else None, None, None,
                None, None)


def flash_attention(q, k, v, bias=None, segment_ids=None,
                    causal: bool = False, scale: Optional[float] = None,
                    seg_max_kv_blocks: Optional[int] = None):
    """Flash attention over (B, H, L, D); returns (B, H, Lq, D).
    Differentiable in q, k, v and bias.

    ``bias``: additive, broadcastable to (B, H, Lq, Lk), fp32 or bf16, added
    in fp32 after the scale. ``segment_ids``: (q_ids (B, Lq), kv_ids
    (B, Lk)) integer ids of packed sequences; attention is masked to
    same-id pairs and composes with ``causal`` and ``bias``; ragged lengths
    are the case "pad tokens get an id no real token uses". ``causal``
    admits col <= row counted from index 0 on both sides. A query that sees
    no key gives 0. ``seg_max_kv_blocks`` is the JAX package's static bound
    on the key blocks (of its own block size) any query block's segments
    overlap; here the kernels walk each tile's own range, so the hint is
    only validated (:func:`check_seg_hint`)."""
    check_seg_hint(segment_ids, q.shape[2], k.shape[2], q.shape[3],
                   seg_max_kv_blocks, bias is not None)
    q_ids, kv_ids = (None, None) if segment_ids is None else segment_ids
    return FlashAttention.apply(q, k, v, bias, q_ids, kv_ids, causal, scale)


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
    s = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * scale
    visible = _visible(lq, lk, q_offsets, kv_offsets, seg_q, seg_k, causal,
                       valid_len)
    s = s.masked_fill(~visible, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * visible
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(_wide(p.to(v.dtype)), _wide(v)) / safe_l
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


def _pos_entry(q, name):
    """The C entry ``name`` of the library for q's dtype."""
    if q.dtype == torch.float32:
        return getattr(_build.load("kernels_fp32"), name + "_f32")
    return getattr(_build.load(), name)


def flash_attention_pos_cuda(q, k, v, q_offsets, kv_offsets, *,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             seg_q: Optional[int] = None,
                             seg_k: Optional[int] = None,
                             valid_len: Optional[int] = None,
                             stability: str = "online"):
    """K5: (out, lse) for bf16 (B, H, L, D) CUDA tensors, D 64 or 128, or
    fp32 ones, D 64. The offsets are int32 (2,) tensors on q's device; the
    kernel reads them, so nothing waits for the host. Which kernel runs:
    :func:`k5_route`; launches are counted by route in ``.routes``."""
    b, h, lq, lk, d = _check_qkv(q, k, v, "flash_attention_pos_cuda")
    scale, seg_q, seg_k = _pos_args(q, k, scale, seg_q, seg_k, stability)
    route = k5_route(q.dtype, d, bool(causal), valid_len is not None,
                     seg_q < lq or seg_k < lk, stability == "bounded")
    _check_pos(q, scale, q_offsets, kv_offsets)
    # the fp32 kernel takes a workspace for its split terms after the offsets
    work = []
    if route == "sm90":
        q, k, v = _tma_operand(q), _tma_operand(k), _tma_operand(v)
    else:
        work = [_f32_work(q, lk)]
    out = _blhd(q, lq)
    lse = _lse_like(q)
    strides = _strides(q, k, v, out)
    err = _pos_entry(q, "fdsd_flash_fwd_pos")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), q_offsets.data_ptr(), kv_offsets.data_ptr(),
        *(w.data_ptr() for w in work), b, h, lq, lk, d, ctypes.cast(strides, ctypes.c_void_p), scale, seg_q, seg_k,
        0 if valid_len is None else int(valid_len), int(valid_len is not None),
        int(bool(causal)), int(stability == "bounded"), _stream(q))
    _build.check(err, "fdsd_flash_fwd_pos")
    _count_launch(flash_attention_pos_cuda, q, route=route)
    return out, lse


flash_attention_pos_cuda.launches = 0
flash_attention_pos_cuda.dtypes = collections.Counter()
flash_attention_pos_cuda.routes = collections.Counter()


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
    qf, kf, vf, gf = _wide(q), _wide(k), _wide(v), _wide(g)
    visible = _visible(q.shape[2], k.shape[2], q_offsets, kv_offsets, seg_q,
                       seg_k, causal, valid_len)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(visible, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dv = torch.matmul(_wide(p.to(v.dtype)).transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = _wide((p * (dp - delta[..., None])).to(q.dtype))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _pos_bwd_args(q, k, v, g, lse, delta, q_offsets, kv_offsets, scale, seg_q,
                  seg_k):
    """(dims, scale, seg_q, seg_k) after the checks of K6 and K7; the caller
    checks the head dim (:func:`k6_route`, :func:`k7_route`)."""
    dims = _check_bwd(q, k, v, g, lse, delta, None)
    scale, seg_q, seg_k = _pos_args(q, k, scale, seg_q, seg_k, "online")
    _check_pos(q, scale, q_offsets, kv_offsets)
    return dims, scale, seg_q, seg_k


def flash_bwd_pos_dq_cuda(q, k, v, g, lse, delta, q_offsets, kv_offsets, *,
                          causal: bool = False, scale: Optional[float] = None,
                          seg_q: Optional[int] = None,
                          seg_k: Optional[int] = None,
                          valid_len: Optional[int] = None):
    """K6: dq of :func:`flash_bwd_pos` for bf16 (B, H, L, D) CUDA tensors,
    D 64 or 128, or fp32 ones, D 64; ``lse`` and ``delta`` contiguous fp32
    (B, H, Lq), the offsets int32 (2,) tensors on q's device. Which kernel
    runs: :func:`k6_route`; launches are counted by route in ``.routes``."""
    (b, h, lq, lk, d), scale, seg_q, seg_k = _pos_bwd_args(
        q, k, v, g, lse, delta, q_offsets, kv_offsets, scale, seg_q, seg_k)
    route = k6_route(q.dtype, d, bool(causal), valid_len is not None,
                     seg_q < lq or seg_k < lk)
    work = []   # the fp32 kernel's workspace, after the offsets
    if route == "sm90":
        q, k, v, g = (_tma_operand(x) for x in (q, k, v, g))
    else:
        work = [_f32_bwd_work(q, lk)]
    dq = _blhd(q, lq)
    strides = _strides(q, k, v, g, dq)
    err = _pos_entry(q, "fdsd_flash_bwd_pos_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), q_offsets.data_ptr(),
        kv_offsets.data_ptr(), *(w.data_ptr() for w in work), b, h, lq, lk, d,
        ctypes.cast(strides, ctypes.c_void_p), scale, seg_q, seg_k,
        0 if valid_len is None else int(valid_len), int(valid_len is not None),
        int(bool(causal)), _stream(q))
    _build.check(err, "fdsd_flash_bwd_pos_dq")
    _count_launch(flash_bwd_pos_dq_cuda, q, route=route)
    return dq


def flash_bwd_pos_dkv_cuda(q, k, v, g, lse, delta, q_offsets, kv_offsets, *,
                           causal: bool = False,
                           scale: Optional[float] = None,
                           seg_q: Optional[int] = None,
                           seg_k: Optional[int] = None,
                           valid_len: Optional[int] = None):
    """K7: (dk, dv) from the inputs of :func:`flash_bwd_pos_dq_cuda`.
    Which kernel runs: :func:`k7_route`; launches are counted by route in
    ``.routes``."""
    (b, h, lq, lk, d), scale, seg_q, seg_k = _pos_bwd_args(
        q, k, v, g, lse, delta, q_offsets, kv_offsets, scale, seg_q, seg_k)
    route = k7_route(q.dtype, d, bool(causal), valid_len is not None,
                     seg_q < lq or seg_k < lk)
    work = []   # the fp32 kernel's workspace, after the offsets
    if route == "sm90":
        q, k, v, g = (_tma_operand(x) for x in (q, k, v, g))
    else:
        work = [_f32_bwd_work(q, lk)]
    dk, dv = _blhd(k, lk), _blhd(v, lk)
    strides = _strides(q, k, v, g, dk, dv)
    err = _pos_entry(q, "fdsd_flash_bwd_pos_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        q_offsets.data_ptr(), kv_offsets.data_ptr(),
        *(w.data_ptr() for w in work), b, h, lq, lk, d,
        ctypes.cast(strides, ctypes.c_void_p), scale, seg_q, seg_k,
        0 if valid_len is None else int(valid_len), int(valid_len is not None),
        int(bool(causal)), _stream(q))
    _build.check(err, "fdsd_flash_bwd_pos_dkv")
    _count_launch(flash_bwd_pos_dkv_cuda, q, route=route)
    return dk, dv


flash_bwd_pos_dq_cuda.launches = 0
flash_bwd_pos_dkv_cuda.launches = 0
flash_bwd_pos_dq_cuda.dtypes = collections.Counter()
flash_bwd_pos_dkv_cuda.dtypes = collections.Counter()
flash_bwd_pos_dq_cuda.routes = collections.Counter()
flash_bwd_pos_dkv_cuda.routes = collections.Counter()


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
