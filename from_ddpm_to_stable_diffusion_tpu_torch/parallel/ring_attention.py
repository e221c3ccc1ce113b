"""Sequence-parallel attention over a mesh axis: ring and Ulysses (port of
``parallel/ring_attention.py``).

- :func:`ring_attention`: the K/V shards rotate around the axis; each hop
  runs the position-masked flash forward (K5, through
  :func:`..ops.flash_attention.flash_attention_pos`) of the local queries
  against the visiting keys at the two blocks' global offsets and merges it
  into the running (out, lse) by :func:`merge_attention_partials`. The
  backward (K6 and K7, through :func:`flash_bwd_pos`) runs under the merged
  global lse and delta = Σ dO·out: the K/V blocks and their fp32 gradient
  accumulators rotate a full lap while each shard adds its contribution, so
  both come home with every shard's part. n shards make n² K5 launches a
  forward and n² K6 and n² K7 a backward. ``impl="xla"`` is the
  materialized-logits ring in plain PyTorch (the numerical reference, and
  the default on CPU tensors, as the JAX package takes it off the TPU).
- :func:`ulysses_attention`: all_to_all from sequence shards to head shards,
  one plain materialized-logits attention per shard over the whole sequence,
  all_to_all back (the JAX package computes it with XLA einsums and no
  Pallas kernel).

The mesh forms are :mod:`.mesh`'s: in form (a) q, k and v are the whole
(B, H, L, D) tensors, in form (b) each rank's (B, H, L/n, D) shard, and the
output is alike. The shards the kernels read are views along L (their bases
stay 16-byte aligned: a row is D·2 bytes); each shard's lse and delta are
tensors of their own, so no copy is made for the kernels. On CUDA tensors
the flash ring reaches K5 / K6 / K7 or raises; nothing falls back to the
plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import (NEG_INF, flash_attention_pos,
                                   flash_bwd_pos, merge_attention_partials)
from .mesh import SEQ_AXIS, Mesh


def _attention_with_lse(q, k, v, scale, kv_mask=None):
    """Plain attention over (B, H, L, D) returning (out, lse), fp32 logits.
    ``kv_mask``: (Lk,) or (Lq, Lk) bool; masked keys get a logit of -1e30, so
    a block with no visible key gives an lse near -1e30 that the merge
    weighs at 0."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.matmul((p / safe_l).to(v.dtype), v)
    return out, (m + torch.log(safe_l))[..., 0]


def zigzag_order(l: int, n: int):
    """Global sequence permutation for the causal ring: [0, l) in 2n chunks,
    shard i holding chunks i and 2n-1-i, so that every shard owns as many
    early as late positions and the causal mask leaves the same work on each
    hop. Returns (perm, inv) int64 index tensors: ``x[..., perm, :]`` is the
    zig-zag layout, ``out[..., inv, :]`` the natural order again."""
    if l % (2 * n):
        raise ValueError(f"seq {l} must divide into 2*{n} chunks")
    half = l // (2 * n)
    chunks = [torch.arange(i * half, (i + 1) * half) for i in range(2 * n)]
    perm = torch.cat([torch.cat([chunks[i], chunks[2 * n - 1 - i]])
                      for i in range(n)])
    return perm, torch.argsort(perm)


def _chunk_offsets(src: int, *, causal: bool, n: int, half: int,
                   l_local: int):
    """The two global segment offsets of shard ``src``'s block: (src·half,
    (2n-1-src)·half) in the zig-zag layout; (src·l_local, 0) in the natural
    one, whose second segment is never reached (seg = l_local)."""
    if causal:
        return [src * half, (2 * n - 1 - src) * half]
    return [src * l_local, 0]


class _Ring:
    """The geometry of one ring call: sizes, the per-shard offset tables on
    each shard's device, and the keyword arguments of K5 / K6 / K7."""

    def __init__(self, comm, l, scale, kv_valid_len, causal, devices):
        n = comm.n
        self.comm, self.n = comm, n
        l_local = l // n
        half = l // (2 * n) if causal else l_local
        seg = half if causal else l_local
        table = torch.tensor([_chunk_offsets(s, causal=causal, n=n, half=half,
                                             l_local=l_local)
                              for s in range(n)], dtype=torch.int32)
        on = {d: table.to(d) for d in set(devices)}
        self.tables = [on[d] for d in devices]
        self.kw = dict(causal=causal, scale=scale, seg_q=seg, seg_k=seg,
                       valid_len=kv_valid_len)

    def offsets(self, i, me, h):
        """(q offsets, kv offsets) of held shard i (axis position ``me``)
        against the block from ``h`` positions before it."""
        tab = self.tables[i]
        return tab[me], tab[(me - h) % self.n]


def _ring_fwd_impl(ring, qs, ks, vs):
    """Per-shard (outs, lses) of the flash ring over the held shards."""
    comm, n = ring.comm, ring.n
    outs, lses = [], []
    for i, me in enumerate(comm.index):
        o, s = flash_attention_pos(qs[i], ks[i], vs[i],
                                   *ring.offsets(i, me, 0), **ring.kw)
        outs.append(o)
        lses.append(s)
    kb, vb = ks, vs
    for h in range(1, n):
        kb, vb = comm.shift(kb), comm.shift(vb)
        for i, me in enumerate(comm.index):
            o2, l2 = flash_attention_pos(qs[i], kb[i], vb[i],
                                         *ring.offsets(i, me, h), **ring.kw)
            outs[i], lses[i] = merge_attention_partials(outs[i], lses[i], o2,
                                                        l2)
    return outs, lses


def _ring_bwd_impl(ring, qs, ks, vs, outs, lses, gs):
    """Per-shard (dqs, dks, dvs): n hops of K6 + K7 under the merged lse,
    the dk / dv accumulators rotating with their blocks (home after n
    shifts), everything accumulated in fp32 and cast at the end."""
    comm, n = ring.comm, ring.n
    deltas = [(g.float() * o.float()).sum(-1) for g, o in zip(gs, outs)]
    f32 = lambda xs: [torch.zeros_like(x, dtype=torch.float32) for x in xs]
    dq, dk, dv = f32(qs), f32(ks), f32(vs)
    kb, vb = ks, vs
    for h in range(n):
        for i, me in enumerate(comm.index):
            dq_c, dk_c, dv_c = flash_bwd_pos(
                qs[i], kb[i], vb[i], gs[i], lses[i], deltas[i],
                *ring.offsets(i, me, h), **ring.kw)
            dq[i].add_(dq_c)
            dk[i].add_(dk_c)
            dv[i].add_(dv_c)
        if h < n - 1:
            kb, vb = comm.shift(kb), comm.shift(vb)
        dk, dv = comm.shift(dk), comm.shift(dv)
    cast = lambda xs, like: [x.to(y.dtype) for x, y in zip(xs, like)]
    return cast(dq, qs), cast(dk, ks), cast(dv, vs)


class _RingFlash(torch.autograd.Function):
    """The flash ring with its ring backward (the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, comm, scale, kv_valid_len, causal):
        qs, ks, vs = (comm.shards(x, 2) for x in (q, k, v))
        ring = _Ring(comm, comm.global_len(k, 2), scale, kv_valid_len, causal,
                     [x.device for x in qs])
        outs, lses = _ring_fwd_impl(ring, qs, ks, vs)
        ctx.save_for_backward(q, k, v, *outs, *lses)
        ctx.ring = ring
        return comm.unshard(outs, 2)

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        comm, m = ring.comm, len(ring.comm.index)
        q, k, v, *rest = ctx.saved_tensors
        outs, lses = rest[:m], rest[m:]
        qs, ks, vs, gs = (comm.shards(x, 2) for x in (q, k, v, g))
        dqs, dks, dvs = _ring_bwd_impl(ring, qs, ks, vs, outs, lses, gs)
        return (comm.unshard(dqs, 2), comm.unshard(dks, 2),
                comm.unshard(dvs, 2), None, None, None, None)


def _ring_attention_xla(q, k, v, comm, scale, kv_valid_len, causal,
                        positions):
    """The materialized-logits ring (plain PyTorch; autograd runs its
    backward through the rotations)."""
    n, l = comm.n, comm.global_len(k, 2)
    qs, ks, vs = (comm.shards(x, 2) for x in (q, k, v))
    pos = comm.local_shards(positions, 0)

    def kv_mask(kv_pos, q_pos):
        valid = None
        if kv_valid_len is not None and kv_valid_len != l:
            valid = kv_pos < kv_valid_len
        if causal:
            m = kv_pos[None, :] <= q_pos[:, None]
            return m if valid is None else m & valid[None, :]
        return valid

    outs, lses = [], []
    for i in range(len(qs)):
        o, s = _attention_with_lse(qs[i], ks[i], vs[i], scale,
                                   kv_mask(pos[i], pos[i]))
        outs.append(o)
        lses.append(s)
    kb, vb, pb = ks, vs, pos
    for _ in range(n - 1):
        kb, vb, pb = comm.shift(kb), comm.shift(vb), comm.shift(pb)
        for i in range(len(qs)):
            o2, l2 = _attention_with_lse(qs[i], kb[i], vb[i], scale,
                                         kv_mask(pb[i], pos[i]))
            outs[i], lses[i] = merge_attention_partials(outs[i], lses[i], o2,
                                                        l2)
    return comm.unshard(outs, 2)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis: str = SEQ_AXIS,
                   scale: Optional[float] = None,
                   kv_valid_len: Optional[int] = None,
                   causal: bool = False,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Exact attention with q, k, v (B, H, L, D) sharded on L over ``axis``
    of ``mesh`` (form (a): the whole tensors; form (b): each rank's shard).
    L must be a multiple of the axis size: pad and pass ``kv_valid_len`` for
    a ragged sequence (padded keys are masked by global position; padded
    query rows give rows the caller slices off).

    ``causal=True`` masks keys after the query's global position and lays
    the sequence out in zig-zag order inside (:func:`zigzag_order`) so that
    every shard does the same work; inputs and output stay in natural order.
    Needs L % (2·axis size) == 0.

    ``impl``: "flash" (K5 forward and the K6 / K7 ring backward; their
    plain versions on CPU tensors) or "xla" (materialized logits, plain
    PyTorch). The default is "flash" for CUDA tensors, "xla" otherwise."""
    comm = mesh.comm(axis)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl is None:
        impl = "flash" if q.is_cuda else "xla"
    n, l = comm.n, comm.global_len(k, 2)
    if l % n:
        raise ValueError(f"seq {l} must be a multiple of the {axis!r} axis "
                         f"size {n}: pad it and pass kv_valid_len")
    if causal:
        zz, inv = zigzag_order(l, n)
        q, k, v = (comm.permute(x, 2, zz, inv) for x in (q, k, v))
    if impl == "flash":
        out = _RingFlash.apply(q, k, v, comm, float(scale), kv_valid_len,
                               bool(causal))
    elif impl == "xla":
        positions = (zz if causal else torch.arange(l)).to(
            device=q.device, dtype=torch.int32)
        out = _ring_attention_xla(q, k, v, comm, scale, kv_valid_len, causal,
                                  positions)
    else:
        raise ValueError(f"unknown ring impl {impl!r}")
    if causal:
        out = comm.permute(out, 2, inv, zz)
    return out


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, axis: str = SEQ_AXIS,
                      scale: Optional[float] = None,
                      kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """Exact attention through an all_to_all from sequence shards to head
    shards and back; needs heads % axis size == 0. ``kv_valid_len`` masks
    keys at global positions from it on (padded query rows give rows the
    caller slices off, as in :func:`ring_attention`)."""
    comm = mesh.comm(axis)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, h, l = comm.n, q.shape[1], comm.global_len(k, 2)
    if h % n:
        raise ValueError(f"heads {h} must divide over axis size {n}")
    # (B, H, L/n, D) per shard -> (B, H/n, L, D)
    qh, kh, vh = (comm.all_to_all(comm.shards(x, 2), 1, 2)
                  for x in (q, k, v))
    outs = []
    for a, b, c in zip(qh, kh, vh):
        mask = None
        if kv_valid_len is not None and kv_valid_len != l:
            mask = torch.arange(l, device=a.device) < kv_valid_len
        outs.append(_attention_with_lse(a, b, c, scale, mask)[0])
    return comm.unshard(comm.all_to_all(outs, 2, 1), 2)
