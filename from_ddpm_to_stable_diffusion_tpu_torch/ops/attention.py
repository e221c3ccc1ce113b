"""Attention dispatch (port of ``ops/attention.py``).

q, k, v are (B, H, L, D). On CUDA tensors, sequences with at least 512
queries and 512 keys go to the flash kernel (the JAX package's
``_flash_eligible`` rule); everything else, and everything on the CPU,
runs :func:`plain_attention`, the counterpart of the JAX ``_xla_attention``:
fp32 logits with the scale applied after the product, fp32 softmax, the
probabilities cast to the input dtype before the PV product.
:func:`joint_attention_blhd` is the MMDiT's attention over two streams.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, joint_flash_attention


def plain_attention(q, k, v, bias=None, causal: bool = False,
                    scale: Optional[float] = None):
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        q_len, k_len = logits.shape[-2:]
        mask = torch.ones((q_len, k_len), dtype=torch.bool,
                          device=q.device).tril(k_len - q_len)
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _flash_eligible(q, k) -> bool:
    return q.is_cuda and q.shape[-2] >= 512 and k.shape[-2] >= 512


def dot_product_attention(q, k, v, bias=None, causal: bool = False,
                          scale: Optional[float] = None,
                          use_flash: Optional[bool] = None, segment_ids=None,
                          seg_max_kv_blocks: Optional[int] = None):
    """Scaled dot-product attention over (B, H, L, D) tensors.

    ``use_flash``: ``None`` follows :func:`_flash_eligible`; ``True`` forces
    the flash kernels (CUDA tensors only: on CPU tensors it raises, there is
    no kernel to force) and ``False`` forces :func:`plain_attention`.

    ``segment_ids``: optional (q_ids (B, Lq), kv_ids (B, Lk)) masking of
    packed sequences to same-id pairs. ``seg_max_kv_blocks``: the JAX
    package's static bound for packed layouts, validated on the flash path
    and ignored on the plain one (see :func:`flash_attention`).

    ``causal`` on the flash path counts rows and columns from index 0 (the
    kernels' rule), on the plain path it aligns the diagonal bottom-right,
    as the JAX package does; the two agree for Lq = Lk."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_flash is None:
        use_flash = _flash_eligible(q, k)
    elif use_flash and not q.is_cuda:
        raise ValueError("use_flash=True needs CUDA tensors: the flash "
                         "kernels do not run on the CPU")
    if use_flash:
        return flash_attention(q, k, v, bias=bias, segment_ids=segment_ids,
                               causal=causal, scale=scale,
                               seg_max_kv_blocks=seg_max_kv_blocks)
    if segment_ids is not None:
        same = (segment_ids[0][:, None, :, None]
                == segment_ids[1][:, None, None, :])
        seg_bias = torch.where(same, 0.0, -1e30)
        bias = seg_bias if bias is None else bias + seg_bias
    return plain_attention(q, k, v, bias, causal, scale)


def attention_blhd(q, k, v, bias=None, causal: bool = False, **kw):
    """Attention over (B, L, H, D) tensors; output (B, L, H, D)."""
    out = dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), bias=bias, causal=causal,
                                **kw)
    return out.transpose(1, 2)


def multi_head_attention(q, k, v, num_heads: int, bias=None,
                         causal: bool = False, **kw):
    """Attention over (B, L, D_model) activations with head split/merge."""
    b, lq, dm = q.shape
    lk = k.shape[1]
    d = dm // num_heads
    out = attention_blhd(q.reshape(b, lq, num_heads, d),
                         k.reshape(b, lk, num_heads, d),
                         v.reshape(b, lk, num_heads, d),
                         bias=bias, causal=causal, **kw)
    return out.reshape(b, lq, dm)


def joint_attention_blhd(ctx_qkv, x_qkv, stability: str = "online"):
    """MMDiT joint attention over [context | x]. Inputs are (q, k, v)
    triples in (B, L, H, D); returns (ctx_out, x_out) in the same layout.

    The JAX package's rule: when the x stream is flash eligible (CUDA, at
    least 512 queries and keys) the streams are not concatenated and all
    four query-stream x key-stream pairs go to the position-masked flash
    kernel, the short context pairs too, merged through their
    log-sum-exps; otherwise the streams are concatenated and attended by
    :func:`plain_attention`."""
    qc, kc, vc = (a.transpose(1, 2) for a in ctx_qkv)
    qx, kx, vx = (a.transpose(1, 2) for a in x_qkv)
    scale = qx.shape[-1] ** -0.5
    if _flash_eligible(qx, kx):
        oc, ox = joint_flash_attention(qc, kc, vc, qx, kx, vx, scale,
                                       stability)
    else:
        lc = qc.shape[2]
        q, k, v = (torch.cat(ab, dim=2)
                   for ab in ((qc, qx), (kc, kx), (vc, vx)))
        out = plain_attention(q, k, v, None, False, scale)
        oc, ox = out[:, :, :lc], out[:, :, lc:]
    return oc.transpose(1, 2), ox.transpose(1, 2)
