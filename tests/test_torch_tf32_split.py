"""The numerical plan of the fp32 flash kernels on the tensor cores, on the
CPU: a PyTorch emulation of their three-term TF32 split inside an attention
forward (with and without T5's bias) and backward, held against the JAX
package's fp32 flash forward and backward (the Pallas kernels in interpret
mode, every dot at ``Precision.HIGHEST``).

The kernel (``csrc/fp32/flash_f32_fwd.cu``) takes each fp32 operand x as
x_hi = tf32(x) and x_lo = tf32(x - x_hi) (tf32: rounded to nearest, ties
away, to 10 mantissa bits, as ``cvt.rna.tf32.f32``) and each product as
A_lo B_hi + A_hi B_lo + A_hi B_hi with fp32 accumulation, for S = Q K^T and
for P V with P split from its fp32 value; the softmax and the row sums stay
fp32. A product of two TF32 values is exact in fp32, so the emulation below
computes what the tensor cores compute, up to the order of the fp32 sums.
Tolerances: the split within 1e-5 of the Pallas fp32 forward (out and lse,
values of order 1); a single TF32 pass (each operand cut to TF32 once)
outside 1e-4, the tolerance the card holds the kernel to, so the plan is
what separates the two. Inputs from a numpy seed, at head dims 40 (SD1's
UNet), 64 (SigLIP, TinyVLM, SD3, T5) and 512 (the VAEs).

The backward (``csrc/fp32/flash_f32_bwd.cu``) splits all five of its
products the same way, P and dS from their fp32 values: S = Q K^T,
dP = dO V^T, dq = scale dS K, dk = scale dS^T Q, dv = P^T dO. Its emulation
is held against the Pallas backward (``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` in interpret mode through the JAX custom VJP, which
takes them whenever ``interpret=True``) within 1e-5 of each gradient's
largest magnitude, and the same products in one TF32 pass fall outside
1e-4, at head dims 64 (TinyVLM, MMDiT) and 128 (tiny-SD). Above 128
(``csrc/fp32/flash_f32_bwd.cuh``) a pair of blocks splits the columns: S
and dP are the sum of the two halves' partial products, each its own chain,
and dq (dk, dv) sums a fresh product per key (query) tile; the emulation
takes that order at head dims 160, 192 (tiny-SD at ``channel: 320`` and
``96``) and 256.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

SPLIT_ATOL = 1e-5
ONE_PASS_FLOOR = 1e-4


def _tf32_round(x):
    """x rounded to TF32 (10 mantissa bits, nearest, ties away from 0)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_cut(x):
    """x cut to TF32 (its top 19 bits), what one pass reads of it."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32_round(x)
    return hi, _tf32_round(x - hi)


def _split_matmul(a, b):
    """a @ b as the kernel's three TF32 passes: lo hi + hi lo + hi hi."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _attention(q, k, v, scale, matmul, bias=None):
    """(out, lse) with both products through ``matmul``, the softmax in
    fp32; ``bias`` added to the scaled logits in fp32, as the kernel adds
    its staged tile after the three-term product."""
    s = matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = matmul(p, v) / l
    return out, (m + torch.log(l)).squeeze(-1)


def _one_pass(a, b):
    return _tf32_cut(a) @ _tf32_cut(b)


@pytest.mark.parametrize("d,lq,lk", [(40, 256, 300), (64, 256, 256),
                                     (512, 128, 200)])
def test_three_term_tf32_split_matches_pallas_fp32(d, lq, lk):
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((1, 2, n, d)).astype(np.float32) * s
               for n, s in ((lq, 0.7), (lk, 0.7), (lk, 1.0)))
    scale = d ** -0.5
    want_out, want_lse = (np.asarray(x) for x in jfa._flash_fwd(
        *map(jnp.asarray, (q, k, v)), None, None, False, scale, 128, 128,
        interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = _attention(tq, tk, tv, scale, _split_matmul)
    assert np.abs(out.numpy() - want_out).max() <= SPLIT_ATOL
    assert np.abs(lse.numpy() - want_lse).max() <= SPLIT_ATOL
    bad, _ = _attention(tq, tk, tv, scale, _one_pass)
    assert np.abs(bad.numpy() - want_out).max() > ONE_PASS_FLOOR


def test_three_term_tf32_split_with_t5_bias_matches_pallas_fp32():
    """The bias form as T5 reaches it: scale 1.0, a (1, H, Lq, Lk) bias
    shared over the batch (of T5's magnitude, a few units), d = 64."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 2, n, 64)).astype(np.float32) * s
               for n, s in ((200, 0.3), (260, 0.3), (260, 1.0)))
    bias = (rng.standard_normal((1, 2, 200, 260)) * 3).astype(np.float32)
    want_out, want_lse = (np.asarray(x) for x in jfa._flash_fwd(
        *map(jnp.asarray, (q, k, v, bias)), None, False, 1.0, 128, 128,
        interpret=True))
    tq, tk, tv, tb = map(torch.from_numpy, (q, k, v, bias))
    out, lse = _attention(tq, tk, tv, 1.0, _split_matmul, tb)
    assert np.abs(out.numpy() - want_out).max() <= SPLIT_ATOL
    assert np.abs(lse.numpy() - want_lse).max() <= SPLIT_ATOL
    bad, _ = _attention(tq, tk, tv, 1.0, _one_pass, tb)
    assert np.abs(bad.numpy() - want_out).max() > ONE_PASS_FLOOR


def _backward(q, k, v, g, lse, delta, scale, matmul):
    """(dq, dk, dv) with all five products through ``matmul``: P and dS in
    fp32, then split by the products that take them."""
    p = torch.exp(matmul(q, k.transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (matmul(g, v.transpose(-1, -2)) - delta[..., None])
    return (matmul(ds, k) * scale, matmul(ds.transpose(-1, -2), q) * scale,
            matmul(p.transpose(-1, -2), g))


def _backward_wide(q, k, v, g, lse, delta, scale, matmul):
    """(dq, dk, dv) in the order of the two-block kernels above head dim
    128: the columns padded to DP (d rounded up to 32) and split into two
    halves of DH = DP / 2, S and dP the sum of the halves' partials; dq a
    sum over key tiles of 32 (16 above DP = 192), dk and dv over query
    tiles of 32 (16 above DP = 160), each tile's product fresh and each
    half of the columns (dk and dv: each quarter) its own."""
    d = q.shape[-1]
    dp = -(-d // 32) * 32
    q, k, v, g = (torch.nn.functional.pad(x, (0, dp - d))
                  for x in (q, k, v, g))
    halves = (slice(0, dp // 2), slice(dp // 2, dp))
    part = lambda a, b: [matmul(a[..., c], b[..., c].transpose(-1, -2))
                         for c in halves]
    s0, s1 = part(q, k)
    p = torch.exp((s0 + s1) * scale - lse[..., None])
    d0, d1 = part(g, v)
    ds = p * ((d0 + d1) - delta[..., None])

    def tiled(a, b, tile, chunks):
        """a @ b as a sum over tiles of the reduced axis, each tile's
        product of each column chunk of b on its own."""
        out = torch.zeros(*a.shape[:-1], b.shape[-1])
        width = b.shape[-1] // chunks
        for t0 in range(0, a.shape[-1], tile):
            for c0 in range(0, b.shape[-1], width):
                out[..., c0:c0 + width] += matmul(
                    a[..., t0:t0 + tile], b[..., t0:t0 + tile, c0:c0 + width])
        return out

    bk, bq = (32 if dp <= 192 else 16), (32 if dp <= 160 else 16)
    dq = tiled(ds, k, bk, 2) * scale
    dk = tiled(ds.transpose(-1, -2), q, bq, 4) * scale
    dv = tiled(p.transpose(-1, -2), g, bq, 4)
    return dq[..., :d], dk[..., :d], dv[..., :d]


@pytest.mark.parametrize("d,lq,lk", [(64, 256, 300), (128, 200, 260),
                                     (160, 200, 260), (192, 200, 260),
                                     (256, 200, 260)])
def test_three_term_tf32_split_backward_matches_pallas_fp32(d, lq, lk):
    rng = np.random.default_rng(100 + d)
    q, k, v, g = (rng.standard_normal((1, 2, n, d)).astype(np.float32) * s
                  for n, s in ((lq, 0.7), (lk, 0.7), (lk, 1.0), (lq, 1.0)))
    scale = d ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jfa._flash_fwd(jq, jk, jv, None, None, False, scale, 128, 128,
                              interpret=True)
    _, vjp = jax.vjp(lambda *x: jfa.flash_attention(
        *x, block_q=128, block_k=128, interpret=True), jq, jk, jv)
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    tlse = torch.from_numpy(np.array(lse))
    delta = (tg * torch.from_numpy(np.array(out))).sum(-1)
    backward = _backward if d <= 128 else _backward_wide
    got = backward(tq, tk, tv, tg, tlse, delta, scale, _split_matmul)
    bad = backward(tq, tk, tv, tg, tlse, delta, scale, _one_pass)
    for name, a, b_, w in zip(("dq", "dk", "dv"), got, bad, want):
        top = np.abs(w).max()
        assert np.abs(a.numpy() - w).max() <= SPLIT_ATOL * top, name
        assert np.abs(b_.numpy() - w).max() > ONE_PASS_FLOOR * top, name


def test_tf32_rounding_keeps_ten_mantissa_bits():
    """The emulated cvt.rna: 10 explicit mantissa bits, the low 13 zero,
    ties away from zero; hi + lo represents x to ~2^-22 of it."""
    one = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                        1.0 + 2 ** -12])
    got = _tf32_round(one)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                            -(1.0 + 2 ** -10), 1.0]
    assert not bool((got.view(torch.int32) & 0x1FFF).any())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32))
    hi, lo = _split(x)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21
