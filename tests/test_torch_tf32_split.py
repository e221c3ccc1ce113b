"""The numerical plan of the fp32 flash forward on the tensor cores, on the
CPU: a PyTorch emulation of its three-term TF32 split inside an attention
forward, held against the JAX package's fp32 flash forward (the Pallas
kernel in interpret mode, every dot at ``Precision.HIGHEST``).

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
UNet), 64 (SigLIP, TinyVLM, SD3) and 512 (the VAEs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa

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


def _attention(q, k, v, scale, matmul):
    """(out, lse) with both products through ``matmul``, the softmax in
    fp32."""
    s = matmul(q, k.transpose(-1, -2)) * scale
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
