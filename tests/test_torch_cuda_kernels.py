"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false.
They import nothing of JAX, so on a machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: bf16 outputs to 2e-2 absolute (the bf16 flash tolerance of
tests/test_flash_attention.py), lse to 1e-3; GroupNorm bf16 to two bf16
ulps (rtol = atol = 1.6e-2), fp32 to 1e-4 against the two-pass version.
"""

import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as tattn
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as tgn

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("b,h,lq,lk,d", [
    (1, 1, 64, 64, 40), (2, 3, 100, 130, 40), (1, 2, 257, 63, 48),
    (2, 2, 65, 1000, 80), (1, 4, 128, 192, 72), (1, 1, 33, 77, 80),
    (2, 1, 100, 300, 512)])
def test_flash_kernel_matches_plain(gen, b, h, lq, lk, d):
    q, k, v = (_randn(gen, b, h, n, d) for n in (lq, lk, lk))
    out, lse = tfa.flash_attention_cuda(q, k, v)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert out.shape == (b, h, lq, d) and lse.shape == (b, h, lq)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_flash_kernel_reads_strided_views(gen):
    """q|k|v column slices of a fused projection, as the UNet passes them."""
    b, l, h, d = 2, 600, 8, 40
    qkv = _randn(gen, b, l, 3 * h * d)
    q, k, v = (t.reshape(b, l, h, d).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    n = tfa.flash_attention_cuda.launches
    got = tattn.dot_product_attention(q, k, v)
    assert tfa.flash_attention_cuda.launches == n + 1
    ref, _ = tfa.flash_attention_plain(q.contiguous(), k.contiguous(),
                                       v.contiguous())
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


def test_flash_kernel_refuses_what_it_does_not_take(gen):
    q = _randn(gen, 1, 1, 64, 40)
    with pytest.raises(TypeError):
        tfa.flash_attention_cuda(q.float(), q.float(), q.float())
    with pytest.raises(NotImplementedError):
        tfa.flash_attention_cuda(*(_randn(gen, 1, 1, 64, 64),) * 3)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q, q[..., 1:9], q[..., 1:9])
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, q, q, causal=True)


@pytest.mark.parametrize("shape", [(2, 5, 7, 320), (1, 16, 16, 960),
                                   (2, 4, 4, 1920), (1, 8, 8, 2560),
                                   (3, 33, 31, 128), (2, 9, 9, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_kernel_matches_plain(gen, shape, dtype, act):
    c = shape[-1]
    x = _randn(gen, *shape, dtype=torch.float32) * 2.0 + 0.5
    x = x.to(dtype)
    scale = 1.0 + 0.1 * _randn(gen, c, dtype=torch.float32)
    bias = 0.1 * _randn(gen, c, dtype=torch.float32)
    n = tgn.group_norm_cuda.launches
    got = tgn.group_norm(x, 32, scale, bias, 1e-5, act)
    assert tgn.group_norm_cuda.launches == n + 1
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        ref = tgn.group_norm_plain(x, 32, scale, bias, 1e-5, act)
        torch.testing.assert_close(got, ref, rtol=0.0, atol=1e-4)
    else:
        ref = tgn.group_norm_plain_one_pass(x, 32, scale, bias, 1e-5, act)
        torch.testing.assert_close(got.float(), ref.float(), rtol=1.6e-2,
                                   atol=1.6e-2)
