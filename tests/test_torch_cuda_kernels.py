"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false.
They import nothing of JAX, so on a machine without it run them as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: bf16 outputs to 2e-2 absolute (the bf16 flash tolerance of
tests/test_flash_attention.py), lse to 1e-3; GroupNorm bf16 to two bf16
ulps (rtol = atol = 1.6e-2), fp32 to 1e-4 against the two-pass version.
Flash backward (K3 dq, K4 dk and dv), bf16 against the plain backward on
the same inputs: each gradient to 2e-2 of its largest magnitude, five bf16
ulps (both round P and dS to bf16 before their products and their outputs
to bf16, so they differ by output roundings, a few flipped roundings of P
and dS, and the fp32 summation order). The GroupNorm autograd backward is
plain PyTorch on every device: on the card it must equal the same function
on the same tensors.
The position-masked forward (K5) against its plain version: out to 2e-2 on
the rows that see a key, lse to 1e-3 there; rows that see none must give
out = 0 exactly and lse <= -1e29. The joint attention against plain
attention over the concatenated sequence: 2e-2 (two bf16 partials merged).
The position-masked backward (K6 dq, K7 dk and dv) against its plain version
under the same global lse and delta: as K3 / K4, 2e-2 of each gradient's
largest magnitude; rows that see no key, here or anywhere, give finite
gradients. The joint attention's gradients against autograd through plain
attention over the concatenated sequence: 3e-2 of the largest magnitude.
The causal, bias and segment-id forms of K1, K3 and K4 against the plain
versions under the same masks: the same tolerances; dbias (fp32 dS tiles
summed over the bias's broadcast axes) to 2e-2 of its largest magnitude;
rows that see no key give out = 0, lse <= -1e29 and finite gradients.
K1 on TMA and wgmma (``csrc/flash_attention_sm90.cu``) at the same
tolerances, at lengths around its 128-row tiles, on fused-projection slices,
with broadcast biases, segment ids at its tiles, and into out / lse buffers
filled with NaN; its launches counted by route. K4 on TMA and wgmma
(``csrc/flash_attention_bwd_sm90.cu``) the same way at its (64, 128) tiles,
in every form at head dims 64 and 128, with the floor above where one key
makes dS rounding noise; K1 at head dim 512 (``csrc/flash_attention.cu``)
across its key splits, each split count forced, and into NaN buffers.
K5 and K7 on TMA and wgmma (the position-mask forms of the same two
kernels) at the same tolerances: SD3's four joint-attention shapes on
fused-projection slices (K7 under the lse merged over both streams), the
masked cases of chip_smoke.py at head dims 64 and 128, segment boundaries
inside a tile, a query tile that sees no key tile, lengths around the
tiles, NaN-filled outputs, the joint attention at 154 + 4096 tokens; their
launches counted by route.
The fp32 forms of K1, K3 - K7 against the plain fp32 versions (TF32 off):
out and lse to 1e-4 absolute, each gradient to 1e-4 of its largest
magnitude; the plain version fed operands rounded once to bf16 must fall
outside that, so a kernel that rounded an operand would be caught.
K3 on TMA and wgmma (``csrc/flash_attention_dq_sm90.cu``) as K4 is, at its
(128, 64) tiles, dbias into a NaN-poisoned pool; K6, its position-mask form,
as K7 is (SD3's four shapes under the merged lse, the masked cases at head
dims 64 and 128, a segment boundary inside a tile, lengths around its
tiles, a NaN-filled dq whose skipped rows must be written as 0). K2 (one
cooperative launch a call) at chip_smoke.py's GroupNorm shapes in bf16 and
fp32, where it keeps x in shared memory and where it streams it, two calls
bitwise equal, into NaN-filled outputs and scratch, and 20 calls of mixed
shapes queued back to back. The fp32 forward on the
tensor cores (three-term TF32 split, ``csrc/fp32/flash_f32_fwd.cu``) also
within 1e-5 of fp64 attention, with the plain version fed operands cut
once to TF32 (one pass) outside 1e-4, at every head dim, length around its
tiles, key split at d = 512, and K5's mask cases. "fp64" references are
the plain versions fed fp64 tensors, which they compute in fp64 throughout.
K1 at the SD1 UNet's head dims from 768^2 (160 at level 2, 80 at level 1),
bf16 and fp32, at the tolerances above; K1's fp32 bias form at T5's shape
and with rows a bias hides whole (out = 0, lse <= -1e29, nothing NaN). The
fp32 backward on the tensor cores (``csrc/fp32/flash_f32_bwd.cu``) at every
form it serves against plain attention in fp64: each gradient within 1e-5
of its largest magnitude, and the plain version fed once-truncated TF32
operands (one pass) outside 1e-4; ragged lengths, causal, the position
masks at SD3's joint shapes and 4096 keys, where one long accumulator
chain would drift. Above head dim 128 (``csrc/fp32/flash_f32_bwd.cuh``, a
cluster of two blocks splitting the columns) at d 136, 160, 192, 232 and
256, without a mask and causal, at lengths around its tiles: one short tile
each way and ragged Lq != Lk both ways.
K1, K3 and K4 above head dim 256 (``csrc/flash_attention.cu``,
``csrc/flash_attention_wide_bwd_sm90.cuh``, and in fp32
``csrc/fp32/flash_f32_fwd_wide.cuh`` and ``flash_f32_bwd_stream.cuh``) at
head dims 264, 300, 384 and 512 in every mask form and both dtypes, at the
tolerances above (fp32: 1e-4 against plain fp32, 1e-5 against fp64, one
TF32 pass caught): lengths around their 32- and 64-row tiles, segment ids
with rows that see no key, each key-split count of K1 forced under causal
and segment ids, NaN-filled outputs and dbias from a NaN-poisoned pool;
K4's dk and dv one launch of cluster pairs; a causal diagonal at ragged
lengths; dbias written once per tile at width 512. K5, K6 and K7 above
head dim 256 (K1's
kernel of ``csrc/flash_attention.cu`` under the position masks, the wide
backward kernel, the fp32 streaming kernels) at 264, 300, 384 and 512 in
the position forms (causal, ``valid_len``, two offset segments, a launch
past ``valid_len``), online and bounded, against the plain versions (bf16:
out 2e-2, lse 1e-3, each gradient 2e-2 of its largest; fp32 against fp64,
1e-5 of each largest); each key-split count of K5 forced under the masks;
NaN-filled outputs written on every row; the joint attention at heads of
384 and the ring hop at 512.
The int8 product of the W8A8 serving path (``ops/quantize.py``, a
``torch._int_mm`` library call): its int32 accumulators equal the exact
product (fp64 of the same int8 operands) at the MMDiT's, T5's and the SD1
UNet's operand shapes, with 16 rows or fewer padded; K or N off a multiple
of 8 raises, and nothing falls back to a float product.
"""

import itertools

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
    (2, 1, 100, 300, 512), (1, 2, 1000, 777, 128), (2, 1, 33, 200, 128),
    (1, 1, 130, 17, 128)])
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
    with pytest.raises(TypeError):         # bf16 and fp32 only
        tfa.flash_attention_cuda(q.half(), q.half(), q.half())
    assert tfa.flash_attention_cuda(q.float(), q.float(),
                                    q.float())[0].dtype == torch.float32
    q320 = _randn(gen, 1, 1, 64, 320)      # every head dim up to 512
    _k1_check(q320, q320, q320)
    with pytest.raises(NotImplementedError):   # head dims 1 to 512
        tfa.flash_attention_cuda(*(_randn(gen, 1, 1, 64, 520),) * 3)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q, q[..., 1:9], q[..., 1:9])
    q, k, v, g = (_randn(gen, 1, 1, 64, 512) for _ in range(4))
    _k1_check(q, k, v, causal=True)        # every mask form at 512
    out, lse = tfa.flash_attention_cuda(q, k, v)
    _bwd_close(tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g),
               tfa.flash_attention_bwd_plain(q, k, v, out, lse, g))


def _bwd_close(got, want):
    for a, w in zip(got, want):
        a, w = a.float(), w.float()
        tol = 2e-2 * w.abs().max().item()
        assert (a - w).abs().max().item() <= tol


@pytest.mark.parametrize("b,h,lq,lk", [
    (1, 2, 1000, 777), (2, 1, 40, 40), (1, 1, 63, 200), (1, 2, 300, 50),
    (1, 1, 4096, 64)])
def test_flash_backward_kernels_match_plain(gen, b, h, lq, lk):
    """Ragged Lq and Lk, L < 64, Lq != Lk, at head dim 128."""
    d = 128
    q, g = (_randn(gen, b, h, lq, d) for _ in range(2))
    k, v = (_randn(gen, b, h, lk, d) for _ in range(2))
    out, lse = tfa.flash_attention_cuda(q, k, v)
    n3 = tfa.flash_attention_bwd_dq_cuda.launches
    n4 = tfa.flash_attention_bwd_dkv_cuda.launches
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g)
    assert tfa.flash_attention_bwd_dq_cuda.launches == n3 + 1
    assert tfa.flash_attention_bwd_dkv_cuda.launches == n4 + 1
    for a, x in zip(got, (q, k, v)):
        assert a.dtype == torch.bfloat16 and a.shape == x.shape
    _bwd_close(got, tfa.flash_attention_bwd_plain(q, k, v, out, lse, g))


def test_flash_backward_reads_strided_slices_and_dout(gen):
    """q|k|v column slices of one fused projection and a dO that is a
    (B, H, L, D) view of (B, L, H·D) memory, and one that is not
    contiguous in the head dim (copied first)."""
    b, l, h, d = 2, 600, 2, 128
    qkv = _randn(gen, b, l, 3 * h * d)
    q, k, v = (t.reshape(b, l, h, d).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    out, lse = tfa.flash_attention_cuda(q, k, v)
    g = _randn(gen, b, l, h * d).reshape(b, l, h, d).transpose(1, 2)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g)
    _bwd_close(tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g), want)
    g_t = g.contiguous().transpose(-1, -2).contiguous().transpose(-1, -2)
    assert g_t.stride(-1) != 1
    _bwd_close(tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g_t), want)


def test_flash_autograd_launches_the_kernels(gen):
    """Through attention dispatch and autograd, as the trainer runs it."""
    b, l, h, d = 2, 1024, 2, 128
    qkv = _randn(gen, b, l, 3 * h * d).requires_grad_()
    counts = lambda: (tfa.flash_attention_cuda.launches,
                      tfa.flash_attention_bwd_dq_cuda.launches,
                      tfa.flash_attention_bwd_dkv_cuda.launches)
    n = counts()
    q, k, v = qkv.chunk(3, dim=-1)
    out = tattn.multi_head_attention(q, k, v, h)
    g = _randn(gen, b, l, h * d)
    out.backward(g)
    assert counts() == (n[0] + 1, n[1] + 1, n[2] + 1)
    ref = qkv.detach().clone().requires_grad_()
    rq, rk, rv = (t.reshape(b, l, h, d).transpose(1, 2)
                  for t in ref.chunk(3, dim=-1))
    ro, rl = tfa.flash_attention_plain(rq, rk, rv)
    want = tfa.flash_attention_bwd_plain(rq, rk, rv, ro, rl,
                                         g.reshape(b, l, h, d).transpose(1, 2))
    got = [t.reshape(b, l, h, d).transpose(1, 2)
           for t in qkv.grad.chunk(3, dim=-1)]
    _bwd_close(got, want)


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


@pytest.mark.parametrize("shape,act", [((4, 16, 16, 128), "silu"),
                                       ((2, 8, 8, 256), None)])
def test_group_norm_autograd_on_the_card(gen, shape, act):
    """Forward through K2, backward the plain ``_fused_bwd`` port."""
    c = shape[-1]
    x = (_randn(gen, *shape, dtype=torch.float32) * 2 + 0.5).to(
        torch.bfloat16).requires_grad_()
    scale = (1.0 + 0.1 * _randn(gen, c, dtype=torch.float32)).requires_grad_()
    bias = (0.1 * _randn(gen, c, dtype=torch.float32)).requires_grad_()
    dy = _randn(gen, *shape)
    n = tgn.group_norm_cuda.launches
    tgn.group_norm(x, 32, scale, bias, 1e-5, act).backward(dy)
    assert tgn.group_norm_cuda.launches == n + 1
    want = tgn.group_norm_bwd_plain(x.detach(), scale.detach(),
                                    bias.detach(), dy, 32, 1e-5, act)
    for a, w in zip((x.grad, scale.grad, bias.grad), want):
        assert a.dtype == w.dtype
        torch.testing.assert_close(a, w, rtol=0, atol=0)


# chip_smoke.py's K2 cases (its gn_cases, each in both dtypes): the SD1
# UNet at 512^2 with CFG batch 2 (and batch 8), the SD1 VAE decoder's
# 512^2 level, tiny-SD's batch 32, the SD3 VAE decoder at 1024^2; the
# smaller ones keep their rows in shared memory, the larger stream them.
GN_SMOKE_CASES = [((2, 64, 64, 320), "silu"), ((2, 32, 32, 640), "silu"),
                  ((2, 8, 8, 1280), "silu"), ((8, 64, 64, 320), "silu"),
                  ((1, 512, 512, 128), None), ((32, 64, 64, 128), "silu"),
                  ((1, 1024, 1024, 128), "silu"), ((1, 128, 128, 512), "silu")]


def _gn_inputs(gen, shape, dtype):
    c = shape[-1]
    x = (_randn(gen, *shape, dtype=torch.float32) * 2.0 + 0.5).to(dtype)
    scale = 1.0 + 0.1 * _randn(gen, c, dtype=torch.float32)
    bias = 0.1 * _randn(gen, c, dtype=torch.float32)
    return x, scale, bias


def _gn_close(got, x, scale, bias, act):
    """K2 against the plain version of x's dtype: fp32 to 1e-4 absolute
    against two-pass statistics, bf16 to two ulps against one-pass."""
    if x.dtype == torch.float32:
        ref = tgn.group_norm_plain(x, 32, scale, bias, 1e-5, act)
        torch.testing.assert_close(got, ref, rtol=0.0, atol=1e-4)
    else:
        ref = tgn.group_norm_plain_one_pass(x, 32, scale, bias, 1e-5, act)
        torch.testing.assert_close(got.float(), ref.float(), rtol=1.6e-2,
                                   atol=1.6e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape,act", GN_SMOKE_CASES)
def test_group_norm_kernel_at_the_smoke_shapes(gen, shape, act, dtype):
    """One launch per call, against the plain version; a second call on
    the same input gives the same bits (the statistics are merged in one
    fixed order in every block)."""
    x, scale, bias = _gn_inputs(gen, shape, dtype)
    n = tgn.group_norm_cuda.launches
    got = tgn.group_norm_cuda(x, 32, scale, bias, 1e-5, act)
    again = tgn.group_norm_cuda(x, 32, scale, bias, 1e-5, act)
    assert tgn.group_norm_cuda.launches == n + 2
    assert torch.equal(got, again)
    _gn_close(got, x, scale, bias, act)


def test_group_norm_kernel_writes_every_element(gen, monkeypatch):
    """y and the partials' scratch are handed to the kernel filled with NaN,
    in both regimes and dtypes: every element of y must be written, and no
    partial read before it is written."""
    empty_like, empty = torch.empty_like, torch.empty
    for shape, dtype in itertools.product(
            ((2, 9, 9, 1280), (2, 64, 64, 320), (1, 256, 256, 256)),
            (torch.bfloat16, torch.float32)):
        x, scale, bias = _gn_inputs(gen, shape, dtype)
        for buf in tgn._scratch.values():   # the streams' partials
            buf.fill_(float("nan"))
        with monkeypatch.context() as m:
            m.setattr(torch, "empty_like", lambda t: empty_like(t).fill_(
                float("nan")))
            m.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).fill_(
                float("nan")))
            got = tgn.group_norm_cuda(x, 32, scale, bias, 1e-5, "silu")
        assert bool(torch.isfinite(got).all())
        _gn_close(got, x, scale, bias, "silu")


def test_group_norm_kernel_back_to_back(gen):
    """20 calls of mixed shapes, regimes and dtypes queued without a
    synchronisation between them: each grid barrier must hold its own call
    (a barrier that passed early or hung would show here)."""
    cases = [((2, 64, 64, 320), torch.bfloat16, "silu"),
             ((1, 256, 256, 256), torch.bfloat16, None),
             ((2, 16, 16, 1920), torch.float32, "silu"),
             ((32, 32, 32, 128), torch.float32, None),
             ((3, 33, 31, 128), torch.bfloat16, "silu")]
    inputs = [(_gn_inputs(gen, shape, dtype), act)
              for shape, dtype, act in cases]
    got = [tgn.group_norm_cuda(*inputs[i % 5][0][:1], 32,
                               *inputs[i % 5][0][1:], 1e-5, inputs[i % 5][1])
           for i in range(20)]
    torch.cuda.synchronize()
    for i, y in enumerate(got):
        (x, scale, bias), act = inputs[i % 5]
        if i >= 5:
            assert torch.equal(y, got[i - 5])
        else:
            _gn_close(y, x, scale, bias, act)


# ------------------------------------------------ K5, position-masked forward
def _offsets(a, b):
    return torch.tensor([a, b], dtype=torch.int32, device="cuda")


def _pos_check(q, k, v, qo, ko, **kw):
    n = tfa.flash_attention_pos_cuda.launches
    out, lse = tfa.flash_attention_pos(q, k, v, qo, ko, **kw)
    assert tfa.flash_attention_pos_cuda.launches == n + 1
    ref, ref_lse = tfa.flash_attention_pos_plain(q, k, v, qo, ko, **kw)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    seen = ref_lse > -1e29
    if bool(seen.any()):
        assert (out.float() - ref.float())[seen].abs().max().item() <= 2e-2
        assert (lse - ref_lse)[seen].abs().max().item() <= 1e-3
    assert bool((lse[~seen] <= -1e29).all())
    assert not bool(out[~seen].any())
    return seen


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("b,h,lq,lk,d", [
    (2, 3, 154, 154, 64), (1, 2, 154, 700, 64), (1, 2, 700, 154, 64),
    (1, 2, 512, 512, 64), (2, 1, 33, 1000, 128), (1, 1, 257, 63, 128),
    (1, 1, 1, 1, 64)])
def test_pos_kernel_unmasked_matches_plain(gen, stability, b, h, lq, lk, d):
    q, k, v = (_randn(gen, b, h, n, d) for n in (lq, lk, lk))
    z = _offsets(0, 0)
    seen = _pos_check(q, k, v, z, z, stability=stability)
    assert bool(seen.all())
    ref, ref_lse = tfa.flash_attention_plain(q, k, v)
    out, lse = tfa.flash_attention_pos(q, k, v, z, z, stability=stability)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("causal,valid_len", [(True, None), (False, 300),
                                              (True, 300), (False, 0),
                                              (True, 5)])
@pytest.mark.parametrize("d", [64, 128])
def test_pos_kernel_two_segments_masks(gen, stability, causal, valid_len, d):
    """Zig-zag layout: each side holds two chunks of a longer sequence, so
    whole tiles are skipped, some are half masked, and some rows see no
    key at all."""
    lq, lk, seg_q, seg_k = 200, 330, 128, 130
    q, k, v = (_randn(gen, 1, 2, n, d) for n in (lq, lk, lk))
    qo, ko = _offsets(128, 640), _offsets(0, 512)
    seen = _pos_check(q, k, v, qo, ko, causal=causal, valid_len=valid_len,
                      seg_q=seg_q, seg_k=seg_k, stability=stability)
    if valid_len == 0:
        assert not bool(seen.any())
    ko2 = _offsets(400, 900)    # causal: the first q segment sees nothing
    seen = _pos_check(q, k, v, qo, ko2, causal=causal, valid_len=valid_len,
                      seg_q=seg_q, seg_k=seg_k, stability=stability)
    if causal:
        assert not bool(seen[:, :, :seg_q].any())


def test_pos_kernel_reads_strided_slices_and_scale(gen):
    """q, k, v as slices of the MMDiT's fused (B, L, 3, H, D) projection."""
    b, l, h, d = 2, 300, 4, 64
    qkv = _randn(gen, b, l, 3 * h * d).reshape(b, l, 3, h, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    z = _offsets(0, 0)
    _pos_check(q, k, v, z, z, scale=0.2)
    out, _ = tfa.flash_attention_pos(q, k, v, z, z)
    assert out.transpose(1, 2).is_contiguous()      # (B, L, H, D) memory


def test_pos_kernel_refuses_what_it_does_not_take(gen):
    q = _randn(gen, 1, 1, 64, 64)
    z = _offsets(0, 0)
    with pytest.raises(TypeError):         # bf16 and fp32 only
        tfa.flash_attention_pos(q.half(), q.half(), q.half(), z, z)
    assert tfa.flash_attention_pos(q.float(), q.float(), q.float(), z,
                                   z)[0].dtype == torch.float32
    q40 = _randn(gen, 1, 1, 64, 40)    # every head dim up to 512
    out, lse = tfa.flash_attention_pos(q40, q40, q40, z, z)
    ref, ref_lse = tfa.flash_attention_pos_plain(q40, q40, q40, z, z)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    with pytest.raises(NotImplementedError, match="1 to 512"):
        tfa.flash_attention_pos(*(_randn(gen, 1, 1, 64, 520),) * 3, z, z)
    with pytest.raises(ValueError):
        tfa.flash_attention_pos(q, q, q, z.cpu(), z)
    with pytest.raises(ValueError):
        tfa.flash_attention_pos(q, q, q, z.long(), z)
    with pytest.raises(ValueError):
        tfa.flash_attention_pos(q, q, q, z, z, stability="fast")
    with pytest.raises(ValueError):
        tfa.flash_attention_pos(q, q, q, z, z, scale=-1.0)


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("lc,lx", [(154, 1024), (26, 512), (154, 300)])
def test_joint_attention_matches_concatenated_plain(gen, stability, lc, lx):
    """Through ``joint_attention_blhd``: an eligible x stream (>= 512) takes
    four K5 launches, a short one the concatenated plain attention."""
    b, h, d = 2, 3, 64
    ctx = [_randn(gen, b, lc, h, d) for _ in range(3)]
    x = [_randn(gen, b, lx, h, d) for _ in range(3)]
    n = tfa.flash_attention_pos_cuda.launches
    oc, ox = tattn.joint_attention_blhd(ctx, x, stability=stability)
    assert tfa.flash_attention_pos_cuda.launches == n + (4 if lx >= 512
                                                         else 0)
    q, k, v = (torch.cat([c, a], dim=1).transpose(1, 2)
               for c, a in zip(ctx, x))
    ref = tattn.plain_attention(q, k, v).transpose(1, 2)
    assert oc.shape == (b, lc, h, d) and ox.shape == (b, lx, h, d)
    got = torch.cat([oc, ox], dim=1)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2


# --------------------------------- K6 / K7, position-masked backward kernels
def _global_stats(q, kvs, g, qo, kos, **kw):
    """The merged lse of ``q`` over the key blocks ``kvs`` and delta = Σ dO·out
    with the merged output: what the caller of ``flash_bwd_pos`` holds."""
    out, lse = tfa.flash_attention_pos_plain(q, *kvs[0], qo, kos[0], **kw)
    for (k, v), ko in zip(kvs[1:], kos[1:]):
        out, lse = tfa.merge_attention_partials(
            out, lse, *tfa.flash_attention_pos_plain(q, k, v, qo, ko, **kw))
    return lse.contiguous(), (tfa._wide(g) * tfa._wide(out)).sum(-1)


def _pos_bwd_check(q, k, v, g, lse, delta, qo, ko, **kw):
    n6 = tfa.flash_bwd_pos_dq_cuda.launches
    n7 = tfa.flash_bwd_pos_dkv_cuda.launches
    got = tfa.flash_bwd_pos(q, k, v, g, lse, delta, qo, ko, **kw)
    assert tfa.flash_bwd_pos_dq_cuda.launches == n6 + 1
    assert tfa.flash_bwd_pos_dkv_cuda.launches == n7 + 1
    want = tfa.flash_bwd_pos_plain(q, k, v, g, lse, delta, qo, ko, **kw)
    for a, w, x in zip(got, want, (q, k, v)):
        assert a.dtype == torch.bfloat16 and a.shape == x.shape
        assert bool(torch.isfinite(a).all())
        a, w = a.float(), w.float()
        # five bf16 ulps of the largest gradient, and an absolute floor for
        # a gradient that is zero everywhere (nothing visible)
        assert (a - w).abs().max().item() <= 2e-2 * w.abs().max().item() + 1e-6
    return got


@pytest.mark.parametrize("b,h,lq,lk,d", [
    (2, 3, 154, 154, 64), (1, 2, 154, 700, 64), (1, 2, 529, 154, 64),
    (1, 2, 529, 529, 64), (2, 1, 33, 1000, 128), (1, 1, 257, 63, 128),
    (1, 1, 1, 1, 64)])
def test_pos_backward_kernels_unmasked_match_plain(gen, b, h, lq, lk, d):
    """Ragged Lq and Lk under the lse of this block alone; equal to the
    unmasked plain backward too."""
    q, g = (_randn(gen, b, h, lq, d) for _ in range(2))
    k, v = (_randn(gen, b, h, lk, d) for _ in range(2))
    z = _offsets(0, 0)
    lse, delta = _global_stats(q, [(k, v)], g, z, [z])
    got = _pos_bwd_check(q, k, v, g, lse, delta, z, z)
    out, lse1 = tfa.flash_attention_plain(q, k, v)
    for a, w in zip(got, tfa.flash_attention_bwd_plain(q, k, v, out, lse1, g)):
        # the floor: with one key dq is exactly 0 there and rounding noise here
        assert ((a.float() - w.float()).abs().max().item()
                <= 2e-2 * w.float().abs().max().item() + 1e-6)


@pytest.mark.parametrize("causal,valid_len", [(True, None), (False, 300),
                                              (True, 300), (False, 0),
                                              (True, 5)])
@pytest.mark.parametrize("d", [64, 128])
def test_pos_backward_kernels_two_segments_masks(gen, causal, valid_len, d):
    """Zig-zag layout under a global lse over two key blocks: tiles skipped,
    tiles half masked, rows that see a key only in the other block (causal:
    the first q segment sees nothing of the second block), and with
    valid_len = 0 rows that see none anywhere (lse = -1e30): finite
    gradients, and zero ones where nothing is visible."""
    lq, lk, seg_q, seg_k = 200, 330, 128, 130
    q, g = (_randn(gen, 1, 2, lq, d) for _ in range(2))
    kvs = [tuple(_randn(gen, 1, 2, lk, d) for _ in range(2)) for _ in range(2)]
    qo, kos = _offsets(128, 640), [_offsets(0, 512), _offsets(400, 900)]
    kw = dict(causal=causal, valid_len=valid_len, seg_q=seg_q, seg_k=seg_k)
    lse, delta = _global_stats(q, kvs, g, qo, kos, **kw)
    for (k, v), ko in zip(kvs, kos):
        dq, dk, dv = _pos_bwd_check(q, k, v, g, lse, delta, qo, ko, **kw)
        if valid_len == 0:
            assert not bool(dq.any() or dk.any() or dv.any())


def test_pos_backward_reads_strided_slices_and_dout(gen):
    """q, k, v as slices of the MMDiT's fused (B, L, 3, H, D) projection, dO
    a (B, H, L, D) view of (B, L, H·D) memory and one whose head dim is not
    contiguous (copied first); a scale other than the default."""
    b, l, h, d = 2, 300, 4, 64
    qkv = _randn(gen, b, l, 3 * h * d).reshape(b, l, 3, h, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    g = _randn(gen, b, l, h * d).reshape(b, l, h, d).transpose(1, 2)
    z = _offsets(0, 0)
    lse, delta = _global_stats(q, [(k, v)], g, z, [z], scale=0.2)
    got = _pos_bwd_check(q, k, v, g, lse, delta, z, z, scale=0.2)
    assert all(a.transpose(1, 2).is_contiguous() for a in got)
    g_t = g.contiguous().transpose(-1, -2).contiguous().transpose(-1, -2)
    assert g_t.stride(-1) != 1
    _pos_bwd_check(q, k, v, g_t, lse, delta, z, z, scale=0.2)


def test_pos_backward_kernels_refuse_what_they_do_not_take(gen):
    q = _randn(gen, 1, 1, 64, 64)
    z = _offsets(0, 0)
    st = torch.zeros(1, 1, 64, device="cuda")
    with pytest.raises(TypeError):         # bf16 and fp32 only
        tfa.flash_bwd_pos_dq_cuda(*(q.half(),) * 4, st, st, z, z)
    assert tfa.flash_bwd_pos_dq_cuda(*(q.float(),) * 4, st, st, z,
                                     z).dtype == torch.float32
    q40 = _randn(gen, 1, 1, 64, 40)    # every head dim up to 512
    lse40, delta40 = _global_stats(q40, [(q40, q40)], q40, z, [z])
    _pos_bwd_check(q40, q40, q40, q40, lse40, delta40, z, z)
    with pytest.raises(NotImplementedError, match="1 to 512"):
        tfa.flash_bwd_pos_dkv_cuda(*(_randn(gen, 1, 1, 64, 520),) * 4, st,
                                   st, z, z)
    with pytest.raises(ValueError):
        tfa.flash_bwd_pos_dq_cuda(q, q, q, q, st.double(), st, z, z)
    with pytest.raises(ValueError):
        tfa.flash_bwd_pos_dq_cuda(q, q, q, q, st, st, z.cpu(), z)
    with pytest.raises(ValueError):
        tfa.flash_bwd_pos_dkv_cuda(q, q, q, q[:, :, :32], st, st, z, z)


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("lc,lx", [(154, 1024), (26, 529)])
def test_joint_attention_backward_matches_concatenated_plain(gen, stability,
                                                             lc, lx):
    """Gradients through ``joint_attention_blhd`` (4 x K5 forward, 4 x K6 and
    4 x K7 backward, sums) against autograd through plain attention over the
    concatenated sequence: 3e-2 of each gradient's largest magnitude (two
    bf16 partials summed, on top of the kernels' own 2e-2)."""
    b, h, d = 2, 3, 64
    fused = [_randn(gen, b, n, 3, h, d).requires_grad_() for n in (lc, lx)]
    ctx, x = ([f[:, :, i] for i in range(3)] for f in fused)
    counts = lambda: (tfa.flash_attention_pos_cuda.launches,
                      tfa.flash_bwd_pos_dq_cuda.launches,
                      tfa.flash_bwd_pos_dkv_cuda.launches)
    n = counts()
    oc, ox = tattn.joint_attention_blhd(ctx, x, stability=stability)
    gc, gx = _randn(gen, b, lc, h, d), _randn(gen, b, lx, h, d)
    got = torch.autograd.grad((oc, ox), fused, (gc, gx))
    assert counts() == (n[0] + 4, n[1] + 4, n[2] + 4)
    q, k, v = (torch.cat([c, a], dim=1).transpose(1, 2)
               for c, a in zip(ctx, x))
    ref = tattn.plain_attention(q, k, v).transpose(1, 2)
    want = torch.autograd.grad(ref, fused, torch.cat([gc, gx], dim=1))
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        for i in range(3):     # dq, dk, dv: each against its own magnitude
            ai, wi = a[:, :, i].float(), w[:, :, i].float()
            assert ((ai - wi).abs().max().item()
                    <= 3e-2 * wi.abs().max().item())


# --------------------------------------------------------------------------
# The causal, bias and segment-id forms of K1, K3 and K4
# --------------------------------------------------------------------------
def _segments(kind, b, lq, lk):
    """(q_ids, kv_ids) int32 on the card, or None."""
    if kind is None:
        return None
    idx_q, idx_k = (torch.arange(n, device="cuda") for n in (lq, lk))
    if kind == "one":            # all one segment
        ids = lambda idx: torch.zeros_like(idx)
    elif kind == "each":         # every token its own segment
        ids = lambda idx: idx
    elif kind == "packed":       # sorted ragged sequences of ~L/5 tokens
        ids = lambda idx: (idx * 5) // max(lq, lk) + (idx > 37).int()
    elif kind == "ragged":       # real tokens id 0, query pad -1, key pad -2
        q_ids = torch.where(idx_q < lq - lq // 3, 0, -1)
        kv_ids = torch.where(idx_k < lk - lk // 4, 0, -2)
        return (q_ids.int()[None].expand(b, -1).contiguous(),
                kv_ids.int()[None].expand(b, -1).contiguous())
    elif kind == "no key":       # queries of segment 7 have no key at all
        q_ids = torch.where(idx_q % 50 == 3, 7, (idx_q * 3) // lq)
        kv_ids = (idx_k * 3) // lk
        return (q_ids.int()[None].expand(b, -1).contiguous(),
                kv_ids.int()[None].expand(b, -1).contiguous())
    return (ids(idx_q).int()[None].expand(b, -1).contiguous(),
            ids(idx_k).int()[None].expand(b, -1).contiguous())


MASK_CASES = [
    # b, h, lq, lk, d, causal, bias shape (None: no bias), segments
    (2, 3, 584, 584, 64, True, None, None),
    (1, 2, 513, 513, 64, True, None, None),
    (1, 2, 1, 1, 64, True, None, None),
    (1, 2, 300, 777, 128, True, None, None),       # Lq != Lk, top-left rule
    (1, 2, 777, 300, 64, True, None, None),
    (1, 4, 512, 512, 64, False, (1, 4), None),     # T5: stride 0 over batch
    (2, 3, 200, 333, 128, False, (1, 1), None),    # stride 0 over both
    (2, 3, 200, 333, 64, True, (2, 3), None),
    (2, 2, 600, 600, 64, False, None, "packed"),
    (2, 2, 600, 600, 128, True, None, "packed"),
    (2, 2, 600, 600, 64, True, (1, 2), "packed"),
    (1, 2, 513, 513, 64, False, None, "one"),
    (1, 2, 200, 200, 64, False, None, "each"),
    (1, 2, 200, 200, 128, True, (1, 1), "each"),
    (2, 2, 300, 400, 64, False, None, "ragged"),
    (1, 2, 600, 600, 64, False, None, "no key"),
    (1, 2, 600, 600, 128, True, (1, 2), "no key"),
]


@pytest.mark.parametrize("b,h,lq,lk,d,causal,bias_bh,seg", MASK_CASES)
def test_flash_mask_forms_match_plain(gen, b, h, lq, lk, d, causal, bias_bh,
                                      seg):
    q, g = (_randn(gen, b, h, lq, d) for _ in range(2))
    k, v = (_randn(gen, b, h, lk, d) for _ in range(2))
    bias = None
    if bias_bh is not None:
        dtype = torch.float32 if d == 64 else torch.bfloat16
        bias = _randn(gen, *bias_bh, lq, lk, dtype=dtype)
    masks = dict(bias=bias, segment_ids=_segments(seg, b, lq, lk),
                 causal=causal)
    out, lse = tfa.flash_attention_cuda(q, k, v, **masks)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, **masks)
    seen = ref_lse > -1e29
    if seg in ("ragged", "no key"):
        assert int((~seen).sum()) > 0
    else:
        assert bool(seen.all())
    assert (out.float() - ref.float())[seen].abs().max().item() <= 2e-2
    assert (lse - ref_lse)[seen].abs().max().item() <= 1e-3
    assert bool((lse[~seen] <= -1e29).all()) and not bool(out[~seen].any())
    need = bias is not None
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **masks,
                                       need_dbias=need)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, **masks,
                                         need_dbias=need)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    # The floor is for a gradient that is zero everywhere; where every
    # token is its own segment P = 1, so dS = dP - delta is rounding noise of
    # two summation orders, and dq and dk are that noise on both sides.
    floor = 1e-3 if seg == "each" else 1e-6
    for a, w in zip(got, want):
        a, w = a.float(), w.float()
        assert (a - w).abs().max().item() <= (2e-2 * w.abs().max().item()
                                              + floor)
    if need:
        assert got[3].shape == bias.shape and got[3].dtype == bias.dtype


def test_flash_masks_through_dispatch_and_autograd(gen):
    """Causal attention over 584 tokens and biased attention over 512, as
    the TinyVLM decoder and T5 reach them: one launch of K1, K3 and K4 each,
    gradients for q, k, v and the bias."""
    counts = lambda: (tfa.flash_attention_cuda.launches,
                      tfa.flash_attention_bwd_dq_cuda.launches,
                      tfa.flash_attention_bwd_dkv_cuda.launches)
    b, l, h, d = 2, 584, 12, 64
    qkv = _randn(gen, b, l, 3 * h * d).requires_grad_()
    n = counts()
    out = tattn.multi_head_attention(*qkv.chunk(3, dim=-1), h, causal=True)
    out.backward(_randn(gen, b, l, h * d))
    assert counts() == tuple(c + 1 for c in n)
    assert bool(torch.isfinite(qkv.grad).all()) and bool(qkv.grad.any())
    q, k, v = (_randn(gen, 1, 4, 512, 64).requires_grad_() for _ in range(3))
    bias = _randn(gen, 1, 4, 512, 512).requires_grad_()
    n = counts()
    out = tattn.dot_product_attention(q, k, v, bias=bias, scale=1.0)
    out.backward(_randn(gen, 1, 4, 512, 64))
    assert counts() == tuple(c + 1 for c in n)
    assert bias.grad.shape == bias.shape and bool(bias.grad.any())


# ------------------------------------------------- K1 on TMA and wgmma
def _k1_check(q, k, v, **masks):
    out, lse = tfa.flash_attention_cuda(q, k, v, **masks)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, **masks)
    seen = ref_lse > -1e29
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (out.float() - ref.float())[seen].abs().max().item() <= 2e-2
    assert (lse - ref_lse)[seen].abs().max().item() <= 1e-3
    assert bool((lse[~seen] <= -1e29).all()) and not bool(out[~seen].any())
    return out, lse


EDGE_LENGTHS = (1, 127, 128, 129, 257)


@pytest.mark.parametrize("lk", EDGE_LENGTHS)
@pytest.mark.parametrize("lq", EDGE_LENGTHS)
def test_sm90_k1_lengths_around_its_tiles(gen, lq, lk):
    """Lq and Lk around the 128-row tiles (Lk < 128 too), at the four
    padded head dims (40 -> 48, 64, 72 -> 80, 128) and causal at 64."""
    for d in (40, 64, 72, 128):
        q, k, v = (_randn(gen, 2, 3, n, d) for n in (lq, lk, lk))
        _k1_check(q, k, v)
    q, k, v = (_randn(gen, 2, 3, n, 64) for n in (lq, lk, lk))
    _k1_check(q, k, v, causal=True)


@pytest.mark.parametrize("d", [40, 72])
def test_sm90_k1_reads_fused_projection_slices(gen, d):
    """q|k|v column slices of one (B, L, 3*H*D) projection: the tensor maps
    start 2*H*D bytes apart with head offsets of 2*D = 80 / 144 bytes."""
    b, l, h = 2, 333, 5
    q, k, v = (t.reshape(b, l, h, d).transpose(1, 2)
               for t in _randn(gen, b, l, 3 * h * d).chunk(3, dim=-1))
    n = tfa.flash_attention_cuda.routes["sm90"]
    _k1_check(q, k, v)
    assert tfa.flash_attention_cuda.routes["sm90"] == n + 1


@pytest.mark.parametrize("lq,lk", [(512, 512), (200, 333)])
@pytest.mark.parametrize("bias_bh", [(1, 4), (1, 1), (2, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sm90_k1_bias_broadcast_strides(gen, lq, lk, bias_bh, dtype):
    """T5's bias, stride 0 over the batch, and stride 0 over both leading
    axes or over the heads; rows of 333 keys are not 16-byte aligned."""
    q, k, v = (_randn(gen, 2, 4, n, 64) for n in (lq, lk, lk))
    bias = 4.0 * _randn(gen, *bias_bh, lq, lk, dtype=dtype)
    _k1_check(q, k, v, bias=bias, scale=1.0)
    _k1_check(q, k, v, bias=bias, causal=True)


@pytest.mark.parametrize("kind", ["tile-aligned", "straddling", "no key"])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k1_segments_at_its_tiles(gen, kind, d):
    """Segment ids at the kernel's (128, 128) tiles: sequences that fill
    whole tiles (no per-logit mask), sequences across tile edges, and rows
    whose id no key has."""
    assert tfa._FWD_TILES == (128, 128)
    b, l = 2, 700
    idx = torch.arange(l, device="cuda")
    ids = {"tile-aligned": idx // 256, "straddling": (idx * 7) // l,
           "no key": idx // 128}[kind].int()[None].expand(b, -1).contiguous()
    kv_ids = ids if kind != "no key" else torch.where(
        ids == 2, 9, ids).int().contiguous()
    q, k, v = (_randn(gen, b, 3, l, d) for _ in range(3))
    for causal in (False, True):
        _k1_check(q, k, v, segment_ids=(ids, kv_ids), causal=causal)


def test_sm90_k1_writes_every_row(gen, monkeypatch):
    """out and lse are handed to the kernel filled with NaN: every row, in
    every form, must be written (rows that see no key as 0)."""
    blhd = tfa._blhd
    monkeypatch.setattr(tfa, "_blhd", lambda like, n: blhd(like, n).fill_(
        float("nan")))
    monkeypatch.setattr(tfa, "_lse_like", lambda q: torch.full(
        q.shape[:3], float("nan"), device=q.device))
    idx = torch.arange(300, device="cuda")
    ids = torch.where(idx % 50 == 3, 7, idx // 100).int()[None]
    cases = [((1, 2, 300, 300, 40), {}), ((2, 3, 129, 257, 128), {}),
             ((1, 2, 300, 300, 64), dict(causal=True)),
             ((1, 2, 300, 300, 64), dict(segment_ids=(ids, idx.int()[None]
                                                      // 100))),
             ((1, 2, 300, 300, 128), dict(bias=_randn(gen, 1, 2, 300, 300)))]
    for (b, h, lq, lk, d), masks in cases:
        q, k, v = (_randn(gen, b, h, n, d) for n in (lq, lk, lk))
        out, lse = _k1_check(q, k, v, **masks)
        assert bool(torch.isfinite(out).all()) and bool(
            torch.isfinite(lse).all())


def test_k1_launches_by_route(gen):
    """bf16 at d != 512 takes the sm90 kernel, d = 512 the mma.sync one,
    fp32 the fp32 library; each launch is counted under its route."""
    routes = tfa.flash_attention_cuda.routes
    for d, dtype, route in ((40, torch.bfloat16, "sm90"),
                            (512, torch.bfloat16, "d512"),
                            (64, torch.float32, "fp32")):
        q = _randn(gen, 1, 1, 130, d, dtype=dtype)
        n = dict(routes)
        tfa.flash_attention_cuda(q, q, q)
        assert routes[route] == n.get(route, 0) + 1
        assert sum(routes.values()) == sum(n.values()) + 1


# ------------------------------------------------- K4 on TMA and wgmma
def _k4_check(q, k, v, g, floor=1e-6, **masks):
    """K4 alone against the plain backward on K1's outputs; the launch must
    take the sm90 kernel. Returns (dk, dv)."""
    out, lse = tfa.flash_attention_cuda(q, k, v, **masks)
    delta = (g.float() * out.float()).sum(-1)
    routes = tfa.flash_attention_bwd_dkv_cuda.routes
    n = routes["sm90"]
    dk, dv = tfa.flash_attention_bwd_dkv_cuda(q, k, v, g, lse, delta,
                                              **masks)
    assert routes["sm90"] == n + 1
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, **masks)[1:3]
    for a, w in zip((dk, dv), want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert bool(torch.isfinite(a).all())
        a, w = a.float(), w.float()
        assert (a - w).abs().max().item() <= (2e-2 * w.abs().max().item()
                                              + floor)
    return dk, dv


K4_EDGE_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 257)


@pytest.mark.parametrize("lk", K4_EDGE_LENGTHS)
@pytest.mark.parametrize("lq", K4_EDGE_LENGTHS)
def test_sm90_k4_lengths_around_its_tiles(gen, lq, lk):
    """Lq around the 64-query tiles and Lk around the 128-key tiles, at head
    dims 64 and 128, without a mask and causal (Lq < Lk: keys that no query
    sees get dk = dv = 0). Where every query sees one key (Lk = 1, or one
    query under the causal mask) P = 1 and dS = dP - delta is rounding noise
    of two summation orders (as for one token per segment), hence the
    floor."""
    for d in (64, 128):
        q, g = (_randn(gen, 2, 3, lq, d) for _ in range(2))
        k, v = (_randn(gen, 2, 3, lk, d) for _ in range(2))
        _k4_check(q, k, v, g, 1e-3 if lk == 1 else 1e-6)
        _k4_check(q, k, v, g, 1e-3 if 1 in (lq, lk) else 1e-6, causal=True)


@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k4_reads_fused_projection_slices(gen, d):
    """q|k|v column slices of one (B, L, 3*H*D) projection and dO a
    (B, H, L, D) view of (B, L, H*D) memory."""
    b, l, h = 2, 333, 5
    q, k, v = (t.reshape(b, l, h, d).transpose(1, 2)
               for t in _randn(gen, b, l, 3 * h * d).chunk(3, dim=-1))
    g = _randn(gen, b, l, h * d).reshape(b, l, h, d).transpose(1, 2)
    _k4_check(q, k, v, g)
    _k4_check(q, k, v, g, causal=True)


@pytest.mark.parametrize("lq,lk", [(512, 512), (200, 333)])
@pytest.mark.parametrize("bias_bh", [(1, 4), (1, 1), (2, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k4_bias_broadcast_strides(gen, d, dtype, bias_bh, lq, lk):
    """The bias staged by the producer and read transposed: stride 0 over
    the batch (T5), over both leading axes or over the heads; rows of 333
    keys are not 16-byte aligned (element copies)."""
    q, g = (_randn(gen, 2, 4, lq, d) for _ in range(2))
    k, v = (_randn(gen, 2, 4, lk, d) for _ in range(2))
    bias = 4.0 * _randn(gen, *bias_bh, lq, lk, dtype=dtype)
    _k4_check(q, k, v, g, bias=bias, scale=1.0)
    _k4_check(q, k, v, g, bias=bias, causal=True)


@pytest.mark.parametrize("kind", ["tile-aligned", "straddling", "no key"])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k4_segments_at_its_tiles(gen, kind, d):
    """Segment ids at K4's (64, 128) tiles: sequences that fill whole tiles
    (no per-logit mask), sequences across tile edges, and rows whose id no
    key has; alone, causal, with a bias and with both."""
    assert tfa._DKV_TILES == (64, 128)
    b, l = 2, 700
    idx = torch.arange(l, device="cuda")
    ids = {"tile-aligned": idx // 256, "straddling": (idx * 7) // l,
           "no key": idx // 128}[kind].int()[None].expand(b, -1).contiguous()
    kv_ids = ids if kind != "no key" else torch.where(
        ids == 2, 9, ids).int().contiguous()
    q, k, v, g = (_randn(gen, b, 3, l, d) for _ in range(4))
    bias = _randn(gen, 1, 3, l, l)
    for causal in (False, True):
        for with_bias in (False, True):
            _k4_check(q, k, v, g, segment_ids=(ids, kv_ids), causal=causal,
                      bias=bias if with_bias else None)


@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k4_causal_keys_no_query_sees(gen, d):
    """Causal with Lq < Lk: the keys past the last query get dk = dv = 0,
    including whole key tiles that visit no query tile."""
    q, g = (_randn(gen, 2, 3, 100, d) for _ in range(2))
    k, v = (_randn(gen, 2, 3, 600, d) for _ in range(2))
    dk, dv = _k4_check(q, k, v, g, causal=True)
    assert not bool(dk[:, :, 100:].any()) and not bool(dv[:, :, 100:].any())
    assert bool(dk[:, :, :100].any())


def test_sm90_k4_writes_every_row(gen, monkeypatch):
    """dk and dv are handed to the kernel filled with NaN: every key row, in
    every form, must be written (keys that no query sees as 0)."""
    blhd = tfa._blhd
    monkeypatch.setattr(tfa, "_blhd", lambda like, n: blhd(like, n).fill_(
        float("nan")))
    idx = torch.arange(300, device="cuda")
    ids = (idx // 100).int()[None]
    cases = [((1, 2, 300, 300, 64), {}), ((2, 3, 129, 257, 128), {}),
             ((1, 2, 100, 300, 64), dict(causal=True)),
             ((1, 2, 300, 300, 128), dict(segment_ids=(ids, ids))),
             ((1, 2, 300, 300, 64), dict(bias=_randn(gen, 1, 2, 300, 300)))]
    for (b, h, lq, lk, d), masks in cases:
        q, g = (_randn(gen, b, h, lq, d) for _ in range(2))
        k, v = (_randn(gen, b, h, lk, d) for _ in range(2))
        _k4_check(q, k, v, g, **masks)


def test_sm90_k4_through_autograd(gen):
    """flash_attention's backward on the card launches K3 and the sm90 K4,
    once each, without a mask and causal."""
    routes = tfa.flash_attention_bwd_dkv_cuda.routes
    for causal in (False, True):
        q, k, v = (_randn(gen, 2, 4, 600, 64).requires_grad_()
                   for _ in range(3))
        n = (tfa.flash_attention_bwd_dq_cuda.launches, routes["sm90"])
        out = tfa.flash_attention(q, k, v, causal=causal)
        g = _randn(gen, 2, 4, 600, 64)
        out.backward(g)
        assert (tfa.flash_attention_bwd_dq_cuda.launches,
                routes["sm90"]) == (n[0] + 1, n[1] + 1)
        qd, kd, vd = (t.detach() for t in (q, k, v))
        ro, rl = tfa.flash_attention_plain(qd, kd, vd, causal=causal)
        want = tfa.flash_attention_bwd_plain(qd, kd, vd, ro, rl, g,
                                             causal=causal)
        _bwd_close((q.grad, k.grad, v.grad), want)


def test_k4_launches_by_route(gen):
    """bf16 takes the sm90 kernel, fp32 the fp32 library; each launch is
    counted under its route."""
    routes = tfa.flash_attention_bwd_dkv_cuda.routes
    for dtype, route in ((torch.bfloat16, "sm90"), (torch.float32, "fp32")):
        q = _randn(gen, 1, 1, 130, 64, dtype=dtype)
        out, lse = tfa.flash_attention_cuda(q, q, q)
        delta = (q.float() * out.float()).sum(-1)
        n = dict(routes)
        tfa.flash_attention_bwd_dkv_cuda(q, q, q, q, lse, delta)
        assert routes[route] == n.get(route, 0) + 1
        assert sum(routes.values()) == sum(n.values()) + 1


# ----------------------- K5 and K7, the position-mask forms on TMA and wgmma
def _fused(gen, b, n, h, d):
    """q, k, v as (B, H, L, D) slices of one fused (B, L, 3, H, D)
    projection, as the MMDiT passes them."""
    qkv = _randn(gen, b, n, 3, h, d)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


def _k5_check(q, k, v, qo, ko, **kw):
    """K5 against its plain version (``_pos_check``); the launch must take
    the sm90 kernel."""
    routes = tfa.flash_attention_pos_cuda.routes
    n = routes["sm90"]
    seen = _pos_check(q, k, v, qo, ko, **kw)
    assert routes["sm90"] == n + 1
    return seen


def _k7_check(q, k, v, g, lse, delta, qo, ko, floor=1e-6, **kw):
    """K7 alone against the plain backward under the same global lse and
    delta; the launch must take the sm90 kernel. Returns (dk, dv)."""
    routes = tfa.flash_bwd_pos_dkv_cuda.routes
    n = routes["sm90"]
    got = tfa.flash_bwd_pos_dkv_cuda(q, k, v, g, lse, delta, qo, ko, **kw)
    assert routes["sm90"] == n + 1
    want = tfa.flash_bwd_pos_plain(q, k, v, g, lse, delta, qo, ko, **kw)[1:]
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert bool(torch.isfinite(a).all())
        a, w = a.float(), w.float()
        assert (a - w).abs().max().item() <= (2e-2 * w.abs().max().item()
                                              + floor)
    return got


SD3_SHAPES = [(154, 154), (154, 4096), (4096, 154), (4096, 4096)]


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("lq,lk", SD3_SHAPES)
def test_sm90_k5_sd3_shapes_on_fused_slices(gen, stability, lq, lk):
    """The four calls of SD3's joint attention (154 context and 4096 x
    tokens, heads of 64), q, k, v slices of the fused projections."""
    b, h, d = 2, 4, 64
    q = _fused(gen, b, lq, h, d)[0]
    _, k, v = _fused(gen, b, lk, h, d)
    z = _offsets(0, 0)
    assert bool(_k5_check(q, k, v, z, z, stability=stability).all())


@pytest.mark.parametrize("lq,lk", SD3_SHAPES)
def test_sm90_k7_sd3_shapes_under_the_merged_lse(gen, lq, lk):
    """The four calls of the joint backward: lse and delta merged over the
    154 context and the 4096 x keys; dO a view of (B, L, H*D) memory."""
    b, h, d = 2, 4, 64
    q = _fused(gen, b, lq, h, d)[0]
    streams = {n: _fused(gen, b, n, h, d)[1:] for n in (154, 4096)}
    g = _randn(gen, b, lq, h * d).reshape(b, lq, h, d).transpose(1, 2)
    z = _offsets(0, 0)
    lse, delta = _global_stats(q, list(streams.values()), g, z, [z, z])
    _k7_check(q, *streams[lk], g, lse, delta, z, z)


# (B, H, Lq, Lk), query offsets, key offsets (K7: of two key blocks, the
# lse merged over both), seg_q, seg_k, causal, valid_len: the masked cases of
# chip_smoke.py's kernel phase
K5_MASK_CASES = {
    "two segments, causal": ((1, 4, 1000, 1000), (1000, 3000), (0, 2000),
                             512, 500, True, None),
    "two segments, valid_len": ((1, 4, 1000, 1000), (1000, 3000), (0, 2000),
                                512, 500, False, 2300),
    "two segments, causal and valid_len": (
        (1, 4, 1000, 1000), (1000, 3000), (0, 2000), 512, 500, True, 2300),
    "ragged key tail": ((2, 3, 300, 777), (0, 0), (0, 0), None, None, False,
                        None),
    "causal, Lq != Lk": ((1, 2, 1000, 777), (500, 2000), (0, 1500), 600, 400,
                         True, None),
    "fully masked rows": ((1, 4, 1000, 1000), (100, 5000), (3000, 4000), 512,
                          500, True, None),
}
K7_MASK_CASES = {
    "two segments, causal": ((1, 4, 1000, 1000), (1000, 3000),
                             [(0, 2000), (500, 2500)], 512, 500, True, None),
    "two segments, valid_len": ((1, 4, 1000, 1000), (1000, 3000),
                                [(0, 2000), (500, 2500)], 512, 500, False,
                                2300),
    "two segments, causal and valid_len": (
        (1, 4, 1000, 1000), (1000, 3000), [(0, 2000), (500, 2500)], 512, 500,
        True, 2300),
    "ragged x length 529 against 154": (
        (2, 3, 529, 154), (0, 0), [(0, 0), (154, 154)], None, None, False,
        None),
    "causal, Lq != Lk": ((1, 2, 1000, 777), (500, 2000),
                         [(0, 1500), (300, 1700)], 600, 400, True, None),
    "rows masked in one partial only": (
        (1, 4, 1000, 1000), (100, 5000), [(3000, 4000), (0, 50)], 512, 500,
        True, None),
    "rows masked everywhere": ((1, 4, 1000, 1000), (100, 5000),
                               [(3000, 4000), (3500, 4500)], 512, 500, True,
                               None),
}


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(K5_MASK_CASES))
def test_sm90_k5_mask_cases(gen, case, d, stability):
    (b, h, lq, lk), qo, ko, seg_q, seg_k, causal, valid = K5_MASK_CASES[case]
    q, k, v = (_randn(gen, b, h, n, d) for n in (lq, lk, lk))
    seen = _k5_check(q, k, v, _offsets(*qo), _offsets(*ko), causal=causal,
                     valid_len=valid, seg_q=seg_q, seg_k=seg_k,
                     stability=stability)
    if case == "fully masked rows":
        assert int((~seen).sum()) == 4 * 512


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(K7_MASK_CASES))
def test_sm90_k7_mask_cases(gen, case, d):
    """Under a lse global over two key blocks at other positions: rows that
    only the other block's keys see (a finite lse, masked in every tile
    here) and rows no key sees (lse = -1e30) give finite gradients."""
    (b, h, lq, lk), qo, kos, seg_q, seg_k, causal, valid = K7_MASK_CASES[case]
    q, g = (_randn(gen, b, h, lq, d) for _ in range(2))
    kvs = [tuple(_randn(gen, b, h, lk, d) for _ in range(2)) for _ in kos]
    kw = dict(causal=causal, valid_len=valid, seg_q=seg_q, seg_k=seg_k)
    qo, kos = _offsets(*qo), [_offsets(*ko) for ko in kos]
    lse, delta = _global_stats(q, kvs, g, qo, kos, **kw)
    blank = lse <= -1e29
    if case == "rows masked everywhere":
        assert int(blank.sum()) == 4 * 512
    if case == "rows masked in one partial only":
        first = tfa.flash_attention_pos_plain(q, *kvs[0], qo, kos[0], **kw)[1]
        assert not bool(blank.any())
        assert int((first <= -1e29).sum()) == 4 * 512
    for (k, v), ko in zip(kvs, kos):
        _k7_check(q, k, v, g, lse, delta, qo, ko, **kw)


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k5_segment_boundary_inside_a_tile(gen, d, stability):
    """Both sides' segment boundaries fall inside a 128-row tile, so one
    tile holds positions of both segments (its position bounds span them)."""
    lq, lk = 300, 420
    q, k, v = (_randn(gen, 2, 3, n, d) for n in (lq, lk, lk))
    for causal, valid in ((False, None), (True, None), (True, 900)):
        _k5_check(q, k, v, _offsets(400, 1000), _offsets(0, 700),
                  causal=causal, valid_len=valid, seg_q=70, seg_k=190,
                  stability=stability)


@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k7_segment_boundary_inside_a_tile(gen, d):
    lq, lk = 300, 420
    q, g = (_randn(gen, 2, 3, lq, d) for _ in range(2))
    k, v = (_randn(gen, 2, 3, lk, d) for _ in range(2))
    qo, ko = _offsets(400, 1000), _offsets(0, 700)
    for causal, valid in ((False, None), (True, None), (True, 900)):
        kw = dict(causal=causal, valid_len=valid, seg_q=70, seg_k=190)
        lse, delta = _global_stats(q, [(k, v)], g, qo, [ko], **kw)
        _k7_check(q, k, v, g, lse, delta, qo, ko, **kw)


@pytest.mark.parametrize("stability", ["online", "bounded"])
def test_sm90_k5_query_tile_that_sees_no_key_tile(gen, monkeypatch,
                                                  stability):
    """Causal by position: the first 128-row query tile (positions 0-127)
    lies before every key (positions from 1000 on), so it visits no key
    tile, loads nothing and waits on no barrier; its rows are written as
    out = 0, lse = -1e30 into buffers handed over filled with NaN."""
    blhd = tfa._blhd
    monkeypatch.setattr(tfa, "_blhd", lambda like, n: blhd(like, n).fill_(
        float("nan")))
    monkeypatch.setattr(tfa, "_lse_like", lambda q: torch.full(
        q.shape[:3], float("nan"), device=q.device))
    for d in (64, 128):
        q = _randn(gen, 2, 3, 300, d)
        k, v = (_randn(gen, 2, 3, 500, d) for _ in range(2))
        seen = _k5_check(q, k, v, _offsets(0, 5000), _offsets(1000, 1000),
                         causal=True, seg_q=128, stability=stability)
        assert not bool(seen[:, :, :128].any())
        assert bool(seen[:, :, 128:].all())


@pytest.mark.parametrize("lk", EDGE_LENGTHS)
@pytest.mark.parametrize("lq", EDGE_LENGTHS)
def test_sm90_k5_lengths_around_its_tiles(gen, lq, lk):
    """Lq and Lk around the 128-row tiles at head dims 64 and 128, online
    and bounded, and causal over two segments."""
    for d in (64, 128):
        q, k, v = (_randn(gen, 2, 3, n, d) for n in (lq, lk, lk))
        z = _offsets(0, 0)
        for stability in ("online", "bounded"):
            _k5_check(q, k, v, z, z, stability=stability)
        _k5_check(q, k, v, _offsets(0, 100), _offsets(0, 50), causal=True,
                  seg_q=lq // 2, seg_k=lk // 2)


@pytest.mark.parametrize("lk", K4_EDGE_LENGTHS)
@pytest.mark.parametrize("lq", K4_EDGE_LENGTHS)
def test_sm90_k7_lengths_around_its_tiles(gen, lq, lk):
    """Lq around the 64-query tiles and Lk around the 128-key tiles at head
    dims 64 and 128, unmasked and causal over two segments; where every
    query sees one key, dS is rounding noise (the floor, as for K4)."""
    for d in (64, 128):
        q, g = (_randn(gen, 2, 3, lq, d) for _ in range(2))
        k, v = (_randn(gen, 2, 3, lk, d) for _ in range(2))
        for qo, ko, kw in ((_offsets(0, 0), _offsets(0, 0), {}),
                           (_offsets(0, 100), _offsets(0, 50),
                            dict(causal=True, seg_q=lq // 2,
                                 seg_k=lk // 2))):
            lse, delta = _global_stats(q, [(k, v)], g, qo, [ko], **kw)
            _k7_check(q, k, v, g, lse, delta, qo, ko,
                      1e-3 if 1 in (lq, lk) else 1e-6, **kw)


def test_sm90_k7_writes_every_row(gen, monkeypatch):
    """dk and dv are handed to the kernel filled with NaN: every key row
    must be written, keys that no query sees (past valid_len: whole key
    tiles that walk nothing; after every query, causal) as 0."""
    blhd = tfa._blhd
    monkeypatch.setattr(tfa, "_blhd", lambda like, n: blhd(like, n).fill_(
        float("nan")))
    for d, (qo, ko, kw) in itertools.product((64, 128), (
            ((0, 0), (0, 0), {}),
            ((0, 0), (0, 0), dict(valid_len=200)),
            ((0, 0), (0, 0), dict(causal=True)),
            ((100, 900), (0, 600), dict(causal=True, valid_len=700,
                                        seg_q=50, seg_k=300)))):
        q, g = (_randn(gen, 1, 2, 300, d) for _ in range(2))
        k, v = (_randn(gen, 1, 2, 600, d) for _ in range(2))
        qo, ko = _offsets(*qo), _offsets(*ko)
        lse, delta = _global_stats(q, [(k, v)], g, qo, [ko], **kw)
        dk, dv = _k7_check(q, k, v, g, lse, delta, qo, ko, **kw)
        if kw.get("valid_len") == 200:
            assert not bool(dk[:, :, 200:].any() or dv[:, :, 200:].any())
        if kw == dict(causal=True):
            assert not bool(dk[:, :, 300:].any() or dv[:, :, 300:].any())


# --------------------- K6, the position-mask form of K3's TMA / wgmma kernel
def _k6_check(q, k, v, g, lse, delta, qo, ko, floor=1e-6, **kw):
    """K6 alone against the plain backward under the same global lse and
    delta (2e-2 of dq's largest magnitude, as the mma.sync K6 was held);
    the launch must take the sm90 kernel. Returns dq."""
    routes = tfa.flash_bwd_pos_dq_cuda.routes
    n = routes["sm90"]
    got = tfa.flash_bwd_pos_dq_cuda(q, k, v, g, lse, delta, qo, ko, **kw)
    assert routes["sm90"] == n + 1
    want = tfa.flash_bwd_pos_plain(q, k, v, g, lse, delta, qo, ko, **kw)[0]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    a, w = got.float(), want.float()
    assert (a - w).abs().max().item() <= 2e-2 * w.abs().max().item() + floor
    return got


@pytest.mark.parametrize("lq,lk", SD3_SHAPES)
def test_sm90_k6_sd3_shapes_under_the_merged_lse(gen, lq, lk):
    """The four dq calls of the joint backward: lse and delta merged over
    the 154 context and the 4096 x keys; q a slice of the fused projection,
    dO a view of (B, L, H*D) memory."""
    b, h, d = 2, 4, 64
    q = _fused(gen, b, lq, h, d)[0]
    streams = {n: _fused(gen, b, n, h, d)[1:] for n in (154, 4096)}
    g = _randn(gen, b, lq, h * d).reshape(b, lq, h, d).transpose(1, 2)
    z = _offsets(0, 0)
    lse, delta = _global_stats(q, list(streams.values()), g, z, [z, z])
    _k6_check(q, *streams[lk], g, lse, delta, z, z)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(K7_MASK_CASES))
def test_sm90_k6_mask_cases(gen, case, d):
    """K7's masked cases (chip_smoke.py's): under a lse global over two key
    blocks, rows that only the other block's keys see and rows that no key
    sees give finite dq, 0 where no key is visible anywhere."""
    (b, h, lq, lk), qo, kos, seg_q, seg_k, causal, valid = K7_MASK_CASES[case]
    q, g = (_randn(gen, b, h, lq, d) for _ in range(2))
    kvs = [tuple(_randn(gen, b, h, lk, d) for _ in range(2)) for _ in kos]
    kw = dict(causal=causal, valid_len=valid, seg_q=seg_q, seg_k=seg_k)
    qo, kos = _offsets(*qo), [_offsets(*ko) for ko in kos]
    lse, delta = _global_stats(q, kvs, g, qo, kos, **kw)
    for (k, v), ko in zip(kvs, kos):
        dq = _k6_check(q, k, v, g, lse, delta, qo, ko, **kw)
        assert not bool(dq[lse <= -1e29].any())


@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k6_segment_boundary_inside_a_tile(gen, d):
    """Both sides' segment boundaries fall inside a tile (128 queries, 64
    keys), so one tile's position bounds span both segments."""
    lq, lk = 300, 420
    q, g = (_randn(gen, 2, 3, lq, d) for _ in range(2))
    k, v = (_randn(gen, 2, 3, lk, d) for _ in range(2))
    qo, ko = _offsets(400, 1000), _offsets(0, 700)
    for causal, valid in ((False, None), (True, None), (True, 900)):
        kw = dict(causal=causal, valid_len=valid, seg_q=70, seg_k=190)
        lse, delta = _global_stats(q, [(k, v)], g, qo, [ko], **kw)
        _k6_check(q, k, v, g, lse, delta, qo, ko, **kw)


@pytest.mark.parametrize("lk", K4_EDGE_LENGTHS)
@pytest.mark.parametrize("lq", K4_EDGE_LENGTHS)
def test_sm90_k6_lengths_around_its_tiles(gen, lq, lk):
    """Lq around the 128-query tiles and Lk around the 64-key tiles at head
    dims 64 and 128, unmasked and causal over two segments; where every
    query sees one key, dS is rounding noise (the floor, as for K3)."""
    for d in (64, 128):
        q, g = (_randn(gen, 2, 3, lq, d) for _ in range(2))
        k, v = (_randn(gen, 2, 3, lk, d) for _ in range(2))
        for qo, ko, kw in ((_offsets(0, 0), _offsets(0, 0), {}),
                           (_offsets(0, 100), _offsets(0, 50),
                            dict(causal=True, seg_q=lq // 2,
                                 seg_k=lk // 2))):
            lse, delta = _global_stats(q, [(k, v)], g, qo, [ko], **kw)
            _k6_check(q, k, v, g, lse, delta, qo, ko,
                      1e-3 if 1 in (lq, lk) else 1e-6, **kw)


def test_sm90_k6_writes_every_row(gen, monkeypatch):
    """dq is handed to the kernel filled with NaN: every query row must be
    written, those whose key tiles are all skipped (a query tile before
    every key, causal by position) and those that see no key of this block
    (past valid_len) as 0. A second key block that every row sees keeps
    their lse finite."""
    blhd = tfa._blhd
    monkeypatch.setattr(tfa, "_blhd", lambda like, n: blhd(like, n).fill_(
        float("nan")))
    for d, (lq, lk, qo, ko, kw) in itertools.product((64, 128), (
            (300, 600, (0, 0), (0, 0), {}),
            (300, 600, (0, 0), (0, 0), dict(valid_len=200)),
            (300, 500, (0, 5000), (1000, 1000), dict(causal=True, seg_q=128)),
            (300, 600, (100, 900), (0, 600), dict(causal=True, valid_len=700,
                                                  seg_q=50, seg_k=300)))):
        q, g = (_randn(gen, 1, 2, lq, d) for _ in range(2))
        k, v = (_randn(gen, 1, 2, lk, d) for _ in range(2))
        other = tuple(_randn(gen, 1, 2, 64, d) for _ in range(2))
        qo, ko = _offsets(*qo), _offsets(*ko)
        lse, delta = _global_stats(q, [(k, v), other], g, qo,
                                   [ko, _offsets(0, 0)], **kw)
        dq = _k6_check(q, k, v, g, lse, delta, qo, ko, **kw)
        if kw.get("seg_q") == 128:   # positions 0-127: before every key
            assert not bool(dq[:, :, :128].any())


def test_k6_launches_by_route(gen):
    """bf16 takes the sm90 kernel, fp32 the fp32 library; each launch is
    counted under its route."""
    routes = tfa.flash_bwd_pos_dq_cuda.routes
    z = _offsets(0, 0)
    for dtype, route in ((torch.bfloat16, "sm90"), (torch.float32, "fp32")):
        q = _randn(gen, 1, 1, 130, 64, dtype=dtype)
        out, lse = tfa.flash_attention_pos_cuda(q, q, q, z, z)
        delta = (q.float() * out.float()).sum(-1)
        n = dict(routes)
        tfa.flash_bwd_pos_dq_cuda(q, q, q, q, lse, delta, z, z)
        assert routes[route] == n.get(route, 0) + 1
        assert sum(routes.values()) == sum(n.values()) + 1


@pytest.mark.parametrize("stability", ["online", "bounded"])
def test_sm90_k5_k7_joint_attention_at_sd3_shape(gen, stability):
    """One MMDiT block's joint attention at SD3's 154 + 4096 tokens through
    ``joint_attention_blhd`` and autograd: four sm90 K5 launches forward,
    four sm90 K6 and four sm90 K7 backward, against plain attention over the
    concatenated sequence (2e-2 forward; 3e-2 of each gradient's largest
    magnitude backward)."""
    b, h, d, lc, lx = 2, 2, 64, 154, 4096
    fused = [_randn(gen, b, n, 3, h, d).requires_grad_() for n in (lc, lx)]
    ctx, x = ([f[:, :, i] for i in range(3)] for f in fused)
    r5 = tfa.flash_attention_pos_cuda.routes
    r6 = tfa.flash_bwd_pos_dq_cuda.routes
    r7 = tfa.flash_bwd_pos_dkv_cuda.routes
    n = (r5["sm90"], r6["sm90"], r7["sm90"])
    oc, ox = tattn.joint_attention_blhd(ctx, x, stability=stability)
    gc, gx = _randn(gen, b, lc, h, d), _randn(gen, b, lx, h, d)
    got = torch.autograd.grad((oc, ox), fused, (gc, gx))
    assert (r5["sm90"], r6["sm90"], r7["sm90"]) == (n[0] + 4, n[1] + 4,
                                                    n[2] + 4)
    q, k, v = (torch.cat([c, a], dim=1).transpose(1, 2)
               for c, a in zip(ctx, x))
    ref = tattn.plain_attention(q, k, v).transpose(1, 2)
    out = torch.cat([oc, ox], dim=1)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    want = torch.autograd.grad(ref, fused, torch.cat([gc, gx], dim=1))
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        for i in range(3):
            ai, wi = a[:, :, i].float(), w[:, :, i].float()
            assert ((ai - wi).abs().max().item()
                    <= 3e-2 * wi.abs().max().item())


def test_k5_k7_launches_by_route(gen):
    """bf16 takes the sm90 kernels, fp32 the fp32 library; each launch is
    counted under its route."""
    r5 = tfa.flash_attention_pos_cuda.routes
    r7 = tfa.flash_bwd_pos_dkv_cuda.routes
    z = _offsets(0, 0)
    for dtype, route in ((torch.bfloat16, "sm90"), (torch.float32, "fp32")):
        q = _randn(gen, 1, 1, 130, 64, dtype=dtype)
        n5, n7 = dict(r5), dict(r7)
        out, lse = tfa.flash_attention_pos_cuda(q, q, q, z, z)
        delta = (q.float() * out.float()).sum(-1)
        tfa.flash_bwd_pos_dkv_cuda(q, q, q, q, lse, delta, z, z)
        for routes, before in ((r5, n5), (r7, n7)):
            assert routes[route] == before.get(route, 0) + 1
            assert sum(routes.values()) == sum(before.values()) + 1


def test_ring_on_a_head_shard_launches_k5_k6_k7(gen):
    """The ring of one tensor-parallel head shard over the ``seq`` axis of
    a {"seq": 2, "model": 2} mesh of the card repeated, at a small hop
    shape (2, 3, 531, 531, 64), one padded key: 4 sm90 launches each of K5
    forward and K6 / K7 backward, against the plain K5 over the whole
    sequence (out 2e-2) and the plain K6 / K7 under its lse (2e-2 of each
    gradient's largest magnitude)."""
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel.ring_attention \
        import ring_attention

    mesh = build_mesh({"seq": 2, "model": 2}, [torch.device("cuda")] * 4)
    b, h, l, d = 2, 3, 2 * 531, 64
    valid = l - 1
    q, k, v, g = (_randn(gen, b, h, l, d) for _ in range(4))
    g[:, :, valid:] = 0
    routes = (tfa.flash_attention_pos_cuda.routes,
              tfa.flash_bwd_pos_dq_cuda.routes,
              tfa.flash_bwd_pos_dkv_cuda.routes)
    before = [r.get("sm90", 0) for r in routes]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ring_attention(*leaves, mesh, "seq", kv_valid_len=valid)
    got = torch.autograd.grad(out, leaves, g)
    assert [r.get("sm90", 0) - n for r, n in zip(routes, before)] == [4] * 3
    z = _offsets(0, 0)
    ref, ref_lse = tfa.flash_attention_pos_plain(q, k, v, z, z,
                                                 valid_len=valid)
    assert ((out[:, :, :valid].float() - ref[:, :, :valid].float()).abs()
            .max().item() <= 2e-2)
    delta = (g.float() * ref.float()).sum(-1)
    want = tfa.flash_bwd_pos_plain(q, k, v, g, ref_lse, delta, z, z,
                                   valid_len=valid)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = a[:, :, :valid].float(), w[:, :, :valid].float()
        assert bool(torch.isfinite(a).all()), name
        assert (a - w).abs().max().item() <= 2e-2 * w.abs().max().item(), \
            name


# ---------------------------------------- K1 at head dim 512 (TMA, wgmma)
@pytest.mark.parametrize("lk", [1, 63, 65, 777, 4096, 4097])
@pytest.mark.parametrize("lq", [1, 4096])
def test_k1_d512_lengths_across_its_splits(gen, lq, lk):
    """Lk around the 64-key tiles and across the key-split boundaries (up to
    four splits at Lq = 1, two at 4096 queries), through the route."""
    q = _randn(gen, 1, 1, lq, 512)
    k, v = (_randn(gen, 1, 1, lk, 512) for _ in range(2))
    n = tfa.flash_attention_cuda.routes["d512"]
    _k1_check(q, k, v)
    assert tfa.flash_attention_cuda.routes["d512"] == n + 1


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_k1_d512_each_split_count_matches_plain(gen, splits):
    q = _randn(gen, 2, 1, 300, 512)
    k, v = (_randn(gen, 2, 1, 1000, 512) for _ in range(2))
    out, lse = tfa._flash_fwd_d512(q, k, v, 512 ** -0.5, splits)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_k1_d512_heads_and_fused_projection_slices(gen):
    """B*H > 1 with q|k|v column slices of one (B, L, 3*H*512) projection."""
    b, l, h = 2, 333, 3
    q, k, v = (t.reshape(b, l, h, 512).transpose(1, 2)
               for t in _randn(gen, b, l, 3 * h * 512).chunk(3, dim=-1))
    _k1_check(q, k, v)
    _k1_check(q, k[:, :, :100], v[:, :, :100])


def test_k1_d512_writes_every_row(gen, monkeypatch):
    """out and lse are handed to the kernel filled with NaN, with one split
    and with several."""
    blhd = tfa._blhd
    monkeypatch.setattr(tfa, "_blhd", lambda like, n: blhd(like, n).fill_(
        float("nan")))
    monkeypatch.setattr(tfa, "_lse_like", lambda q: torch.full(
        q.shape[:3], float("nan"), device=q.device))
    for b, lq, lk in ((1, 130, 777), (4, 4096, 200)):
        q = _randn(gen, b, 1, lq, 512)
        k, v = (_randn(gen, b, 1, lk, 512) for _ in range(2))
        out, lse = _k1_check(q, k, v)
        assert bool(torch.isfinite(out).all()) and bool(
            torch.isfinite(lse).all())


# ------------------------------------------------------------- fp32 forms
F32_ATOL = 1e-4


def _f32_close(got, want, what=""):
    assert got.dtype == torch.float32 and got.shape == want.shape, what
    assert torch.isfinite(got).all(), what
    tol = F32_ATOL * (1.0 if what in ("out", "lse")
                      else want.abs().max().item())
    assert (got - want).abs().max().item() <= tol, what


def _rounded(*xs):
    return [x.bfloat16().float() for x in xs]


@pytest.mark.parametrize("b,h,lq,lk,d,causal", [
    (1, 2, 64, 64, 40, False), (2, 2, 529, 300, 40, False),
    (1, 2, 257, 63, 48, False), (1, 2, 65, 1000, 80, False),
    (1, 2, 128, 192, 72, False), (2, 1, 100, 529, 512, False),
    (1, 2, 529, 777, 128, False), (1, 1, 130, 17, 128, False),
    (2, 2, 529, 529, 64, False), (2, 2, 529, 529, 64, True),
    (1, 2, 200, 529, 64, True), (1, 2, 529, 200, 64, True),
    (1, 1, 33, 33, 64, True)])
def test_fp32_flash_forward_matches_plain(gen, b, h, lq, lk, d, causal):
    """K1 in fp32: small and ragged lengths, Lq != Lk under causal."""
    q, k, v = (_randn(gen, b, h, n, d, dtype=torch.float32)
               for n in (lq, lk, lk))
    n = tfa.flash_attention_cuda.dtypes["fp32"]
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=causal)
    assert tfa.flash_attention_cuda.dtypes["fp32"] == n + 1
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=causal)
    _f32_close(out, ref, "out")
    _f32_close(lse, ref_lse, "lse")
    bad, _ = tfa.flash_attention_plain(*_rounded(q, k, v), causal=causal)
    assert (bad - ref).abs().max().item() > F32_ATOL     # the planted fault


@pytest.mark.parametrize("b,h,lq,lk,d,causal", [
    (2, 2, 529, 300, 64, False), (1, 2, 40, 40, 64, False),
    (1, 1, 63, 200, 128, False), (1, 2, 529, 777, 128, False),
    (2, 2, 529, 529, 64, True), (1, 2, 200, 529, 64, True),
    (1, 2, 529, 200, 64, True)])
def test_fp32_flash_backward_matches_plain(gen, b, h, lq, lk, d, causal):
    """K3 / K4 in fp32; under causal with Lq > Lk the last keys' columns and
    with Lq < Lk whole key tiles see no query."""
    q, g = (_randn(gen, b, h, lq, d, dtype=torch.float32) for _ in range(2))
    k, v = (_randn(gen, b, h, lk, d, dtype=torch.float32) for _ in range(2))
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=causal)
    n3 = tfa.flash_attention_bwd_dq_cuda.dtypes["fp32"]
    n4 = tfa.flash_attention_bwd_dkv_cuda.dtypes["fp32"]
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal=causal)
    assert tfa.flash_attention_bwd_dq_cuda.dtypes["fp32"] == n3 + 1
    assert tfa.flash_attention_bwd_dkv_cuda.dtypes["fp32"] == n4 + 1
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    bad = tfa.flash_attention_bwd_plain(*_rounded(q, k, v), out, lse,
                                        *_rounded(g), causal=causal)
    for what, a, w, f in zip(("dq", "dk", "dv"), got, want, bad):
        _f32_close(a, w, what)
        assert (f - w).abs().max().item() > F32_ATOL * w.abs().max().item()


def test_fp32_flash_reads_strided_views_through_autograd(gen):
    """q|k|v column slices of a fused fp32 projection (strides in multiples
    of 4 elements) through the dispatch and autograd, as VLMTrainer's
    default dtype runs them."""
    b, l, h, d = 2, 584, 2, 64
    qkv = _randn(gen, b, l, 3 * h * d, dtype=torch.float32).requires_grad_()
    wrappers = (tfa.flash_attention_cuda, tfa.flash_attention_bwd_dq_cuda,
                tfa.flash_attention_bwd_dkv_cuda)
    n = [w.dtypes["fp32"] for w in wrappers]
    q, k, v = qkv.chunk(3, dim=-1)
    out = tattn.multi_head_attention(q, k, v, h, causal=True)
    g = _randn(gen, b, l, h * d, dtype=torch.float32)
    out.backward(g)
    assert [w.dtypes["fp32"] for w in wrappers] == [c + 1 for c in n]
    rq, rk, rv = (t.reshape(b, l, h, d).transpose(1, 2).contiguous()
                  for t in qkv.detach().chunk(3, dim=-1))
    ro, rl = tfa.flash_attention_plain(rq, rk, rv, causal=True)
    _f32_close(out.detach().reshape(b, l, h, d).transpose(1, 2), ro, "out")
    want = tfa.flash_attention_bwd_plain(
        rq, rk, rv, ro, rl, g.reshape(b, l, h, d).transpose(1, 2),
        causal=True)
    for what, a, w in zip(("dq", "dk", "dv"), qkv.grad.chunk(3, dim=-1),
                          want):
        _f32_close(a.reshape(b, l, h, d).transpose(1, 2), w, what)
    plain = tattn.dot_product_attention(rq, rk, rv, causal=True,
                                        use_flash=False)
    assert (plain - ro).abs().max().item() <= F32_ATOL
    forced = tattn.dot_product_attention(rq[:, :, :100], rk[:, :, :100],
                                         rv[:, :, :100], use_flash=True)
    _f32_close(forced, tfa.flash_attention_plain(
        rq[:, :, :100], rk[:, :, :100], rv[:, :, :100])[0], "out")


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("lq,lk,kw", [
    (529, 154, {}), (154, 529, {}), (64, 64, {}),
    (300, 529, dict(causal=True, seg_q=100, valid_len=400)),
    (200, 170, dict(causal=True, seg_q=128, seg_k=100))])
def test_fp32_pos_forward_and_backward_match_plain(gen, stability, lq, lk,
                                                   kw):
    """K5, K6, K7 in fp32 at head dim 64: ragged lengths, two segments,
    ``valid_len``, and (last case) rows that see no key."""
    f32 = dict(dtype=torch.float32)
    q, g = (_randn(gen, 2, 2, lq, 64, **f32) for _ in range(2))
    k, v = (_randn(gen, 2, 2, lk, 64, **f32) for _ in range(2))
    i32 = lambda *xs: torch.tensor(xs, dtype=torch.int32, device="cuda")
    last = kw.get("seg_k") == 100
    q_off = i32(128, 640) if last else i32(3, 40)
    k_off = i32(400, 900) if last else i32(0, 0)
    scale = 0.02 if stability == "bounded" else None
    counts = lambda: [w.dtypes["fp32"] for w in (
        tfa.flash_attention_pos_cuda, tfa.flash_bwd_pos_dq_cuda,
        tfa.flash_bwd_pos_dkv_cuda)]
    n = counts()
    out, lse = tfa.flash_attention_pos_cuda(q, k, v, q_off, k_off,
                                            stability=stability, scale=scale,
                                            **kw)
    ref, ref_lse = tfa.flash_attention_pos_plain(
        q, k, v, q_off, k_off, stability=stability, scale=scale, **kw)
    seen = ref_lse > -1e29
    assert seen.any() and (last == (not seen.all()))
    _f32_close(out, ref, "out")
    assert not out[~seen].any() and (lse[~seen] <= -1e29).all()
    assert (lse[seen] - ref_lse[seen]).abs().max().item() <= F32_ATOL
    delta = (g * out).sum(-1)
    got = tfa.flash_bwd_pos(q, k, v, g, lse, delta, q_off, k_off, scale=scale,
                            **kw)
    assert counts() == [c + 1 for c in n]
    want = tfa.flash_bwd_pos_plain(q, k, v, g, lse, delta, q_off, k_off,
                                   scale=scale, **kw)
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        _f32_close(a, w, what)
    assert not got[0][~seen].any()


def test_fp32_joint_attention_matches_concatenated(gen):
    """The MMDiT's joint attention and its gradients in fp32 (4 x K5, then
    4 x K6 and 4 x K7 under the merged lse) against autograd through plain
    attention over the concatenated sequence."""
    f32 = dict(dtype=torch.float32)
    ts = [_randn(gen, 1, 2, n, 64, **f32).requires_grad_()
          for n in (154, 154, 154, 529, 529, 529)]
    oc, ox = tfa.joint_flash_attention(*ts)
    gc, gx = _randn(gen, 1, 2, 154, 64, **f32), _randn(gen, 1, 2, 529, 64,
                                                        **f32)
    torch.autograd.backward([oc, ox], [gc, gx])
    refs = [t.detach().clone().requires_grad_() for t in ts]
    cat = lambda a, b: torch.cat([a, b], dim=2)
    out = tattn.plain_attention(cat(refs[0], refs[3]), cat(refs[1], refs[4]),
                                cat(refs[2], refs[5]))
    out.backward(cat(gc, gx))
    _f32_close(oc.detach(), out[:, :, :154].detach(), "out")
    _f32_close(ox.detach(), out[:, :, 154:].detach(), "out")
    for t, r in zip(ts, refs):
        _f32_close(t.grad, r.grad, "grad")


def test_fp32_forms_not_ported_raise_with_the_dtype_to_pass(gen):
    """The fp32 bias, segment-id and position forms run on their kernels and
    match the plain versions; what the kernels lack (a mask or the backward
    at 512, other strides) still raises."""
    f32 = dict(dtype=torch.float32)
    q = _randn(gen, 1, 2, 64, 64, **f32)
    ids = torch.zeros(1, 64, dtype=torch.int32, device="cuda")
    bias = q[:, :, :, :64].contiguous()
    out, lse = tfa.flash_attention_cuda(q, q, q, bias=bias, causal=True)
    ref, ref_lse = tfa.flash_attention_plain(q, q, q, bias=bias, causal=True)
    _f32_close(out, ref, "out")
    _f32_close(lse, ref_lse, "lse")
    got = tfa.flash_attention(q, q, q, segment_ids=(ids, ids))
    _f32_close(got, tfa.flash_attention_plain(q, q, q)[0], "out")
    q128 = _randn(gen, 1, 1, 64, 128, **f32)
    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    out, lse = tfa.flash_attention_pos_cuda(q128, q128, q128, z, z)
    ref, ref_lse = tfa.flash_attention_pos_plain(q128, q128, q128, z, z)
    _f32_close(out, ref, "out")
    _f32_close(lse, ref_lse, "lse")
    q, k, v, g = (_randn(gen, 1, 1, 64, 512, **f32) for _ in range(4))
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=True)   # up to 512
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=True)
    _f32_close(out, ref, "out")
    _f32_close(lse, ref_lse, "lse")
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal=True)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _f32_close(a, w, name)
    with pytest.raises(NotImplementedError, match="1 to 512"):
        tfa.flash_attention_cuda(*(_randn(gen, 1, 1, 64, 520, **f32),) * 3)
    with pytest.raises(ValueError, match="multiples of 4"):
        tfa.flash_attention_cuda(*(_randn(gen, 1, 1, 64, 66, **f32)[..., :64],)
                                 * 3)


# ------------------------------------------------- K3 on TMA and wgmma
def _k3_check(q, k, v, g, floor=1e-6, **masks):
    """K3 alone against the plain backward on K1's outputs; the launch must
    take the sm90 kernel. With a bias also dbias (dS summed over the bias's
    broadcast axes) to 2e-2 of its largest magnitude. Returns dq (and the
    kernel's dS with a bias)."""
    out, lse = tfa.flash_attention_cuda(q, k, v, **masks)
    delta = (g.float() * out.float()).sum(-1)
    routes = tfa.flash_attention_bwd_dq_cuda.routes
    n = routes["sm90"]
    need = masks.get("bias") is not None
    got = tfa.flash_attention_bwd_dq_cuda(q, k, v, g, lse, delta, **masks,
                                          need_dbias=need)
    assert routes["sm90"] == n + 1
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, **masks,
                                         need_dbias=need)
    dq = got[0] if need else got
    pairs = [(dq, want[0])]
    if need:
        bias = masks["bias"]
        pairs.append((tfa._reduce_dbias(got[1], bias), want[3]))
    for a, w in pairs:
        assert a.shape == w.shape and bool(torch.isfinite(a).all())
        a, w = a.float(), w.float()
        assert (a - w).abs().max().item() <= (2e-2 * w.abs().max().item()
                                              + floor)
    assert dq.dtype == torch.bfloat16
    return got


K3_EDGE_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 257)


@pytest.mark.parametrize("lk", K3_EDGE_LENGTHS)
@pytest.mark.parametrize("lq", K3_EDGE_LENGTHS)
def test_sm90_k3_lengths_around_its_tiles(gen, lq, lk):
    """Lq around the 128-query tiles and Lk around the 64-key tiles, at head
    dims 64 and 128, without a mask and causal; where every query sees one
    key dS is rounding noise of two summation orders (the floor, as for
    K4)."""
    for d in (64, 128):
        q, g = (_randn(gen, 2, 3, lq, d) for _ in range(2))
        k, v = (_randn(gen, 2, 3, lk, d) for _ in range(2))
        _k3_check(q, k, v, g, 1e-3 if lk == 1 else 1e-6)
        _k3_check(q, k, v, g, 1e-3 if 1 in (lq, lk) else 1e-6, causal=True)


@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k3_reads_fused_projection_slices(gen, d):
    """q|k|v column slices of one (B, L, 3*H*D) projection and dO a
    (B, H, L, D) view of (B, L, H*D) memory."""
    b, l, h = 2, 333, 5
    q, k, v = (t.reshape(b, l, h, d).transpose(1, 2)
               for t in _randn(gen, b, l, 3 * h * d).chunk(3, dim=-1))
    g = _randn(gen, b, l, h * d).reshape(b, l, h, d).transpose(1, 2)
    _k3_check(q, k, v, g)
    _k3_check(q, k, v, g, causal=True)


@pytest.mark.parametrize("lq,lk", [(512, 512), (200, 333)])
@pytest.mark.parametrize("bias_bh", [(1, 4), (1, 1), (2, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k3_bias_broadcast_strides_and_dbias(gen, d, dtype, bias_bh, lq,
                                                  lk):
    """The bias staged by the producer at (128, 64) tiles: stride 0 over the
    batch (T5), over both leading axes or over the heads; rows of 333 keys
    are not 16-byte aligned (element copies); dbias reduced over the same
    axes."""
    q, g = (_randn(gen, 2, 4, lq, d) for _ in range(2))
    k, v = (_randn(gen, 2, 4, lk, d) for _ in range(2))
    bias = 4.0 * _randn(gen, *bias_bh, lq, lk, dtype=dtype)
    _k3_check(q, k, v, g, bias=bias, scale=1.0)
    _k3_check(q, k, v, g, bias=bias, causal=True)


@pytest.mark.parametrize("fill", [-1e30, float("-inf"), -1e4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k3_bias_hides_whole_rows_past_a_key_tail(gen, d, dtype, fill):
    """Rows a bias of -1e30 or -inf hides whole (lse = -1e30 from K1) and
    rows under a large negative finite bias (lse near -1e4), with 333 keys:
    the keys past Lk in the last tile are zero rows of K whose logit of 0
    would give P = exp(-lse) = inf, so they must stay selected away. dq is
    finite and the plain result, 0 on the hidden rows."""
    lq, lk = 200, 333
    q, g = (_randn(gen, 1, 2, lq, d) for _ in range(2))
    k, v = (_randn(gen, 1, 2, lk, d) for _ in range(2))
    bias = 4.0 * _randn(gen, 1, 2, lq, lk)
    bias[:, :, 40:90] = fill + (bias[:, :, 40:90] if fill == -1e4 else 0.0)
    bias = bias.to(dtype)
    for causal in (False, True):
        dq = _k3_check(q, k, v, g, bias=bias, causal=causal)[0]
        if fill != -1e4:
            assert not bool(dq[:, :, 40:90].any())


@pytest.mark.parametrize("kind", ["tile-aligned", "straddling", "no key"])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_k3_segments_at_its_tiles(gen, kind, d):
    """Segment ids at K3's (128, 64) tiles: sequences that fill whole tiles
    (no per-logit mask), sequences across tile edges, and rows whose id no
    key has (dq = 0 there); alone, causal, with a bias and with both."""
    assert tfa._DQ_TILES == (128, 64)
    b, l = 2, 700
    idx = torch.arange(l, device="cuda")
    ids = {"tile-aligned": idx // 256, "straddling": (idx * 7) // l,
           "no key": idx // 128}[kind].int()[None].expand(b, -1).contiguous()
    kv_ids = ids if kind != "no key" else torch.where(
        ids == 2, 9, ids).int().contiguous()
    q, k, v, g = (_randn(gen, b, 3, l, d) for _ in range(4))
    bias = _randn(gen, 1, 3, l, l)
    for causal in (False, True):
        for with_bias in (False, True):
            got = _k3_check(q, k, v, g, segment_ids=(ids, kv_ids),
                            causal=causal, bias=bias if with_bias else None)
            dq = got[0] if with_bias else got
            if kind == "no key":
                assert not bool(dq[:, :, 256:384].any())


def test_sm90_k3_writes_every_row_and_dbias_tile(gen, monkeypatch):
    """dq is handed to the kernel filled with NaN and the allocator's pool
    is poisoned with NaN before dbias is allocated: every row of dq and
    every (B, H, Lq, Lk) element of dbias must be written, the tiles K3
    skips (causal, disjoint segments) as 0."""
    blhd = tfa._blhd
    monkeypatch.setattr(tfa, "_blhd", lambda like, n: blhd(like, n).fill_(
        float("nan")))
    idx = torch.arange(300, device="cuda")
    ids = (idx // 100).int()[None]
    cases = [((1, 2, 300, 300, 64), {}), ((2, 3, 129, 257, 128), {}),
             ((1, 2, 300, 100, 64), dict(causal=True)),
             ((1, 2, 300, 300, 128), dict(segment_ids=(ids, ids))),
             ((1, 2, 300, 300, 64), dict(segment_ids=(ids, ids), causal=True,
                                         bias=_randn(gen, 1, 2, 300, 300)))]
    for (b, h, lq, lk, d), masks in cases:
        q, g = (_randn(gen, b, h, lq, d) for _ in range(2))
        k, v = (_randn(gen, b, h, lk, d) for _ in range(2))
        if "bias" in masks:
            poison = torch.full((b, h, lq, lk), float("nan"), device="cuda")
            del poison
        got = _k3_check(q, k, v, g, **masks)
        if "bias" in masks:
            ds = got[1]
            assert bool(torch.isfinite(ds).all())
            assert not bool(ds[:, :, :100, 100:].any())   # skipped tiles


def test_k3_launches_by_route(gen):
    """bf16 takes the sm90 kernel, fp32 the fp32 library; each launch is
    counted under its route, and autograd's backward launches K3 once."""
    routes = tfa.flash_attention_bwd_dq_cuda.routes
    for dtype, route in ((torch.bfloat16, "sm90"), (torch.float32, "fp32")):
        q = _randn(gen, 1, 1, 130, 64, dtype=dtype)
        out, lse = tfa.flash_attention_cuda(q, q, q)
        delta = (q.float() * out.float()).sum(-1)
        n = dict(routes)
        tfa.flash_attention_bwd_dq_cuda(q, q, q, q, lse, delta)
        assert routes[route] == n.get(route, 0) + 1
        assert sum(routes.values()) == sum(n.values()) + 1
    q = _randn(gen, 2, 4, 600, 128).requires_grad_()
    n = routes["sm90"]
    tfa.flash_attention(q, q, q, causal=True).sum().backward()
    assert routes["sm90"] == n + 1


def _fused_f32(gen, b, lq, lk, h, d):
    """fp32 q, k, v as column slices of fused projections, and dO."""
    split = lambda x, n: [t.reshape(b, n, h, d).transpose(1, 2)
                          for t in x.chunk(x.shape[-1] // (h * d), -1)]
    q = split(_randn(gen, b, lq, h * d, dtype=torch.float32), lq)[0]
    k, v = split(_randn(gen, b, lk, 2 * h * d, dtype=torch.float32), lk)
    g = _randn(gen, b, lq, h * d, dtype=torch.float32).reshape(
        b, lq, h, d).transpose(1, 2)
    return q, k, v, g


# ------------------------ the fp32 forward on the tensor cores (TF32 split)
F64_ATOL = 1e-5   # the split's error against fp64 attention


def _tf32(*xs):
    """Each operand cut to TF32 once: what a single-pass kernel reads."""
    return [(x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
            for x in xs]


def _f32_fwd_check(q, k, v, f64_atol=F64_ATOL, **masks):
    """The fp32 forward within 1e-4 of plain fp32 and ``f64_atol`` (1e-5)
    of plain fp64; the plain version fed once-truncated TF32 operands
    outside 1e-4."""
    routes = tfa.flash_attention_cuda.routes
    n = routes["fp32"]
    out, lse = tfa.flash_attention_cuda(q, k, v, **masks)
    assert routes["fp32"] == n + 1
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, **masks)
    _f32_close(out, ref, "out")
    _f32_close(lse, ref_lse, "lse")
    r64, l64 = tfa.flash_attention_plain(q.double(), k.double(), v.double(),
                                         **masks)
    seen = l64 > -1e29   # -1e30 in fp32 is not -1e30 in fp64
    assert (out.double() - r64).abs().max().item() <= f64_atol
    assert (lse.double() - l64)[seen].abs().max().item() <= f64_atol
    assert bool((lse[~seen] <= -1e29).all())
    bad, _ = tfa.flash_attention_plain(*_tf32(q, k, v), **masks)
    assert (bad - ref).abs().max().item() > F32_ATOL     # one TF32 pass
    return out, lse


@pytest.mark.parametrize("lk", EDGE_LENGTHS)
@pytest.mark.parametrize("lq", EDGE_LENGTHS)
@pytest.mark.parametrize("d", [8, 40, 48, 64, 72, 80, 128])
def test_tf32_forward_lengths_around_its_tiles(gen, d, lq, lk):
    """Lq around the 128-query tiles and Lk around the key tiles (64 keys
    at d <= 72, 32 above) and the groups of 8 of v's transposed terms, at
    every head dim of the d <= 128 kernel."""
    f32 = dict(dtype=torch.float32)
    q, k, v = (_randn(gen, 2, 2, n, d, **f32) for n in (lq, lk, lk))
    if lq == 1 or lk == 1:    # one key or one query: too few sums to fail
        out, _ = tfa.flash_attention_cuda(q, k, v)
        _f32_close(out, tfa.flash_attention_plain(q, k, v)[0], "out")
        return
    _f32_fwd_check(q, k, v)


@pytest.mark.parametrize("lq,lk", [(584, 584), (200, 529), (529, 200),
                                   (129, 129)])
def test_tf32_forward_causal(gen, lq, lk):
    """K1 causal in fp32 (the masked instantiation with offsets 0), Lq and
    Lk apart: whole key tiles skipped and tiles crossing the diagonal."""
    f32 = dict(dtype=torch.float32)
    q, k, v = (_randn(gen, 2, 3, n, 64, **f32) for n in (lq, lk, lk))
    _f32_fwd_check(q, k, v, causal=True)


@pytest.mark.parametrize("d", [8, 40, 72, 80, 128])
def test_tf32_forward_reads_fused_projection_slices(gen, d):
    """q|k|v column slices of one fp32 (B, L, 3*H*D) projection: the split
    pre-pass reads them through their strides."""
    b, l, h = 2, 333, 3
    q, k, v = (t.reshape(b, l, h, d).transpose(1, 2) for t in _randn(
        gen, b, l, 3 * h * d, dtype=torch.float32).chunk(3, dim=-1))
    _f32_fwd_check(q, k, v)


@pytest.mark.parametrize("lk", [1024, 1000])
def test_tf32_forward_at_the_checks_sd1_shape(gen, lk):
    """K1 in fp32 at head dim 8 at the shape of the ``checks sd1`` UNet's
    level-0 self-attention, (1, 8, 1024, 1024, 8), on column slices of
    fused projections; Lk = 1000 ends inside a 64-key tile. One launch,
    counted at head dim 8."""
    q, k, v, _ = _fused_f32(gen, 1, 1024, lk, 8, 8)
    n = tfa.flash_attention_cuda.head_dims[8]
    _f32_fwd_check(q, k, v)
    assert tfa.flash_attention_cuda.head_dims[8] == n + 1


@pytest.mark.parametrize("lk", [1, 63, 65, 777, 4097])
@pytest.mark.parametrize("lq", [1, 64, 4096])
def test_tf32_d512_lengths_across_its_splits(gen, lq, lk):
    """K1 at d = 512 in fp32: the key splits the host picks for these
    lengths, the key tail inside a 64-key tile and across the splits."""
    f32 = dict(dtype=torch.float32)
    q, k, v = (_randn(gen, 1, 1, n, 512, **f32) for n in (lq, lk, lk))
    if lq == 1 or lk == 1:
        out, _ = tfa.flash_attention_cuda(q, k, v)
        _f32_close(out, tfa.flash_attention_plain(q, k, v)[0], "out")
        return
    _f32_fwd_check(q, k, v)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_tf32_d512_each_split_count(gen, monkeypatch, splits):
    """Each key split count forced at SD1's VAE shape, merged by lse."""
    monkeypatch.setattr(tfa, "k1_d512_splits", lambda *a: splits)
    f32 = dict(dtype=torch.float32)
    q, k, v = (_randn(gen, 1, 1, 1000, 512, **f32) for _ in range(3))
    _f32_fwd_check(q, k, v)


def test_tf32_forward_writes_every_row(gen, monkeypatch):
    """out and lse handed over filled with NaN: every row written, at each
    kernel and with a key split."""
    blhd = tfa._blhd
    monkeypatch.setattr(tfa, "_blhd", lambda like, n: blhd(like, n).fill_(
        float("nan")))
    monkeypatch.setattr(tfa, "_lse_like", lambda q: torch.full(
        q.shape[:3], float("nan"), device=q.device))
    f32 = dict(dtype=torch.float32)
    for (b, h, lq, lk, d), causal in (((2, 2, 300, 257, 8), False),
                                      ((2, 2, 300, 257, 40), False),
                                      ((1, 2, 129, 300, 128), False),
                                      ((2, 1, 300, 100, 64), True),
                                      ((1, 1, 1000, 700, 512), False)):
        q, k, v = (_randn(gen, b, h, n, d, **f32) for n in (lq, lk, lk))
        _f32_fwd_check(q, k, v, causal=causal)


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("case", sorted(K5_MASK_CASES))
def test_tf32_k5_mask_cases(gen, case, stability):
    """K5 in fp32 on the masked cases of the sm90 K5 at head dim 64: within
    1e-4 of plain fp32 where a key is seen, out = 0 and lse <= -1e29 where
    none is, within 1e-5 of fp64."""
    (b, h, lq, lk), qo, ko, seg_q, seg_k, causal, valid = K5_MASK_CASES[case]
    f32 = dict(dtype=torch.float32)
    q, k, v = (_randn(gen, b, h, n, 64, **f32) for n in (lq, lk, lk))
    kw = dict(causal=causal, valid_len=valid, seg_q=seg_q, seg_k=seg_k,
              stability=stability)
    qo, ko = _offsets(*qo), _offsets(*ko)
    routes = tfa.flash_attention_pos_cuda.routes
    n = routes["fp32"]
    out, lse = tfa.flash_attention_pos_cuda(q, k, v, qo, ko, **kw)
    assert routes["fp32"] == n + 1
    ref, ref_lse = tfa.flash_attention_pos_plain(q, k, v, qo, ko, **kw)
    r64, l64 = tfa.flash_attention_pos_plain(q.double(), k.double(),
                                             v.double(), qo, ko, **kw)
    seen = ref_lse > -1e29
    _f32_close(out, ref, "out")
    assert (out.double() - r64).abs().max().item() <= F64_ATOL
    assert (lse - ref_lse)[seen].abs().max().item() <= F32_ATOL
    assert (lse.double() - l64)[seen].abs().max().item() <= F64_ATOL
    assert not bool(out[~seen].any()) and bool((lse[~seen] <= -1e29).all())
    if case == "fully masked rows":
        assert int((~seen).sum()) == 4 * 512


# -------------------- K1 at the SD1 UNet's head dims from 768^2 (d = 160)
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,h,lq,lk,d", [
    (2, 8, 576, 576, 160), (2, 8, 2304, 2304, 80), (1, 2, 1000, 777, 160)])
def test_k1_sd1_at_768(gen, dtype, b, h, lq, lk, d):
    """The UNet's level-2 (d = 160, 576 tokens at 768^2) and level-1
    (d = 80, 2304 tokens) self-attentions, and a ragged Lk at 160: bf16 on
    the sm90 kernel, fp32 on the TF32 split."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v = (_randn(gen, b, h, n, d, dtype=dt) for n in (lq, lk, lk))
    route = "sm90" if dtype == "bf16" else "fp32"
    n = tfa.flash_attention_cuda.routes[route]
    if dtype == "bf16":
        _k1_check(q, k, v)
    else:
        _f32_fwd_check(q, k, v)
    assert tfa.flash_attention_cuda.routes[route] == n + 1


@pytest.mark.parametrize("case", ["T5-XXL", "hidden rows, ragged keys"])
def test_tf32_forward_t5_bias(gen, case):
    """K1's fp32 bias form: T5's (1, H, L, L) bias shared over the batch at
    scale 1.0, and at Lk = 333 a bias that hides whole rows (-1e30, -inf)
    and part of one: out = 0 and lse <= -1e29 there, nothing NaN. T5's
    logits are unscaled: with unit q and k at d = 64 they spread ~8 wide,
    and the split's 2^-22 of each product moves out ~8 x as far from fp64
    as the scaled forms' logits of ~1 do (~2e-5): the bias form is held to
    1e-4 against fp64, as against plain fp32."""
    f32 = dict(dtype=torch.float32)
    b, h, lq, lk = (2, 64, 512, 512) if case == "T5-XXL" else (2, 4, 300, 333)
    q, k, v = (_randn(gen, b, h, n, 64, **f32) for n in (lq, lk, lk))
    bias = 3.0 * _randn(gen, 1, h, lq, lk, **f32)
    if case != "T5-XXL":
        bias[0, :, 5] = -1e30
        bias[0, 1, 17] = float("-inf")
        bias[0, 2, 40, :300] = -1e30
    out, lse = _f32_fwd_check(q, k, v, F32_ATOL, scale=1.0, bias=bias)
    hidden = lse <= -1e29
    assert int(hidden.sum()) == (0 if case == "T5-XXL" else 2 * (h + 1))
    assert not bool(out[hidden].any()) and bool(torch.isfinite(out).all())


# --------------- the fp32 backward on the tensor cores (TF32 split)
def _tf32_bwd_close(got, plain, ref64, bad, floor=0.0):
    """Each gradient within 1e-4 of plain fp32 and 1e-5 of fp64 (of its
    largest magnitude, with ``floor`` for a gradient that is zero
    everywhere), the one-pass plain version outside 1e-4."""
    for what, a, w, w64, f in zip(("dq", "dk", "dv"), got, plain, ref64, bad):
        _f32_close(a, w, what)
        top = w64.abs().max().item()
        assert (a.double() - w64).abs().max().item() <= F64_ATOL * top + floor
        assert (f.double() - w64).abs().max().item() > F32_ATOL * top, what


@pytest.mark.parametrize("b,h,lq,lk,d,causal", [
    (2, 2, 529, 300, 64, False), (1, 2, 300, 529, 128, False),
    (1, 1, 63, 200, 128, False), (2, 2, 129, 65, 64, False),
    (2, 2, 529, 529, 64, True), (1, 2, 200, 529, 64, True),
    (1, 2, 529, 200, 64, True), (1, 2, 4096, 4096, 64, False),
    (1, 1, 4096, 4096, 128, False)])
def test_tf32_backward_against_fp64(gen, b, h, lq, lk, d, causal):
    """K3 / K4 in fp32: ragged Lq and Lk off the tiles (32 keys and 64 or 128
    queries for dq, 64 or 128 keys and 32 or 16 queries for dk/dv), causal
    at 64, and 4096 keys and queries, over which one accumulator chain
    would drift past 1e-5."""
    f32 = dict(dtype=torch.float32)
    q, g = (_randn(gen, b, h, lq, d, **f32) for _ in range(2))
    k, v = (_randn(gen, b, h, lk, d, **f32) for _ in range(2))
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=causal)
    n3 = tfa.flash_attention_bwd_dq_cuda.routes["fp32"]
    n4 = tfa.flash_attention_bwd_dkv_cuda.routes["fp32"]
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal=causal)
    assert tfa.flash_attention_bwd_dq_cuda.routes["fp32"] == n3 + 1
    assert tfa.flash_attention_bwd_dkv_cuda.routes["fp32"] == n4 + 1
    plain = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    d64 = [x.double() for x in (q, k, v)]
    o64, l64 = tfa.flash_attention_plain(*d64, causal=causal)
    ref64 = tfa.flash_attention_bwd_plain(*d64, o64, l64, g.double(),
                                          causal=causal)
    bad = tfa.flash_attention_bwd_plain(*_tf32(q, k, v), out, lse,
                                        *_tf32(g), causal=causal)
    _tf32_bwd_close(got, plain, ref64, bad)


@pytest.mark.parametrize("lq,lk", [(17, 40), (529, 300), (300, 529),
                                   (64, 257)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [136, 160, 192, 232, 256])
def test_tf32_backward_wide_head_dims_lengths_around_its_tiles(gen, d, causal,
                                                               lq, lk):
    """K3 / K4 in fp32 above head dim 128, the two-block kernels at widths
    160 (136, 160), 192, 256 (232, 256): a short tile each way (17 queries
    against 40 keys), Lq and Lk ragged against the 64-query and 32- or
    16-key tiles of dq and the 64-key and 32- or 16-query tiles of dk/dv,
    Lq != Lk both ways under causal. Each gradient within 1e-4 of plain fp32
    and 1e-5 of fp64 of its largest magnitude; the one-pass plain version
    outside 1e-4 where the sums are long enough to show it (not at 17 x
    40). One launch each on route "fp32", counted at head dim d."""
    f32 = dict(dtype=torch.float32)
    q, g = (_randn(gen, 1, 2, lq, d, **f32) for _ in range(2))
    k, v = (_randn(gen, 1, 2, lk, d, **f32) for _ in range(2))
    out, lse = tfa.flash_attention_cuda(q, k, v, causal=causal)
    fns = (tfa.flash_attention_bwd_dq_cuda, tfa.flash_attention_bwd_dkv_cuda)
    before = [(fn.routes["fp32"], fn.head_dims[d]) for fn in fns]
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert [(fn.routes["fp32"], fn.head_dims[d]) for fn in fns] == [
        (r + 1, n + 1) for r, n in before]
    plain = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    d64 = [x.double() for x in (q, k, v)]
    o64, l64 = tfa.flash_attention_plain(*d64, causal=causal)
    ref64 = tfa.flash_attention_bwd_plain(*d64, o64, l64, g.double(),
                                          causal=causal)
    if lq < 64:
        for what, a, w, w64 in zip(("dq", "dk", "dv"), got, plain, ref64):
            _f32_close(a, w, what)
            top = w64.abs().max().item()
            assert (a.double() - w64).abs().max().item() <= F64_ATOL * top
        return
    bad = tfa.flash_attention_bwd_plain(*_tf32(q, k, v), out, lse,
                                        *_tf32(g), causal=causal)
    _tf32_bwd_close(got, plain, ref64, bad)


@pytest.mark.parametrize("lq,lk", [(4096, 154), (154, 4096), (154, 154),
                                   (529, 154)])
def test_tf32_pos_backward_sd3_shapes_against_fp64(gen, lq, lk):
    """K6 / K7 in fp32 (the position-mask instantiations) at SD3's joint
    shapes and a ragged x length, under the lse and delta of an fp64
    forward, on fused-projection slices."""
    q, k, v, g = _fused_f32(gen, 2, lq, lk, 24, 64)
    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    d64 = [x.double() for x in (q, k, v)]
    o64, l64 = tfa.flash_attention_pos_plain(*d64, z, z)
    delta64 = (g.double() * o64).sum(-1)
    lse, delta = l64.float(), delta64.float()
    routes = tfa.flash_bwd_pos_dkv_cuda.routes
    n = routes["fp32"]
    got = tfa.flash_bwd_pos(q, k, v, g, lse, delta, z, z)
    assert routes["fp32"] == n + 1
    plain = tfa.flash_bwd_pos_plain(q, k, v, g, lse, delta, z, z)
    ref64 = tfa.flash_bwd_pos_plain(*d64, g.double(), l64, delta64, z, z)
    bad = tfa.flash_bwd_pos_plain(*_tf32(q, k, v, g), lse, delta, z, z)
    _tf32_bwd_close(got, plain, ref64, bad)


@pytest.mark.parametrize("case", sorted(K7_MASK_CASES))
def test_tf32_pos_backward_mask_cases_against_fp64(gen, case):
    """K6 / K7 in fp32 on the masked cases of the sm90 K7 under a lse global
    over two key blocks (fp64): rows that only the other block sees, and
    rows no key sees, give finite gradients, dq = 0 on the latter."""
    (b, h, lq, lk), qo, kos, seg_q, seg_k, causal, valid = K7_MASK_CASES[case]
    f64 = dict(dtype=torch.float64)
    q, g = (_randn(gen, b, h, lq, 64, **f64) for _ in range(2))
    kvs = [tuple(_randn(gen, b, h, lk, 64, **f64) for _ in range(2))
           for _ in kos]
    kw = dict(causal=causal, valid_len=valid, seg_q=seg_q, seg_k=seg_k)
    qo, kos = _offsets(*qo), [_offsets(*ko) for ko in kos]
    l64, delta64 = _global_stats(q, kvs, g, qo, kos, **kw)
    blank = l64 <= -1e29
    q32, g32 = q.float(), g.float()
    lse, delta = l64.float(), delta64.float()
    for (k, v), ko in zip(kvs, kos):
        k32, v32 = k.float(), v.float()
        got = tfa.flash_bwd_pos(q32, k32, v32, g32, lse, delta, qo, ko, **kw)
        plain = tfa.flash_bwd_pos_plain(q32, k32, v32, g32, lse, delta, qo,
                                        ko, **kw)
        ref64 = tfa.flash_bwd_pos_plain(q, k, v, g, l64, delta64, qo, ko,
                                        **kw)
        bad = tfa.flash_bwd_pos_plain(*_tf32(q32, k32, v32, g32), lse, delta,
                                      qo, ko, **kw)
        if all(bool(w.any()) for w in ref64):
            _tf32_bwd_close(got, plain, ref64, bad)
        else:   # nothing visible in this block: every gradient 0
            assert not any(bool(a.any()) for a in got)
        assert not bool(got[0][blank].any())


# ---------------------------------------------------------------- int8
@pytest.mark.parametrize("m,k,n", [
    (2 * 4250, 1536, 4608), (2 * 4250, 6144, 1536), (2 * 77, 4096, 10240),
    (2 * 77, 10240, 4096), (2 * 4096, 320, 2560), (2 * 77, 768, 320),
    (17, 64, 32), (16, 64, 32), (1, 4096, 4096), (5, 768, 320)])
def test_int8_matmul_is_exact_on_the_card(gen, m, k, n):
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import quantize as tq

    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    q = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    calls = tq.int8_matmul.launches
    acc = tq.int8_matmul(xq, q.t())       # QuantLinear's (N, K) layout
    assert tq.int8_matmul.launches == calls + 1
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (m, n)
    exact = (xq.double() @ q.t().double()).to(torch.int32)
    assert torch.equal(acc, exact)
    # a row-major (K, N) q is re-laid out, with the same result
    assert torch.equal(tq.int8_matmul(xq, q.t().contiguous()), exact)


def test_int8_dot_and_quant_linear_on_the_card(gen):
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import quantize as tq

    x = _randn(gen, 2, 9, 64)
    lin = torch.nn.Linear(64, 32).cuda().to(torch.bfloat16)
    ql = tq.QuantLinear.from_linear(lin)
    assert ql.q.is_cuda and ql.compute_dtype == torch.bfloat16
    got = ql(x)
    cpu = tq.QuantLinear.from_linear(lin.cpu())
    want = cpu(x.cpu())
    assert got.dtype == torch.bfloat16
    # the same int32 accumulators on both sides: outputs equal but for the
    # fp32 products' rounding, one bf16 ulp
    assert torch.allclose(got.float().cpu(), want.float(), rtol=2 ** -7,
                          atol=1e-6)
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.int8_matmul(torch.ones(32, 12, dtype=torch.int8, device="cuda"),
                       torch.ones(12, 16, dtype=torch.int8, device="cuda"))
    with pytest.raises(ValueError, match="multiples of 8"):
        tq.int8_dot(_randn(gen, 20, 64),
                    torch.ones(64, 12, dtype=torch.int8, device="cuda"),
                    torch.ones(12, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_flash_kernels_at_the_video_unet_shape(gen, dtype):
    """K1, K3 and K4 at the video UNet's level-0 attention on the video
    CLI's train batch, (256, 1, 1024, 1024, 64), against the plain versions:
    bf16 out 2e-2, lse 1e-3, each gradient 2e-2 of its largest; fp32 at
    the fp32 tolerances above."""
    b, h, n, d = 256, 1, 1024, 64
    q, k, v, g = (_randn(gen, b, h, n, d, dtype=dtype) for _ in range(4))
    n1 = tfa.flash_attention_cuda.launches
    out, lse = tfa.flash_attention_cuda(q, k, v)
    n3 = tfa.flash_attention_bwd_dq_cuda.launches
    n4 = tfa.flash_attention_bwd_dkv_cuda.launches
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g)
    assert (tfa.flash_attention_cuda.launches,
            tfa.flash_attention_bwd_dq_cuda.launches,
            tfa.flash_attention_bwd_dkv_cuda.launches) == (n1 + 1, n3 + 1,
                                                           n4 + 1)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g)
    if dtype == torch.bfloat16:
        assert (out.float() - ref.float()).abs().max().item() <= 2e-2
        assert (lse - ref_lse).abs().max().item() <= 1e-3
        _bwd_close(got, want)
    else:
        _f32_close(out, ref, "out")
        _f32_close(lse, ref_lse, "lse")
        for what, a, w in zip(("dq", "dk", "dv"), got, want):
            _f32_close(a, w, what)


# ------------------------------------------- K1, K3, K4 at every head dim
WIDTH_FORMS = {"none": {}, "causal": dict(causal=True),
               "causal+bias+segments": dict(causal=True, bias=True, seg=True)}


@pytest.mark.parametrize("form", sorted(WIDTH_FORMS))
@pytest.mark.parametrize("d", [8, 16, 36, 96, 144, 160, 176, 192, 224, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_every_head_dim_matches_plain(gen, dtype, d, form):
    """K1, K3 and K4 at head dims the sm90 kernels take at padded widths
    (36: padded to 40 by the wrapper first), over several tiles with a
    ragged one, against the plain versions under the same masks: bf16 out
    2e-2, lse 1e-3, each gradient 2e-2 of its largest magnitude (dbias
    too); fp32 (no mask and causal) 1e-4, its gradients 1e-4 of their
    largest magnitude. The wrappers count the launch at the caller's head
    dim."""
    kw = dict(WIDTH_FORMS[form])
    if dtype == torch.float32 and kw.pop("bias", False):
        pytest.skip("the fp32 forms take no bias or segment ids")
    b, h, lq, lk = 2, 2, 300, 260
    q, g = (_randn(gen, b, h, lq, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, b, h, lk, d, dtype=dtype) for _ in range(2))
    masks = dict(causal=kw.get("causal", False))
    if "causal+bias" in form and dtype == torch.bfloat16:
        masks["bias"] = _randn(gen, 1, h, lq, lk, dtype=torch.float32)
        masks["segment_ids"] = (
            (torch.arange(lq, device="cuda") // 110).int().repeat(b, 1),
            (torch.arange(lk, device="cuda") // 90).int().repeat(b, 1))
    n = (tfa.flash_attention_cuda.head_dims[d],
         tfa.flash_attention_bwd_dq_cuda.head_dims[d],
         tfa.flash_attention_bwd_dkv_cuda.head_dims[d])
    out, lse = tfa.flash_attention_cuda(q, k, v, **masks)
    need_dbias = "bias" in masks
    grads = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **masks,
                                         need_dbias=need_dbias)
    assert (tfa.flash_attention_cuda.head_dims[d],
            tfa.flash_attention_bwd_dq_cuda.head_dims[d],
            tfa.flash_attention_bwd_dkv_cuda.head_dims[d]) == tuple(
                x + 1 for x in n)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, **masks)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, **masks,
                                         need_dbias=need_dbias)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    seen = ref_lse > -1e29
    assert out.shape == q.shape and out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse)[seen].abs().max().item() <= max(tol, 1e-3)
    for a, w in zip(grads, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert ((a.float() - w.float()).abs().max().item()
                <= tol * w.float().abs().max().item() + 1e-6)



# ------------------------- every flash form at every head dim, both dtypes
# The fp32 bias (with dbias), segment-id and causal forms of K1, K3 and K4,
# and K5, K6, K7 under two segments a side, valid_len and causal, online and
# bounded, at head dims that take each width class (8 and 36 padded, 96,
# 160 on the one-block fp32 K1 and the two-block K3 / K4, 192 and 256 on the
# streaming fp32 K1). fp32 against the plain versions in fp64: each output
# within F64_REL of its largest magnitude (the TF32 split keeps ~2^-22 of
# each product: these cases show 1e-6 - 5e-6; one TF32 pass would be
# ~1e-3); bf16 at the tolerances above. dbias into a NaN-poisoned pool.
FORM_DIMS = [8, 36, 96, 160, 192, 256]
F64_REL = 1e-5
MASKED_FORMS = [(c, b, s) for c in (False, True) for b in (False, True)
                for s in (False, True)][1:]    # (causal, bias, segments)


def _rel_close(got, want, rel, what):
    assert got.shape == want.shape and torch.isfinite(got).all(), what
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rel * want.double().abs().max().item(), (what, err)


@pytest.mark.parametrize("form", MASKED_FORMS,
                         ids=lambda f: "+".join(n for n, on in zip(
                             ("causal", "bias", "segments"), f) if on))
@pytest.mark.parametrize("d", FORM_DIMS)
def test_fp32_mask_forms_at_every_head_dim(gen, d, form):
    causal, with_bias, with_seg = form
    b, h, lq, lk = 2, 2, 300, 260
    f32 = dict(dtype=torch.float32)
    q, g = _randn(gen, b, h, lq, d, **f32), _randn(gen, b, h, lq, d, **f32)
    k, v = _randn(gen, b, h, lk, d, **f32), _randn(gen, b, h, lk, d, **f32)
    masks = dict(causal=causal)
    if with_bias:
        masks["bias"] = _randn(gen, 1, h, lq, lk, **f32)
    if with_seg:   # ragged runs, boundaries off every tile size
        masks["segment_ids"] = (
            (torch.arange(lq, device="cuda") // 77).int().repeat(b, 1),
            (torch.arange(lk, device="cuda") // 61).int().repeat(b, 1))
    routes = (tfa.flash_attention_cuda.routes["fp32"],
              tfa.flash_attention_bwd_dq_cuda.routes["fp32"])
    out, lse = tfa.flash_attention_cuda(q, k, v, **masks)
    if with_bias:
        torch.full((b, h, lq, lk), float("nan"), device="cuda")
    grads = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **masks,
                                         need_dbias=with_bias)
    assert (tfa.flash_attention_cuda.routes["fp32"],
            tfa.flash_attention_bwd_dq_cuda.routes["fp32"]) == tuple(
                n + 1 for n in routes)
    m64 = {k_: (x.double() if k_ == "bias" else x) for k_, x in masks.items()}
    d64 = [x.double() for x in (q, k, v)]
    ref, ref_lse = tfa.flash_attention_plain(*d64, **m64)
    want = tfa.flash_attention_bwd_plain(*d64, ref, ref_lse, g.double(),
                                         **m64, need_dbias=with_bias)
    seen = ref_lse > -1e29
    _rel_close(out, ref, F64_REL, "out")
    _rel_close(lse[seen], ref_lse[seen], F64_REL, "lse")
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), grads, want):
        _rel_close(a, w, F64_REL, name)


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", FORM_DIMS)
def test_pos_forms_at_every_head_dim(gen, d, dtype, stability):
    b, h, lq, lk = 2, 2, 300, 260
    q, g = (_randn(gen, b, h, lq, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, b, h, lk, d, dtype=dtype) for _ in range(2))
    qo, ko = _offsets(20, 1000), _offsets(50, 900)
    kw = dict(causal=True, valid_len=1000, seg_q=150, seg_k=130)
    wide = dtype == torch.float32
    ins = [x.double() for x in (q, k, v)] if wide else [q, k, v]
    ref, ref_lse = tfa.flash_attention_pos_plain(*ins, qo, ko, **kw)
    seen = ref_lse > -1e29
    assert int((~seen).sum()) == b * h * 30     # positions 20 .. 49
    out, lse = tfa.flash_attention_pos_cuda(q, k, v, qo, ko,
                                            stability=stability, **kw)
    assert out.shape == q.shape and not out[~seen].any()
    assert bool((lse[~seen] <= -1e29).all())
    lse32 = ref_lse.float().contiguous()
    delta = (g.double() * ref.double()).sum(-1)
    got = (tfa.flash_bwd_pos_dq_cuda(q, k, v, g, lse32, delta.float(), qo,
                                     ko, **kw),
           *tfa.flash_bwd_pos_dkv_cuda(q, k, v, g, lse32, delta.float(), qo,
                                       ko, **kw))
    if wide:
        want = tfa.flash_bwd_pos_plain(*ins, g.double(), ref_lse, delta, qo,
                                       ko, **kw)
        _rel_close(out[seen], ref[seen], F64_REL, "out")
        _rel_close(lse[seen], ref_lse[seen], F64_REL, "lse")
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            _rel_close(a, w, F64_REL, name)
        return
    want = tfa.flash_bwd_pos_plain(q, k, v, g, lse32, delta.float(), qo, ko,
                                   **kw)
    assert (out.float() - ref.float())[seen].abs().max().item() <= 2e-2
    assert (lse - ref_lse)[seen].abs().max().item() <= 1e-3
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and torch.isfinite(a.float()).all(), name
        assert ((a.float() - w.float()).abs().max().item()
                <= 2e-2 * w.float().abs().max().item() + 1e-6), name


# ------------------------------------- K1, K3 and K4 above head dim 256
WIDE_DIMS = (264, 300, 384, 512)
WIDE_FORMS = [(c, b, s) for c in (False, True) for b in (False, True)
              for s in (False, True)]           # (causal, bias, segments)


def _wide_masks(gen, form, b, h, lq, lk, kind="packed"):
    causal, bias, seg = form
    masks = dict(causal=causal)
    if bias:
        masks["bias"] = torch.randn((1, h, lq, lk), generator=gen,
                                    device="cuda")
    if seg:
        masks["segment_ids"] = _segments(kind, b, lq, lk)
    return masks


def _wide_check(q, k, v, g, masks, floor=1e-6):
    """K1, K3 and K4 above 256 against their plain versions (bf16: out 2e-2,
    lse 1e-3, each gradient 2e-2 of its largest; fp32: 1e-4 as the fp32
    forms), dbias into a NaN-poisoned pool; one launch of each, on the
    route of the dtype ("d512" / "wide" in bf16, "fp32"); rows that see no
    key give out = 0, lse <= -1e29 and finite gradients."""
    bf16 = q.dtype == torch.bfloat16
    fns = (tfa.flash_attention_cuda, tfa.flash_attention_bwd_dq_cuda,
           tfa.flash_attention_bwd_dkv_cuda)
    names = ("d512", "wide", "wide") if bf16 else ("fp32",) * 3
    before = [fn.routes[r] for fn, r in zip(fns, names)]
    out, lse = tfa.flash_attention_cuda(q, k, v, **masks)
    need = masks.get("bias") is not None
    if need:     # NaNs in the pool dbias is allocated from
        del_me = torch.full((*q.shape[:3], k.shape[2]), float("nan"),
                            device="cuda")
        del del_me
    got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **masks,
                                       need_dbias=need)
    assert [fn.routes[r] for fn, r in zip(fns, names)] == [
        n + 1 for n in before]
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, **masks)
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, **masks,
                                         need_dbias=need)
    seen = ref_lse > -1e29
    tol = 2e-2 if bf16 else F32_ATOL
    assert out.dtype == q.dtype and out.shape == q.shape
    assert (out.float() - ref.float())[seen].abs().max().item() <= tol
    assert (lse - ref_lse)[seen].abs().max().item() <= (1e-3 if bf16
                                                          else F32_ATOL)
    assert bool((lse[~seen] <= -1e29).all()) and not bool(out[~seen].any())
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == w.shape and bool(torch.isfinite(a).all()), name
        a, w = a.float(), w.float()
        assert ((a - w).abs().max().item()
                <= tol * w.abs().max().item() + floor), name
    return out, lse, got


@pytest.mark.parametrize("form", WIDE_FORMS, ids=lambda f: "-".join(
    n for n, on in zip(("causal", "bias", "segments"), f) if on) or "none")
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_wide_heads_every_form_matches_plain(gen, dtype, d, form):
    """Every form at the widths 384 (264, 300 padded to 304) and 512, Lq and
    Lk ragged around the 32- and 64-row tiles."""
    b, h, lq, lk = 2, 2, 200, 150
    q, g = (_randn(gen, b, h, lq, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, b, h, lk, d, dtype=dtype) for _ in range(2))
    _wide_check(q, k, v, g, _wide_masks(gen, form, b, h, lq, lk))


@pytest.mark.parametrize("lk", [1, 31, 33, 64, 65, 130])
@pytest.mark.parametrize("lq", [1, 31, 33, 64, 65, 130])
def test_wide_heads_lengths_around_their_tiles(gen, lq, lk):
    """Lq and Lk around the 64-row blocks and 32-row tiles (the fp32 64-row
    tiles too), at 300 and 512, without a mask and causal (Lq < Lk: keys no
    query sees get dk = dv = 0), in both dtypes; the floor where one key
    makes dS rounding noise, as for K4."""
    floor = 1e-3 if 1 in (lq, lk) else 1e-6
    for dtype in (torch.bfloat16, torch.float32):
        for d in (300, 512):
            q, g = (_randn(gen, 1, 2, lq, d, dtype=dtype) for _ in range(2))
            k, v = (_randn(gen, 1, 2, lk, d, dtype=dtype) for _ in range(2))
            _wide_check(q, k, v, g, {}, floor)
            _wide_check(q, k, v, g, dict(causal=True), floor)


@pytest.mark.parametrize("kind", ["no key", "ragged", "each", "one"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_wide_heads_segments_and_rows_without_keys(gen, dtype, kind):
    """Segment ids at the wide kernels' tiles: rows of a segment with no
    key (out 0, lse -1e30, finite gradients), per-example padding ids,
    every token its own segment (one key each: the floor), one segment;
    with causal and a bias too."""
    b, h, lq, lk = 2, 2, 300, 260
    floor = 1e-3 if kind == "each" else 1e-6
    for d in (264, 512):
        q, g = (_randn(gen, b, h, lq, d, dtype=dtype) for _ in range(2))
        k, v = (_randn(gen, b, h, lk, d, dtype=dtype) for _ in range(2))
        for form in ((False, False, True), (True, True, True)):
            _wide_check(q, k, v, g,
                        _wide_masks(gen, form, b, h, lq, lk, kind), floor)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("form", [(False, False, False), (True, False, False),
                                  (False, False, True), (True, True, True)],
                         ids=["none", "causal", "segments", "all"])
def test_wide_k1_each_split_count_under_masks(gen, monkeypatch, form, splits):
    """K1 above 256 in both dtypes with its keys split over 1 - 4 blocks
    (forced), under causal and segment ids, where a split can hold no key a
    row sees (weight 0 in the merge), at 300 (width 384) and 512."""
    monkeypatch.setattr(tfa, "k1_d512_splits", lambda *a: splits)
    b, h, lq, lk = 1, 2, 130, 700
    for dtype in (torch.bfloat16, torch.float32):
        for d in (300, 512):
            q, k, v = (_randn(gen, b, h, n, d, dtype=dtype)
                       for n in (lq, lk, lk))
            masks = _wide_masks(gen, form, b, h, lq, lk, "no key")
            out, lse = tfa.flash_attention_cuda(q, k, v, **masks)
            ref, ref_lse = tfa.flash_attention_plain(q, k, v, **masks)
            seen = ref_lse > -1e29
            bf16 = dtype == torch.bfloat16
            assert ((out.float() - ref.float())[seen].abs().max()
                    <= (2e-2 if bf16 else F32_ATOL))
            assert ((lse - ref_lse)[seen].abs().max()
                    <= (1e-3 if bf16 else F32_ATOL))
            assert not bool(out[~seen].any())
            assert bool((lse[~seen] <= -1e29).all())


def test_wide_heads_write_every_row(gen, monkeypatch):
    """out, lse, dq, dk and dv handed to the kernels filled with NaN (dbias
    from a NaN-poisoned pool) at 300 and 512 in both dtypes, with segment
    ids that skip tiles and a causal bias: every row written."""
    blhd = tfa._blhd
    monkeypatch.setattr(tfa, "_blhd", lambda like, n: blhd(like, n).fill_(
        float("nan")))
    monkeypatch.setattr(tfa, "_lse_like", lambda q: torch.full(
        q.shape[:3], float("nan"), device=q.device))
    b, h, lq, lk = 2, 1, 257, 190
    for dtype in (torch.bfloat16, torch.float32):
        for d in (300, 512):
            q, g = (_randn(gen, b, h, lq, d, dtype=dtype) for _ in range(2))
            k, v = (_randn(gen, b, h, lk, d, dtype=dtype) for _ in range(2))
            for form in ((False, False, True), (True, True, True)):
                out, lse, grads = _wide_check(
                    q, k, v, g, _wide_masks(gen, form, b, h, lq, lk))
                assert bool(torch.isfinite(out).all())
                assert all(bool(torch.isfinite(t).all()) for t in grads)


@pytest.mark.parametrize("d", [264, 384, 512])
def test_wide_fp32_within_fp64(gen, d):
    """The fp32 K1, K3 and K4 above 256 against fp64 attention (the plain
    versions fed fp64): out and lse within F64_ATOL of each, each gradient
    within 1e-5 of its largest magnitude; the plain version fed operands
    cut once to TF32 must fall outside 1e-4."""
    f32 = dict(dtype=torch.float32)
    q, g = (_randn(gen, 1, 2, 300, d, **f32) for _ in range(2))
    k, v = (_randn(gen, 1, 2, 260, d, **f32) for _ in range(2))
    for causal in (False, True):
        out, lse = tfa.flash_attention_cuda(q, k, v, causal=causal)
        got = tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g,
                                           causal=causal)
        x64 = [x.double() for x in (q, k, v)]
        o64, l64 = tfa.flash_attention_plain(*x64, causal=causal)
        want = tfa.flash_attention_bwd_plain(*x64, o64, l64, g.double(),
                                             causal=causal)
        assert (out.double() - o64).abs().max().item() <= F64_ATOL
        assert (lse.double() - l64).abs().max().item() <= F64_ATOL
        for a, w in zip(got, want):
            assert ((a.double() - w).abs().max().item()
                    <= 1e-5 * w.abs().max().item())
        bad = tfa.flash_attention_bwd_plain(*_tf32(q, k, v), out, lse,
                                            *_tf32(g), causal=causal)
        assert max(((a.double() - w).abs().max() / w.abs().max()).item()
                   for a, w in zip(bad, want)) > 1e-4


def test_wide_k4_is_one_launch_of_both_roles(gen):
    """K4 above 256 computes dk and dv in the same cluster pairs: one launch
    and one count on the route, both outputs right; K3 the dq pairs."""
    q, g = (_randn(gen, 1, 1, 256, 512) for _ in range(2))
    k, v = (_randn(gen, 1, 1, 256, 512) for _ in range(2))
    out, lse = tfa.flash_attention_cuda(q, k, v)
    delta = (g.float() * out.float()).sum(-1)
    n3 = tfa.flash_attention_bwd_dq_cuda.launches
    n4 = tfa.flash_attention_bwd_dkv_cuda.launches
    dk, dv = tfa.flash_attention_bwd_dkv_cuda(q, k, v, g, lse, delta)
    dq = tfa.flash_attention_bwd_dq_cuda(q, k, v, g, lse, delta)
    assert tfa.flash_attention_bwd_dkv_cuda.launches == n4 + 1
    assert tfa.flash_attention_bwd_dq_cuda.launches == n3 + 1
    _bwd_close((dq, dk, dv),
               tfa.flash_attention_bwd_plain(q, k, v, out, lse, g))


@pytest.mark.parametrize("lq,lk", [(97, 161), (161, 97), (223, 190)])
def test_wide_pair_causal_diagonal_at_ragged_lengths(gen, lq, lk):
    """The two blocks of a cluster pair split the head dim and walk one
    tile list: causal at lengths that are no multiple of the 64-row blocks
    or the 32- and 64-column tiles, so that the diagonal tile pairs are
    partly visible and ragged, with and without a bias (dbias), in both
    dtypes at 300 (width 384: block 1 holds columns 192 - 299 and zeros)
    and 512."""
    for dtype in (torch.bfloat16, torch.float32):
        for d in (300, 512):
            q, g = (_randn(gen, 1, 2, lq, d, dtype=dtype) for _ in range(2))
            k, v = (_randn(gen, 1, 2, lk, d, dtype=dtype) for _ in range(2))
            _wide_check(q, k, v, g, dict(causal=True))
            _wide_check(q, k, v, g, _wide_masks(gen, (True, True, False), 1,
                                                2, lq, lk))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_wide_dbias_written_once_per_tile(gen, dtype):
    """dbias at width 512 from a pool poisoned with NaN, under causal and
    segment ids that skip tiles: every element written (finite), equal to
    the plain dS, zeros where the masks hide a pair in every batch element
    (dbias sums the batch: the bias is (1, H, Lq, Lk)), and two calls equal
    bit for bit (block 0 of each pair writes a tile, once)."""
    b, h, lq, lk, d = 2, 2, 300, 260, 512
    q, g = (_randn(gen, b, h, lq, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, b, h, lk, d, dtype=dtype) for _ in range(2))
    masks = _wide_masks(gen, (True, True, True), b, h, lq, lk)
    out, lse = tfa.flash_attention_cuda(q, k, v, **masks)
    dbs = []
    for _ in range(2):
        poison = torch.full((b, h, lq, lk), float("nan"), device="cuda")
        del poison
        dbs.append(tfa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **masks,
                                                need_dbias=True)[3])
    want = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, **masks,
                                         need_dbias=True)[3]
    db = dbs[0]
    assert db.shape == want.shape and bool(torch.isfinite(db).all())
    assert torch.equal(dbs[0], dbs[1])
    tol = 2e-2 if dtype == torch.bfloat16 else F32_ATOL
    assert ((db.float() - want.float()).abs().max().item()
            <= tol * want.float().abs().max().item() + 1e-6)
    visible = tfa._visible_pairs(lq, lk, masks["segment_ids"], True,
                                 q.device).expand(b, h, lq, lk)
    hidden = ~visible.any(0, keepdim=True)     # in every batch element
    assert bool(hidden.any()) and not bool(db[hidden].any())


# ------------------------------------- K5, K6 and K7 above head dim 256
# form -> (offsets of q and k, keywords of flash_attention_pos, rows per
# (b, h) that see no key); q (2, 2, 300, d) against k (2, 2, 260, d)
WIDE_POS_FORMS = {
    "none": ((0, 0), (0, 0), {}, 0),
    "causal": ((0, 0), (0, 0), dict(causal=True), 0),
    "valid_len": ((0, 0), (0, 0), dict(valid_len=200), 0),
    "two segments": ((20, 1000), (50, 900),
                     dict(causal=True, valid_len=1000, seg_q=150,
                          seg_k=130), 30),
    "past valid_len": ((0, 0), (0, 0), dict(valid_len=0), 300),
}


def _wide_pos_check(q, k, v, g, qo, ko, stability="online", floor=1e-6,
                    **kw):
    """K5 (in ``stability``), K6 and K7 above 256 on one input, each one
    launch on its route ("d512" / "wide" in bf16, "fp32"), against the plain
    versions (bf16: out 2e-2 and lse 1e-3 on the rows that see a key, each
    gradient 2e-2 of its largest; fp32 against fp64, 1e-5 of each largest)
    under the plain forward's lse; rows that see no key give out = 0, lse
    <= -1e29 and finite gradients. Returns (out, lse, the gradients)."""
    bf16 = q.dtype == torch.bfloat16
    fns = (tfa.flash_attention_pos_cuda, tfa.flash_bwd_pos_dq_cuda,
           tfa.flash_bwd_pos_dkv_cuda)
    names = ("d512", "wide", "wide") if bf16 else ("fp32",) * 3
    before = [fn.routes[r] for fn, r in zip(fns, names)]
    ins = [q, k, v] if bf16 else [x.double() for x in (q, k, v)]
    ref, ref_lse = tfa.flash_attention_pos_plain(*ins, qo, ko, **kw)
    seen = ref_lse > -1e29
    out, lse = tfa.flash_attention_pos_cuda(q, k, v, qo, ko,
                                            stability=stability, **kw)
    lse32 = ref_lse.float().contiguous()
    delta = (g.double() * ref.double()).sum(-1)
    got = (tfa.flash_bwd_pos_dq_cuda(q, k, v, g, lse32, delta.float(), qo,
                                     ko, **kw),
           *tfa.flash_bwd_pos_dkv_cuda(q, k, v, g, lse32, delta.float(), qo,
                                       ko, **kw))
    assert [fn.routes[r] for fn, r in zip(fns, names)] == [
        n + 1 for n in before]
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool((lse[~seen] <= -1e29).all()) and not bool(out[~seen].any())
    if bf16:
        want = tfa.flash_bwd_pos_plain(q, k, v, g, lse32, delta.float(), qo,
                                       ko, **kw)
        if bool(seen.any()):
            assert (out.float() - ref.float())[seen].abs().max() <= 2e-2
            assert (lse - ref_lse)[seen].abs().max() <= 1e-3
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == w.shape and bool(torch.isfinite(a).all()), name
            assert ((a.float() - w.float()).abs().max().item()
                    <= 2e-2 * w.float().abs().max().item() + floor), name
        return out, lse, got
    want = tfa.flash_bwd_pos_plain(*ins, g.double(), ref_lse, delta, qo, ko,
                                   **kw)
    if bool(seen.any()):
        _rel_close(out[seen], ref[seen], F64_REL, "out")
        _rel_close(lse[seen], ref_lse[seen], F64_REL, "lse")
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert ((a.double() - w).abs().max().item()
                <= F64_REL * w.abs().max().item() + floor * 1e-3), name
    return out, lse, got


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("form", sorted(WIDE_POS_FORMS))
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_wide_pos_forms_match_plain(gen, dtype, d, form, stability):
    """K5 (online and bounded), K6 and K7 at the widths 384 (264, 300
    padded to 304) and 512 in each position form, Lq and Lk ragged around
    the 32- and 64-row tiles, segment boundaries off a multiple of 64; a
    launch whose every key lies past valid_len writes out = 0 and lse =
    -1e30, never NaN."""
    q_off, k_off, kw, blank = WIDE_POS_FORMS[form]
    b, h, lq, lk = 2, 2, 300, 260
    q, g = (_randn(gen, b, h, lq, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, b, h, lk, d, dtype=dtype) for _ in range(2))
    qo, ko = _offsets(*q_off), _offsets(*k_off)
    out, lse, _ = _wide_pos_check(q, k, v, g, qo, ko, stability, **kw)
    assert int((lse <= -1e29).sum()) == b * h * blank


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["none", "causal", "two segments",
                                  "past valid_len"])
def test_wide_k5_each_split_count_under_the_masks(gen, monkeypatch, form,
                                                  splits):
    """K5 above 256 in both dtypes and softmaxes with its keys split over 1
    - 4 blocks (forced), where a split, or every one, holds no key a row
    sees (weight 0 in the merge; the bounded splits' sums merged without a
    running max), at 300 (width 384) and 512."""
    monkeypatch.setattr(tfa, "k1_d512_splits", lambda *a: splits)
    q_off, k_off, kw, _ = WIDE_POS_FORMS[form]
    b, h, lq, lk = 1, 2, 130, 700
    qo, ko = _offsets(*q_off), _offsets(*k_off)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (300, 512):
            q, k, v = (_randn(gen, b, h, n, d, dtype=dtype)
                       for n in (lq, lk, lk))
            ins = [x.double() for x in (q, k, v)] if dtype == torch.float32 \
                else [q, k, v]
            ref, ref_lse = tfa.flash_attention_pos_plain(*ins, qo, ko, **kw)
            seen = ref_lse > -1e29
            for stability in ("online", "bounded"):
                out, lse = tfa.flash_attention_pos_cuda(
                    q, k, v, qo, ko, stability=stability, **kw)
                assert not bool(out[~seen].any())
                assert bool((lse[~seen] <= -1e29).all())
                if not bool(seen.any()):
                    continue
                if dtype == torch.bfloat16:
                    assert ((out.float() - ref.float())[seen].abs().max()
                            <= 2e-2)
                    assert (lse - ref_lse)[seen].abs().max() <= 1e-3
                else:
                    _rel_close(out[seen], ref[seen], F64_REL, "out")
                    _rel_close(lse[seen], ref_lse[seen], F64_REL, "lse")


def test_wide_pos_write_every_row(gen, monkeypatch):
    """out, lse, dq, dk and dv handed to K5, K6 and K7 filled with NaN at
    300 and 512 in both dtypes, under two segments with causal and
    valid_len (rows that see no key, key tiles no query sees): every row
    written, nothing NaN."""
    blhd = tfa._blhd
    monkeypatch.setattr(tfa, "_blhd", lambda like, n: blhd(like, n).fill_(
        float("nan")))
    monkeypatch.setattr(tfa, "_lse_like", lambda q: torch.full(
        q.shape[:3], float("nan"), device=q.device))
    q_off, k_off, kw, _ = WIDE_POS_FORMS["two segments"]
    qo, ko = _offsets(*q_off), _offsets(*k_off)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (300, 512):
            q, g = (_randn(gen, 2, 1, 300, d, dtype=dtype) for _ in range(2))
            k, v = (_randn(gen, 2, 1, 260, d, dtype=dtype) for _ in range(2))
            out, lse, grads = _wide_pos_check(q, k, v, g, qo, ko, **kw)
            assert bool(torch.isfinite(out).all())
            assert bool(torch.isfinite(lse).all())
            assert all(bool(torch.isfinite(t).all()) for t in grads)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_wide_joint_attention_matches_concatenated(gen, dtype):
    """``joint_flash_attention`` at heads of 384 (SD3's 154 context tokens
    against 600 x tokens): both outputs and the six gradients against
    attention over the concatenated streams (the plain K1 / K3 / K4; fp32:
    fp64), 4 x K5, 4 x K6 and 4 x K7 on their wide routes."""
    d, lc, lx = 384, 154, 600
    xs = [_randn(gen, 2, 2, n, d, dtype=dtype)
          for n in (lc, lc, lc, lx, lx, lx)]
    gc_, gx = (_randn(gen, 2, 2, n, d, dtype=dtype) for n in (lc, lx))
    before = [fn.launches for fn in (tfa.flash_attention_pos_cuda,
                                     tfa.flash_bwd_pos_dq_cuda,
                                     tfa.flash_bwd_pos_dkv_cuda)]
    leaves = [x.detach().requires_grad_() for x in xs]
    oc, ox = tfa.joint_flash_attention(*leaves)
    grads = torch.autograd.grad((oc, ox), leaves, (gc_, gx))
    assert [fn.launches for fn in (tfa.flash_attention_pos_cuda,
                                   tfa.flash_bwd_pos_dq_cuda,
                                   tfa.flash_bwd_pos_dkv_cuda)] == [
        n + 4 for n in before]
    wide = (lambda x: x) if dtype == torch.bfloat16 else (
        lambda x: x.double())
    cat = [torch.cat([wide(c), wide(x)], 2) for c, x in zip(xs[:3], xs[3:])]
    gcat = torch.cat([wide(gc_), wide(gx)], 2)
    ref, ref_lse = tfa.flash_attention_plain(*cat)
    want = tfa.flash_attention_bwd_plain(*cat, ref, ref_lse, gcat)
    out = torch.cat([oc, ox], 2)
    got = [torch.cat([grads[i], grads[i + 3]], 2) for i in range(3)]
    if dtype == torch.bfloat16:
        assert (out.float() - ref.float()).abs().max() <= 2e-2
        _bwd_close(got, want)
    else:
        _rel_close(out, ref, F64_REL, "out")
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            _rel_close(a, w, F64_REL, name)


def test_wide_ring_hop_at_512(gen):
    """The ring hop at head dim 512 (shard 0's queries against shard 3's
    keys of a 4-shard ring over SD3's 4250 tokens padded to 4252, 3 heads:
    offsets (0, 0) / (3189, 0), valid_len 4250, the last two keys padding)
    in both dtypes: K5, K6 and K7 on their wide routes against the plain
    versions."""
    n = 1063
    for dtype in (torch.bfloat16, torch.float32):
        q, g = (_randn(gen, 2, 3, n, 512, dtype=dtype) for _ in range(2))
        k, v = (_randn(gen, 2, 3, n, 512, dtype=dtype) for _ in range(2))
        _wide_pos_check(q, k, v, g, _offsets(0, 0), _offsets(3 * n, 0),
                        seg_q=n, seg_k=n, valid_len=4250)
