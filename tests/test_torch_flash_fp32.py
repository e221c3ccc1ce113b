"""The fp32 form of the six flash kernels: the port's plain fp32 versions
(the oracle the CUDA fp32 kernels are held to on the card) against the
Pallas kernels of the JAX package in interpret mode on fp32 inputs, where
every dot runs at ``Precision.HIGHEST``; and the dispatch around them
(``use_flash=``, the dtype checks, the second shared library).

Inputs come from a numpy seed and go to both packages. Tolerances: ``out``
and ``lse`` to 1e-5 absolute (values of order 1, fp32 sums over at most 584
keys taken in another block order); each gradient to 1e-4 of its largest
magnitude.

fp32 cases that other files already hold, not repeated here: K1 blocked at
d = 80 and 512 and single-pass at d = 40
(``test_torch_ops.py::test_flash_plain_matches_jax_blocked_kernel``,
``::test_flash_plain_matches_jax_wide_kernel``); the causal, bias and
segment-id forms of K1 / K3 / K4 (``test_torch_flash_masks.py``, every case
but the two bf16 ones; ``out`` and gradients, not ``lse``); K5 with two
segments, ``valid_len`` and rows that see no key
(``test_torch_sd3_ops.py::test_flash_attention_pos_*``); K6 / K7 with two
segments and under a global lse
(``test_torch_mmdit_train_ops.py::test_flash_bwd_pos_*``). This file adds
``lse`` under causal, the head dims and lengths the fp32 defaults reach
(64 at 576 / 584 tokens, 128, a 529-token length), and K5 - K7 at them.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build
from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as tattn
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

OUT_ATOL = 1e-5      # out and lse, absolute
GRAD_REL = 1e-4      # gradients, of the largest magnitude


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _qkvg(b, h, lq, lk, d, seed):
    return (_rand((b, h, lq, d), seed, 0.7), _rand((b, h, lk, d), seed + 1,
                                                    0.7),
            _rand((b, h, lk, d), seed + 2), _rand((b, h, lq, d), seed + 3))


def _grad_close(got, want, what):
    got, want = got.numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and got.dtype == np.float32, what
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=GRAD_REL * np.abs(want).max())


# (b, h, lq, lk, d, causal)
K1_CASES = {
    "siglip_576_d64": (1, 2, 576, 576, 64, False),
    "decoder_584_d64_causal": (1, 2, 584, 584, 64, True),
    "tiny_sd_d128": (1, 1, 300, 300, 128, False),
    "ragged_529_d64": (1, 2, 529, 200, 64, False),
    "causal_lq_lt_lk": (1, 2, 130, 300, 64, True),
    "causal_lq_gt_lk": (1, 2, 300, 130, 64, True),
}


@pytest.mark.parametrize("name", K1_CASES)
def test_k1_plain_fp32_matches_pallas(name):
    """K1's ``out`` and ``lse``, no-mask and causal, against
    ``_fwd_kernel``."""
    b, h, lq, lk, d, causal = K1_CASES[name]
    q, k, v, _ = _qkvg(b, h, lq, lk, d, 100)
    want_out, want_lse = jfa._flash_fwd(
        *map(jnp.asarray, (q, k, v)), None, None, causal, d ** -0.5, 128, 128,
        interpret=True)
    got_out, got_lse = tfa.flash_attention_forward(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got_out.dtype == got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=OUT_ATOL)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_k1_plain_matches_pallas_at_head_dim_160(dtype):
    """K1 at head dim 160 (the SD1 UNet's level-2 self-attention from 768^2)
    against ``_fwd_kernel`` on the same dtype, at a ragged length. bf16: out
    to 4e-3 (two roundings of values of order 0.1 to bf16's 2^-9, one in
    each package), lse to 1e-3 (fp32 logits of bf16 operands summed in
    another order); fp32: both to OUT_ATOL."""
    q, k, v, _ = _qkvg(1, 2, 200, 230, 160, 150)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    want_out, want_lse = jfa._flash_fwd(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), None, None, False,
        160 ** -0.5, 128, 128, interpret=True)
    got_out, got_lse = tfa.flash_attention_forward(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)))
    atol, lse_atol = (4e-3, 1e-3) if dtype == "bf16" else (OUT_ATOL,
                                                           OUT_ATOL)
    np.testing.assert_allclose(
        got_out.float().numpy(), np.asarray(want_out).astype(np.float32),
        rtol=0, atol=atol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=lse_atol)


def test_k1_plain_fp32_with_t5_bias_matches_pallas():
    """K1's fp32 bias form as T5 reaches it: scale 1.0, a (1, H, Lq, Lk)
    bias shared over the batch, against ``_fwd_kernel`` with that bias on
    the rows that see a key. Rows the bias hides whole (-1e30, or -inf on
    every key) give out = 0 and lse <= -1e29 in the port; the Pallas kernel
    gives lse = -1e30 there too, and the mean of v for out."""
    q, k, v, _ = _qkvg(2, 3, 300, 333, 64, 160)
    bias = _rand((1, 3, 300, 333), 165, 3.0)
    bias[0, :, 5] = -1e30
    bias[0, 1, 40] = -np.inf
    bias[0, 2, 77, :200] = -1e30      # hidden on the first keys only
    want_out, want_lse = (np.asarray(x) for x in jfa._flash_fwd(
        *map(jnp.asarray, (q, k, v, bias)), None, False, 1.0, 128, 128,
        interpret=True))
    got_out, got_lse = (x.numpy() for x in tfa.flash_attention_forward(
        *map(torch.from_numpy, (q, k, v)), 1.0,
        bias=torch.from_numpy(bias)))
    hidden = np.zeros((2, 3, 300), bool)
    hidden[:, :, 5] = hidden[:, 1, 40] = True
    assert np.array_equal(got_lse <= -1e29, hidden)
    assert np.all(want_lse[hidden] <= -1e29)
    assert not got_out[hidden].any() and np.isfinite(got_out).all()
    np.testing.assert_allclose(got_out[~hidden], want_out[~hidden], rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(got_lse[~hidden], want_lse[~hidden], rtol=0,
                               atol=OUT_ATOL)


def test_fp32_bias_form_is_k1s_alone():
    """K1 takes T5's bias in fp32 at head dim 64, alone, and every other
    bias form in fp32 too: with causal or segment ids, at another head dim,
    and in K3 / K4 (dbias from K3), all on the TF32 kernels."""
    assert tfa.k1_route(torch.float32, 64, bias=True) == "fp32"
    for kw in (dict(d=128, bias=True), dict(d=64, bias=True, causal=True),
               dict(d=64, bias=True, segments=True)):
        assert tfa.k1_route(torch.float32, **kw) == "fp32"
    for route in (tfa.k3_route, tfa.k4_route):
        assert route(torch.float32, 64, bias=True) == "fp32"


@pytest.mark.parametrize("name", ["siglip_576_d64", "decoder_584_d64_causal",
                                  "tiny_sd_d128", "ragged_529_d64",
                                  "causal_lq_lt_lk"])
def test_k3_k4_plain_fp32_match_pallas(name):
    """dq (K3) and dk, dv (K4) against ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel`` through the JAX custom VJP."""
    b, h, lq, lk, d, causal = K1_CASES[name]
    q, k, v, g = _qkvg(b, h, lq, lk, d, 200)

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, block_q=128,
                                   block_k=128, interpret=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    out, lse = tfa.flash_attention_forward(tq, tk, tv, causal=causal)
    got = tfa.flash_attention_backward(tq, tk, tv, out, lse, tg,
                                       causal=causal)
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        _grad_close(a, w, what)


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("lq,lk", [(529, 154), (154, 529), (576, 576)])
def test_k5_plain_fp32_matches_pallas(stability, lq, lk):
    """K5 at head dim 64 on the lengths of a joint attention with a
    529-token x stream, both stabilities, against ``_fwd_kernel_pos``."""
    q, k, v, _ = _qkvg(1, 2, lq, lk, 64, 300)
    z = np.zeros(2, np.int32)
    want, want_lse = jfa.flash_attention_pos(
        *map(jnp.asarray, (q, k, v, z, z)), block_q=128, block_k=128,
        interpret=True, stability=stability)
    got, got_lse = tfa.flash_attention_pos(
        *map(torch.from_numpy, (q, k, v, z, z)), stability=stability)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=OUT_ATOL)


@pytest.mark.parametrize("lq,lk,causal", [(529, 154, False), (154, 529, False),
                                          (300, 529, True)])
def test_k6_k7_plain_fp32_match_pallas(lq, lk, causal):
    """K6 / K7 at head dim 64 under the lse and delta of the same block's
    forward, against ``_bwd_dq_kernel_pos`` and ``_bwd_dkv_kernel_pos``;
    the causal case shifts the queries by 40 positions."""
    q, k, v, g = _qkvg(1, 2, lq, lk, 64, 400)
    q_off = np.asarray([40, 40] if causal else [0, 0], np.int32)
    z = np.zeros(2, np.int32)
    tq, tk, tv, tg, tqo, tz = map(torch.from_numpy, (q, k, v, g, q_off, z))
    out, lse = tfa.flash_attention_pos(tq, tk, tv, tqo, tz, causal=causal)
    assert (lse > -1e29).all()
    delta = (tg * out).sum(-1)
    want = jfa.flash_bwd_pos(
        *map(jnp.asarray, (q, k, v, g, lse.numpy(), delta.numpy(), q_off, z)),
        block_q=128, block_k=128, interpret=True, causal=causal)
    got = tfa.flash_bwd_pos(tq, tk, tv, tg, lse, delta, tqo, tz,
                            causal=causal)
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        _grad_close(a, w, what)


def test_fp32_plain_versions_round_nothing():
    """In fp32 the plain versions' casts of P and dS to the input dtype are
    the identity: fed operands rounded once to bf16 they fall outside the
    tolerance the fp32 kernels are held to on the card, 1e-4 (the planted
    fault of that check), several times over."""
    q, k, v, g = map(torch.from_numpy, _qkvg(1, 2, 300, 300, 64, 500))
    r = lambda x: x.bfloat16().float()
    out, lse = tfa.flash_attention_plain(q, k, v)
    bad, _ = tfa.flash_attention_plain(r(q), r(k), r(v))
    assert (out - bad).abs().max() > 3 * 1e-4
    dq = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g)[0]
    bad_dq = tfa.flash_attention_bwd_plain(r(q), r(k), r(v), out, lse, r(g))[0]
    assert (dq - bad_dq).abs().max() > 3 * 1e-4 * dq.abs().max()


# ------------------------------------------------------------------ dispatch
def test_use_flash_false_is_the_plain_path():
    q, k, v, _ = map(torch.from_numpy, _qkvg(1, 2, 600, 600, 64, 600))
    want = tattn.plain_attention(q, k, v)
    got = tattn.dot_product_attention(q, k, v, use_flash=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        tattn.multi_head_attention(q[0].transpose(0, 1).reshape(1, 600, 128),
                                   k[0].transpose(0, 1).reshape(1, 600, 128),
                                   v[0].transpose(0, 1).reshape(1, 600, 128),
                                   2, use_flash=False),
        want[0].transpose(0, 1).reshape(1, 600, 128), rtol=0, atol=0)
    ids = torch.zeros(1, 600, dtype=torch.int32)
    torch.testing.assert_close(
        tattn.dot_product_attention(q, k, v, use_flash=False,
                                    segment_ids=(ids, ids)), want)


def test_use_flash_none_follows_eligibility(monkeypatch):
    """``None`` asks ``_flash_eligible`` (false on CPU tensors), as the JAX
    dispatch does."""
    q, k, v, _ = map(torch.from_numpy, _qkvg(1, 1, 600, 600, 64, 610))
    asked = []
    monkeypatch.setattr(tattn, "_flash_eligible",
                        lambda q, k: asked.append(1) or False)
    tattn.dot_product_attention(q, k, v)
    tattn.dot_product_attention(q, k, v, use_flash=False)
    assert len(asked) == 1


def test_use_flash_true_on_cpu_raises():
    q, k, v, _ = map(torch.from_numpy, _qkvg(1, 1, 600, 600, 64, 620))
    with pytest.raises(ValueError, match="use_flash=True needs CUDA"):
        tattn.dot_product_attention(q, k, v, use_flash=True)
    with pytest.raises(ValueError, match="use_flash=True needs CUDA"):
        tattn.dot_product_attention(q[:, :, :8], k[:, :, :8], v[:, :, :8],
                                    use_flash=True)


def test_fp32_forms_that_are_not_ported_say_what_to_pass():
    """The bias and segment-id forms take fp32 as bf16 does; only a head
    dim past 512 is refused, naming the entry point and what it takes.
    Causal takes fp32 at every head dim up to 256, on the TF32 kernels
    throughout: above 160 the forward on the streaming kernel, where the
    resident Q tile does not fit."""
    assert tfa.k3_route(torch.float32, 64) == "fp32"
    assert tfa.k3_route(torch.float32, 64, causal=True) == "fp32"
    assert tfa.k3_route(torch.bfloat16, 64, True, True, True) == "sm90"
    for kw in (dict(bias=True, segments=False, causal=False),
               dict(bias=False, segments=True, causal=True)):
        assert tfa.k3_route(torch.float32, 64, **kw) == "fp32"
        assert tfa.k3_route(torch.float32, 320, **kw) == "fp32"
        with pytest.raises(NotImplementedError,
                           match="flash_attention_bwd_dq_cuda takes head "
                                 "dims 1 to 512"):
            tfa.k3_route(torch.float32, 520, **kw)
    assert tfa.k3_route(torch.float32, 128, causal=True) == "fp32"
    assert tfa.k3_route(torch.float32, 96, causal=True) == "fp32"
    assert tfa.k3_route(torch.float32, 192, causal=True) == "fp32"
    assert tfa.k1_route(torch.float32, 192, causal=True) == "fp32"


@pytest.mark.parametrize("dtype,vec", [(torch.float32, 4),
                                       (torch.bfloat16, 8)])
def test_kernels_read_strides_of_16_bytes(dtype, vec):
    """A fused q|k|v projection's column slices go in without a copy when
    every stride is a multiple of 16 bytes: 4 fp32 or 8 bf16 elements."""
    qkv = torch.zeros(2, 16, 3 * 2 * 40, dtype=dtype)
    q = qkv[..., :80].reshape(2, 16, 2, 40).transpose(1, 2)
    assert tfa._readable(q) and tfa._kernel_operand(q, dtype) is q
    odd = torch.zeros(2, 2, 16, 40 + vec // 2, dtype=dtype)[..., :40]
    assert not tfa._readable(odd)
    assert tfa._readable(tfa._kernel_operand(odd, dtype))
    assert not tfa._readable(q.transpose(2, 3))
    with pytest.raises(ValueError, match=f"multiples of {vec}"):
        tfa._check_operand("k", odd, odd)


def test_fp32_kernels_are_a_library_of_their_own():
    """Two shared objects, keyed apart: the fp32 sources lie in csrc/fp32
    and do not enter the first library's key, and every entry a wrapper
    calls has a signature."""
    first, second = (_build.library_path(n) for n in _build._LIBRARIES)
    assert first != second and "fp32" in second.name
    assert {p.parent.name for p in _build._sources("kernels_fp32")} == {"fp32"}
    assert not {p.name for p in _build._sources("kernels")} & {
        p.name for p in _build._sources("kernels_fp32")}
    entries = set(_build._SIGNATURES_FP32)
    assert entries == {"fdsd_flash_fwd_f32", "fdsd_flash_bwd_dq_f32",
                       "fdsd_flash_bwd_dkv_f32", "fdsd_flash_fwd_pos_f32",
                       "fdsd_flash_bwd_pos_dq_f32",
                       "fdsd_flash_bwd_pos_dkv_f32"}
    source = "".join(p.read_text() for p in _build._sources("kernels_fp32"))
    for name, argtypes in _build._SIGNATURES_FP32.items():
        head = source.split(f'extern "C" int {name}(')[1].split(")")[0]
        assert len(head.split(",")) == len(argtypes), name
    # the fp32 position-masked kernels take the arguments of their bf16
    # namesakes (one call site serves both) with their split terms'
    # workspace after the offsets; the forward's are its bf16 namesake's
    # own, whose scratch after the offsets and key splits before the stream
    # serve the bf16 K5 above head dim 256
    pos = _build._SIGNATURES["fdsd_flash_fwd_pos"]
    assert pos[7] == ctypes.c_void_p and pos[-2] == ctypes.c_int
    assert _build._SIGNATURES_FP32["fdsd_flash_fwd_pos_f32"] == pos
    for name, offsets_end in (("fdsd_flash_bwd_pos_dq", 9),
                              ("fdsd_flash_bwd_pos_dkv", 10)):
        pos = _build._SIGNATURES[name]
        want = pos[:offsets_end] + [ctypes.c_void_p] + pos[offsets_end:]
        assert _build._SIGNATURES_FP32[name + "_f32"] == want, name


def test_wrappers_count_launches_by_dtype():
    """Every kernel wrapper has a per-dtype counter beside ``launches``, and
    nothing on the CPU moves either."""
    wrappers = (tfa.flash_attention_cuda, tfa.flash_attention_bwd_dq_cuda,
                tfa.flash_attention_bwd_dkv_cuda,
                tfa.flash_attention_pos_cuda, tfa.flash_bwd_pos_dq_cuda,
                tfa.flash_bwd_pos_dkv_cuda)
    before = [(w.launches, dict(w.dtypes)) for w in wrappers]
    q, k, v, g = map(torch.from_numpy, _qkvg(1, 1, 520, 520, 64, 700))
    q.requires_grad_()
    tattn.dot_product_attention(q, k, v).backward(g)
    tfa.joint_flash_attention(q, k, v, q, k, v)
    assert before == [(w.launches, dict(w.dtypes)) for w in wrappers]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfa.flash_attention_cuda(q.detach(), k, v)
