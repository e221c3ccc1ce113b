"""Parity of the SD3 slice's ops with the JAX package's, on the CPU in fp32.

Inputs come from numpy seeds and go through both frameworks. The JAX side
runs its Pallas position-masked kernel in interpret mode; the port runs its
plain PyTorch versions (its CUDA kernel takes CUDA tensors only).

Tolerances: attention outputs and log-sum-exps atol 2e-5 / rtol 1e-4 (the
fp32 flash tolerance of tests/test_flash_attention.py: block-wise against
whole-row summation order); norms atol 1e-5; tables exact or rtol 1e-6.
A row that sees no key is compared on lse only (both <= -1e29): there the
port gives out = 0 where the JAX online body gives the mean of v.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import text_encoders as jte
from from_ddpm_to_stable_diffusion_tpu.ops import attention as jattn
from from_ddpm_to_stable_diffusion_tpu.ops import embeddings as jemb
from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from from_ddpm_to_stable_diffusion_tpu.ops import groupnorm as jgn
from from_ddpm_to_stable_diffusion_tpu.ops import schedules as jsched
from from_ddpm_to_stable_diffusion_tpu.samplers import flow as jflow
from from_ddpm_to_stable_diffusion_tpu_torch.models import (
    text_encoders as tte)
from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as tattn
from from_ddpm_to_stable_diffusion_tpu_torch.ops import embeddings as temb
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as tgn
from from_ddpm_to_stable_diffusion_tpu_torch.ops import schedules as tsched
from from_ddpm_to_stable_diffusion_tpu_torch.samplers import flow as tflow
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

ATOL, RTOL = 2e-5, 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _qkv(b, h, lq, lk, d, seed):
    return (_rand((b, h, lq, d), seed, 0.7), _rand((b, h, lk, d), seed + 1,
                                                    0.7),
            _rand((b, h, lk, d), seed + 2))


def _i32(*xs):
    return np.asarray(xs, np.int32)


def _compare_pos(q, k, v, q_off, kv_off, **kw):
    """The port's plain version against the Pallas kernel in interpret
    mode; returns the mask of rows that see a key."""
    want, want_lse = jfa.flash_attention_pos(
        *map(jnp.asarray, (q, k, v, q_off, kv_off)), block_q=128,
        block_k=128, interpret=True, **kw)
    got, got_lse = tfa.flash_attention_pos(
        *map(torch.from_numpy, (q, k, v, q_off, kv_off)), **kw)
    want, want_lse = np.asarray(want), np.asarray(want_lse)
    got, got_lse = got.numpy(), got_lse.numpy()
    assert got.shape == q.shape and got_lse.shape == q.shape[:3]
    seen = want_lse > -1e29
    np.testing.assert_array_equal(got_lse > -1e29, seen)
    np.testing.assert_allclose(got[seen], want[seen], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_lse[seen], want_lse[seen], atol=ATOL,
                               rtol=RTOL)
    assert not got[~seen].any()
    return seen


# ------------------------------------------------ position-masked attention
@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("causal,valid_len", [(True, None), (False, 200),
                                              (True, 200)])
def test_flash_attention_pos_two_segments_matches_jax(stability, causal,
                                                      valid_len):
    """The zig-zag chunk layout of tests/test_flash_attention.py: local
    blocks made of global chunks [256, 320) + [448, 512) and [64, 128) +
    [384, 448)."""
    q, k, v = _qkv(1, 2, 128, 128, 32, 70)
    seen = _compare_pos(q, k, v, _i32(256, 448), _i32(64, 384),
                        causal=causal, valid_len=valid_len, seg_q=64,
                        seg_k=64, stability=stability)
    assert seen.any()


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("lq,lk", [(154, 154), (154, 256), (256, 154)])
def test_flash_attention_pos_ragged_lengths_match_jax(stability, lq, lk):
    """SD3's 154-token context stream at head dim 64: a ragged key tail and
    ragged query rows, offsets 0, no mask; also equal to the unmasked flash
    forward."""
    q, k, v = _qkv(2, 2, lq, lk, 64, 80)
    z = _i32(0, 0)
    assert _compare_pos(q, k, v, z, z, stability=stability).all()
    got, got_lse = tfa.flash_attention_pos(
        *map(torch.from_numpy, (q, k, v, z, z)), stability=stability)
    ref, ref_lse = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), ref_lse.numpy(), atol=1e-5)


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("causal,valid_len,kv_off", [
    (False, 0, (0, 0)),          # valid_len = 0: no row sees a key
    (True, None, (400, 900)),    # causal: the first q segment sees nothing
    (True, 450, (400, 900)),     # ... and valid_len cuts the second k segment
])
def test_flash_attention_pos_fully_masked_rows(stability, causal, valid_len,
                                               kv_off):
    q, k, v = _qkv(1, 2, 200, 170, 64, 90)
    seen = _compare_pos(q, k, v, _i32(128, 640), _i32(*kv_off),
                        causal=causal, valid_len=valid_len, seg_q=128,
                        seg_k=100, stability=stability)
    if valid_len == 0:
        assert not seen.any()
    else:
        assert not seen[:, :, :128].any() and seen[:, :, 128:].all()
    got_lse = tfa.flash_attention_pos(
        *map(torch.from_numpy, (q, k, v, _i32(128, 640), _i32(*kv_off))),
        causal=causal, valid_len=valid_len, seg_q=128, seg_k=100,
        stability=stability)[1].numpy()
    np.testing.assert_array_equal(got_lse[~seen], np.float32(-1e30))


def test_flash_attention_pos_rejects_unknown_stability():
    q = torch.zeros(1, 1, 4, 8)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tfa.flash_attention_pos(q, q, q, z, z, stability="fast")


def test_pos_kernel_wrapper_takes_only_cuda_tensors():
    """On the CPU the public entry runs the plain version; the kernel entry
    refuses and its counter stays put."""
    q = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
    z = torch.zeros(2, dtype=torch.int32)
    n = tfa.flash_attention_pos_cuda.launches
    out, lse = tfa.flash_attention_pos(q, q, q, z, z)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    with pytest.raises(ValueError):
        tfa.flash_attention_pos_cuda(q, q, q, z, z)
    assert tfa.flash_attention_pos_cuda.launches == n


# ------------------------------------------------------- merge and joint
def test_merge_attention_partials_matches_jax():
    o1, o2 = _rand((2, 3, 50, 16), 1), _rand((2, 3, 50, 16), 2)
    l1, l2 = _rand((2, 3, 50), 3, 2.0), _rand((2, 3, 50), 4, 2.0)
    l1[0, 0, :5] = -1e30           # a partial that saw nothing
    l2[0, 1, :5] = -1e30
    l1[1, 2, :3] = l2[1, 2, :3] = -1e30
    want, want_lse = jfa.merge_attention_partials(
        *map(jnp.asarray, (o1, l1, o2, l2)))
    got, got_lse = tfa.merge_attention_partials(
        *map(torch.from_numpy, (o1, l1, o2, l2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-6)
    np.testing.assert_array_equal(got.numpy()[0, 0, :5], o2[0, 0, :5])


@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("lc,lx", [(26, 256), (154, 512)])
def test_joint_flash_attention_matches_jax(stability, lc, lx):
    """Four lse-merged position-masked calls: against the JAX package's
    (interpret mode) and against the port's own plain attention over the
    concatenated sequence."""
    b, h, d = 2, 3, 32
    qc, kc, vc = (_rand((b, h, lc, d), 40 + i) for i in range(3))
    qx, kx, vx = (_rand((b, h, lx, d), 44 + i) for i in range(3))
    want_c, want_x = jfa.joint_flash_attention(
        *map(jnp.asarray, (qc, kc, vc, qx, kx, vx)), d ** -0.5, block_q=128,
        block_k=128, interpret=True, stability=stability)
    tensors = list(map(torch.from_numpy, (qc, kc, vc, qx, kx, vx)))
    got_c, got_x = tfa.joint_flash_attention(*tensors, d ** -0.5, stability)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL,
                               rtol=RTOL)
    q, k, v = (torch.cat(ab, dim=2) for ab in zip(tensors[:3], tensors[3:]))
    ref = tattn.plain_attention(q, k, v)
    np.testing.assert_allclose(torch.cat([got_c, got_x], dim=2).numpy(),
                               ref.numpy(), atol=ATOL, rtol=RTOL)


def test_joint_attention_blhd_matches_jax():
    """(B, L, H, D) triples; on the CPU both packages concatenate the
    streams and run their plain attention."""
    b, h, d, lc, lx = 2, 3, 16, 30, 100
    ctx = [_rand((b, lc, h, d), 50 + i, 0.7) for i in range(3)]
    x = [_rand((b, lx, h, d), 60 + i, 0.7) for i in range(3)]
    want_c, want_x = jattn.joint_attention_blhd(
        tuple(map(jnp.asarray, ctx)), tuple(map(jnp.asarray, x)))
    n = tfa.flash_attention_pos_cuda.launches
    got_c, got_x = tattn.joint_attention_blhd(
        tuple(map(torch.from_numpy, ctx)), tuple(map(torch.from_numpy, x)))
    assert tfa.flash_attention_pos_cuda.launches == n
    assert got_c.shape == (b, lc, h, d) and got_x.shape == (b, lx, h, d)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL,
                               rtol=RTOL)


def test_multi_head_attention_passes_scale_with_a_bias():
    """T5's call: unscaled logits and a (1, H, L, L) bias over 77 tokens."""
    q, k, v = (_rand((2, 77, 64), s, 0.3) for s in (70, 71, 72))
    bias = _rand((1, 4, 77, 77), 73)
    want = jattn.multi_head_attention(*map(jnp.asarray, (q, k, v)), 4,
                                      bias=jnp.asarray(bias), scale=1.0)
    got = tattn.multi_head_attention(*map(torch.from_numpy, (q, k, v)), 4,
                                     bias=torch.from_numpy(bias), scale=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# ------------------------------------------------- norms, tables, sampler
@pytest.mark.parametrize("with_scale", [True, False])
def test_rms_norm_matches_jax(with_scale):
    x = _rand((2, 7, 4, 64), 7, 3.0)
    s = 1.0 + _rand((64,), 8, 0.3) if with_scale else None
    want = jgn.rms_norm(jnp.asarray(x), None if s is None else jnp.asarray(s))
    got = tgn.rms_norm(torch.from_numpy(x),
                       None if s is None else torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tgn.rms_norm(xb).dtype == torch.bfloat16


def test_layer_norm_without_affine_matches_jax():
    x = _rand((2, 9, 48), 9, 3.0)
    want = jgn.layer_norm(jnp.asarray(x), None, None, eps=1e-6)
    got = tgn.layer_norm(torch.from_numpy(x), None, None, eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("grid,h,w", [(16, 4, 4), (16, 6, 10), (9, 9, 9),
                                      (192, 64, 64)])
def test_crop_pos_embed_matches_jax(grid, h, w):
    pos = _rand((1, grid * grid, 8), 11)
    want = jemb.crop_pos_embed(jnp.asarray(pos), grid, h, w)
    got = temb.crop_pos_embed(torch.from_numpy(pos), grid, h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pos_embed_2d_sincos_matches_jax():
    np.testing.assert_array_equal(temb.pos_embed_2d_sincos(32, 5, 7, 2.0),
                                  jemb.pos_embed_2d_sincos(32, 5, 7, 2.0))
    with pytest.raises(ValueError):
        temb.pos_embed_2d_sincos(30, 4, 4)


@pytest.mark.parametrize("steps,shift", [(50, 3.0), (28, 1.0), (4, 3.0)])
def test_sd3_sigma_schedule_matches_jax(steps, shift):
    np.testing.assert_array_equal(tsched.sd3_sigma_schedule(steps, shift),
                                  jsched.sd3_sigma_schedule(steps, shift))
    np.testing.assert_array_equal(
        tsched.flow_timestep(tsched.flow_sigma(np.arange(5.0), shift)),
        jsched.flow_timestep(jsched.flow_sigma(np.arange(5.0), shift)))


def test_t5_relative_position_bucket_matches_jax():
    rel = np.arange(-300, 301, dtype=np.int32)
    rel = rel[None, :] - np.arange(0, 40, dtype=np.int32)[:, None]
    for buckets, dist in ((32, 128), (16, 64)):
        want = jte.t5_relative_position_bucket(jnp.asarray(rel), buckets,
                                               dist)
        got = tte.t5_relative_position_bucket(torch.from_numpy(rel), buckets,
                                              dist)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_assemble_sd3_cond_matches_jax():
    parts = (_rand((2, 77, 768), 1), _rand((2, 768), 2),
             _rand((2, 77, 1280), 3), _rand((2, 1280), 4),
             _rand((2, 77, 4096), 5))
    want_c, want_p = jte.assemble_sd3_cond(*map(jnp.asarray, parts))
    got_c, got_p = tte.assemble_sd3_cond(*map(torch.from_numpy, parts))
    assert got_c.shape == (2, 154, 4096) and got_p.shape == (2, 2048)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("sampler", ["euler", "heun"])
@pytest.mark.parametrize("keep", [False, True])
def test_flow_samplers_match_jax(sampler, keep):
    """The host loop against the JAX scan over a linear denoiser."""
    x0 = _rand((2, 4, 4, 3), 21)
    jfn = getattr(jflow, f"flow_{sampler}_sample")
    tfn = getattr(tflow, f"flow_{sampler}_sample")
    want = jfn(lambda x, s: 0.3 * x + 0.1 * s, jnp.asarray(x0), steps=7,
               shift=3.0, keep_trajectory=keep)
    got = tfn(lambda x, s: 0.3 * x + 0.1 * s, torch.from_numpy(x0), steps=7,
              shift=3.0, keep_trajectory=keep)
    if not keep:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(
        tflow.noise_scaling(0.3, torch.ones(2), torch.zeros(2)).numpy(),
        np.asarray(jflow.noise_scaling(0.3, jnp.ones(2), jnp.zeros(2))))
