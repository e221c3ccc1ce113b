"""The SD3 text→image slice, JAX package against the PyTorch port, on the CPU.

The JAX ``SD3Inferencer`` runs the reduced bundle of ``tests/test_sd3.py``
(depth-2 MMDiT, 2-layer CLIPs at the real widths 768 and 1280, a 1-layer T5
at d_model 4096, the full VAE decoder; 64x64, 4 steps, CFG 5, shift 3) in
fp32. The port gets the same parameters through ``SD3Models.from_jax`` and
the same initial noise (drawn here from the key the JAX inferencer draws it
from), since seeds cannot match across frameworks. Conditioning and final
latents must agree to rtol 1e-4 / atol 1e-4 (summation order), the uint8
images and previews to ±1.
"""

import jax
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import text_encoders as jte
from from_ddpm_to_stable_diffusion_tpu.pipelines import sd3 as jpipe
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.models import (
    text_encoders as tte)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd3 as tpipe
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

H = W = 64
STEPS = 4
CLIP_L = dict(vocab_size=64, hidden_size=768, num_layers=2, num_heads=4)
CLIP_G = dict(vocab_size=64, hidden_size=1280, num_layers=2, num_heads=4,
              hidden_act="gelu")
T5 = dict(vocab_size=64, d_model=4096, d_ff=64, num_layers=1, num_heads=4)
RNG = np.random.default_rng(5)
CLIP_TOKENS = RNG.integers(1, 64, (1, 77)).astype(np.int32)
T5_TOKENS = RNG.integers(1, 64, (1, 77)).astype(np.int32)


@pytest.fixture(scope="module", params=[True, False], ids=["t5", "no_t5"])
def bundles(request):
    """(JAX inferencer, port inferencer) over the same parameters."""
    with_t5 = request.param
    jmodels = jpipe.SD3Models.initialize(
        jax.random.key(0), dtype="fp32", depth=2, pos_embed_max_size=16,
        with_t5=with_t5, clip_l_cfg=jte.CLIPTextConfig(**CLIP_L),
        clip_g_cfg=jte.CLIPTextConfig(**CLIP_G),
        t5_config=jte.T5Config(**T5))
    tmodels = tpipe.SD3Models.from_jax(
        jmodels.params, device="cpu",
        mmdit_config=tmm.MMDiTConfig(depth=2, pos_embed_max_size=16),
        clip_l_cfg=tte.CLIPTextConfig(**CLIP_L),
        clip_g_cfg=tte.CLIPTextConfig(**CLIP_G),
        t5_config=tte.T5Config(**T5))
    assert (tmodels.t5 is not None) == with_t5
    return (jpipe.SD3Inferencer(jmodels, shift=3.0, decode_mode="whole"),
            tpipe.SD3Inferencer(tmodels, shift=3.0))


def _jax_noise(seed, shape):
    """The starting noise of the JAX ``SD3Inferencer.denoise``."""
    return np.asarray(jax.random.normal(jax.random.key(seed), shape))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_conditioning_matches_jax(bundles):
    jinf, tinf = bundles
    for t5_tokens in (T5_TOKENS, None):      # None: the empty T5 prompt
        want_ctx, want_pooled = jinf.get_cond(CLIP_TOKENS, t5_tokens)
        got_ctx, got_pooled = tinf.get_cond(CLIP_TOKENS, t5_tokens)
        assert got_ctx.shape == (1, 154, 4096)
        assert got_pooled.shape == (1, 2048)
        _close(got_ctx, want_ctx)
        _close(got_pooled, want_pooled)
    np.testing.assert_array_equal(tinf.empty_t5_tokens(2, 5),
                                  jinf.empty_t5_tokens(2, 5))
    np.testing.assert_allclose(tinf.get_empty_latent(W, H).numpy(),
                               np.asarray(jinf.get_empty_latent(W, H)))


@pytest.mark.parametrize("sampler", ["euler", "heun"])
def test_sd3_gen_image_slice_matches_jax(bundles, sampler):
    jinf, tinf = bundles
    seed = 7
    kw = dict(t5_tokens=T5_TOKENS, width=W, height=H, steps=STEPS,
              cfg_scale=5.0, sampler=sampler)
    want_img = jinf.gen_image(CLIP_TOKENS, seed=seed, **kw)
    noise = _jax_noise(seed, (1, H // 8, W // 8, 16))
    got_img = tinf.gen_image(CLIP_TOKENS, noise=noise, **kw)
    assert got_img.shape == want_img.shape == (1, H, W, 3)
    assert got_img.dtype == np.uint8 and want_img.std() > 0
    np.testing.assert_allclose(got_img.astype(np.int16),
                               want_img.astype(np.int16), atol=1)

    # the latents before the decode, and every intermediate one
    cond = jinf.get_cond(CLIP_TOKENS, T5_TOKENS)
    neg = jinf.get_cond(np.zeros_like(CLIP_TOKENS), None)
    want_lat, want_traj = jinf.denoise(
        jinf.get_empty_latent(W, H), *cond, *neg, STEPS, 5.0, seed,
        keep_trajectory=True, sampler=sampler)
    tcond = tinf.get_cond(CLIP_TOKENS, T5_TOKENS)
    tneg = tinf.get_cond(np.zeros_like(CLIP_TOKENS), None)
    got_lat, got_traj = tinf.denoise(
        tinf.get_empty_latent(W, H), *tcond, *tneg, STEPS, 5.0,
        keep_trajectory=True, sampler=sampler, noise=noise)
    assert got_traj.shape == (STEPS, 1, H // 8, W // 8, 16)
    _close(got_lat, want_lat)
    _close(got_traj, want_traj)
    _close(got_traj[-1], got_lat)


def test_sd3_batch_previews_and_strength_match_jax(bundles):
    """Batch 2 with distinct CLIP-G tokens, ``keep_trajectory`` previews and
    a partial ``denoise_strength`` (a trimmed schedule)."""
    jinf, tinf = bundles
    seed = 3
    clip = np.concatenate([CLIP_TOKENS, CLIP_TOKENS[:, ::-1]])
    clip_g = clip[:, ::-1].copy()
    t5 = np.concatenate([T5_TOKENS, T5_TOKENS[:, ::-1]])
    kw = dict(t5_tokens=t5, clip_g_tokens=clip_g, width=W, height=H,
              steps=STEPS, denoise_strength=0.5, keep_trajectory=True)
    want_img, want_prev = jinf.gen_image(clip, seed=seed, **kw)
    got_img, got_prev = tinf.gen_image(
        clip, noise=_jax_noise(seed, (2, H // 8, W // 8, 16)), **kw)
    assert got_img.shape == (2, H, W, 3)
    assert got_prev.shape == want_prev.shape == (2 * 2, H // 8, W // 8, 3)
    np.testing.assert_allclose(got_img.astype(np.int16),
                               want_img.astype(np.int16), atol=1)
    np.testing.assert_allclose(got_prev.astype(np.int16),
                               want_prev.astype(np.int16), atol=1)


def test_sd3_inferencer_contract(bundles):
    _, tinf = bundles
    kw = dict(width=W, height=H, steps=1)
    a = tinf.gen_image(CLIP_TOKENS, seed=3, **kw)
    np.testing.assert_array_equal(a, tinf.gen_image(CLIP_TOKENS, seed=3, **kw))
    b = tinf.gen_image(CLIP_TOKENS, seed=4, **kw)
    assert np.abs(a.astype(int) - b.astype(int)).max() > 0
    with pytest.raises(ValueError):
        tinf.gen_image(CLIP_TOKENS, noise=np.zeros((2, 8, 8, 16)), **kw)
    with pytest.raises(ValueError):
        tinf.gen_image(CLIP_TOKENS, denoise_strength=0.0, **kw)
    with pytest.raises(ValueError):
        tinf.gen_image(CLIP_TOKENS, sampler="dpm", **kw)
    img2img = tinf.gen_image(CLIP_TOKENS, init_image=np.zeros((1, H, W, 3)),
                             denoise_strength=0.5, **kw)   # ported since
    assert img2img.shape == (1, H, W, 3)


def test_sd3_models_initialize_small():
    """Flax-default random weights from a generator, module by module."""
    gen = torch.Generator().manual_seed(0)
    models = tpipe.SD3Models.initialize(
        gen, "cpu", "bf16", depth=2, pos_embed_max_size=16, with_t5=False,
        clip_l_cfg=tte.CLIPTextConfig(**CLIP_L),
        clip_g_cfg=tte.CLIPTextConfig(**CLIP_G))
    assert models.t5 is None
    assert models.mmdit.final_linear.weight.dtype == torch.bfloat16
    assert models.vae_decoder.norm_out.weight.dtype == torch.float32
    assert models.clip_l.text_projection.dtype == torch.bfloat16
    img = tpipe.SD3Inferencer(models).gen_image(
        np.zeros((1, 77), np.int32), width=32, height=32, steps=2)
    assert img.shape == (1, 32, 32, 3) and img.dtype == np.uint8
