"""The SD1 generator of the port, whole, against the JAX package on the CPU:
``SD1Generator`` / ``generate`` end to end (txt2img and img2img, four
samplers, CFG on and off, prompt weighting through the tokenizer,
``return_latents``, ``per_sample_seeds``, the validation messages). Its parts
(samplers, VAE encoder, tokenizer, prompt weights) are held one by one in
``tests/test_torch_sd1_parts.py``.

One parameter tree, drawn with numpy, goes to both packages
(``SD1Models.from_jax``); the JAX package's own random draws (its key
splits and ``fold_in`` per ancestral step) are fed to the port through
``noise=``, ``enc_noise=`` and ``step_noise=``. Sizes are small: a UNet of
width 32, one CLIP layer, 64x64 images, 4 steps.

Tolerances: final latents 1e-3 (fp32, four UNet calls deep); uint8 images
within 1 level.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.io import tokenizer as jtok
from from_ddpm_to_stable_diffusion_tpu.models import sd1 as jsd1
from from_ddpm_to_stable_diffusion_tpu.ops.image import to_uint8 as j_to_uint8
from from_ddpm_to_stable_diffusion_tpu.pipelines import sd1 as jpipe
from from_ddpm_to_stable_diffusion_tpu_torch.io import tokenizer as ttok
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd1 as tsd1
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd1 as tpipe
from tests.test_torch_models import jax_random_params

H = W = 64
STEPS = 4
LATENT = (H // 8, W // 8, 4)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ------------------------------------------------------------ the whole slice
WORDS = ["a", "cat", "dog", "photo", "of", "the", "blurry", "red"]


@pytest.fixture(scope="module")
def bundle():
    vocab, merges = jtok.build_simple_vocab(WORDS)
    clip = jsd1.CLIPText(vocab_size=len(vocab), num_layers=1, num_heads=4,
                         embed_dim=768)
    unet = jsd1.SD1UNet(model_channels=32, num_heads=4)
    decoder, encoder = jsd1.VAEDecoder(), jsd1.VAEEncoder()
    params = {
        "clip": jax_random_params(clip, jnp.zeros((1, 77), jnp.int32),
                                  seed=1),
        "unet": jax_random_params(unet, jnp.zeros((1, 8, 8, 4)),
                                  jnp.zeros((1, 77, 768)),
                                  jnp.zeros((1, 320)), seed=2),
        "decoder": jax_random_params(decoder, jnp.zeros((1, 8, 8, 4)),
                                     seed=3),
        "encoder": jax_random_params(encoder, jnp.zeros((1, 64, 64, 3)),
                                     jnp.zeros((1, 8, 8, 4)), seed=4),
    }
    jax_models = types.SimpleNamespace(clip=clip, unet=unet, decoder=decoder,
                                       encoder=encoder, params=params)
    models = tpipe.SD1Models.from_jax(params, device="cpu", clip_heads=4,
                                      unet_heads=4)
    assert isinstance(models.encoder, tsd1.VAEEncoder)
    return types.SimpleNamespace(
        jax=jax_models, torch=models,
        jax_tok=jtok.CLIPTokenizer(vocab, merges),
        tok=ttok.CLIPTokenizer(*ttok.build_simple_vocab(WORDS)))


def _jax_draws(seed, b):
    """The draws of the JAX ``generate`` / ``SD1Generator`` for ``seed``:
    the initial noise, the encoder's noise and the ancestral step noise."""
    _, noise_key, enc_key, anc_key = jax.random.split(jax.random.key(seed), 4)
    shape = (b, *LATENT)
    return dict(
        noise=np.asarray(jax.random.normal(noise_key, shape)),
        enc_noise=np.asarray(jax.random.normal(enc_key, shape)),
        step_noise=lambda t: np.asarray(jax.random.normal(
            jax.random.fold_in(anc_key, t), shape)))


def _images(seed, b):
    return [np.random.default_rng(seed + i).integers(
        0, 256, (H, W, 3), dtype=np.uint8) for i in range(b)]


# name: keyword arguments of generate() shared by both packages. Between
# them: the four samplers, txt2img and img2img at strength 0.5 and 1.0, CFG
# on and off, zero tokens and tokenized prompts, prompt weighting.
SLICE_CASES = {
    "k_lms": dict(sampler="k_lms"),
    "k_euler_weighted_no_cfg": dict(sampler="k_euler", do_cfg=False,
                                    prompt_weighting=True, tokenizer=True),
    "dpmpp_2m_img2img_full": dict(sampler="dpmpp_2m", strength=1.0,
                                  images=True, tokenizer=True,
                                  cfg_scale=5.0),
    "ancestral_img2img_half": dict(sampler="k_euler_ancestral", strength=0.5,
                                   images=True),
}


@pytest.mark.parametrize("name", SLICE_CASES)
def test_generate_matches_jax(bundle, name):
    """``generate(return_latents=True)`` of both packages from one tree and
    one set of draws, then both decoders: latents to 1e-3, images within one
    level."""
    kw = dict(SLICE_CASES[name])
    seed, prompts = 11, ["a (red:1.4) cat", "the [blurry] dog"]
    uncond = ["", "blurry photo"]
    with_tok = kw.pop("tokenizer", False)
    images = _images(40, 2) if kw.pop("images", False) else None
    kw.update(height=H, width=W, n_inference_steps=STEPS, seed=seed,
              uncond_prompts=uncond, input_images=images)
    want_lat = jpipe.generate(
        prompts, bundle.jax, tokenizer=bundle.jax_tok if with_tok else None,
        return_latents=True, **kw)
    want_img = np.asarray(j_to_uint8(jax.jit(bundle.jax.decoder.apply)(
        {"params": bundle.jax.params["decoder"]}, want_lat)))

    draws = _jax_draws(seed, 2)
    got_lat = tpipe.generate(
        prompts, bundle.torch, tokenizer=bundle.tok if with_tok else None,
        return_latents=True, **kw, **draws)
    assert got_lat.shape == (2, *LATENT) and got_lat.dtype == torch.float32
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat),
                               atol=1e-3, rtol=1e-3)
    got_img = tpipe.generate(
        prompts, bundle.torch, tokenizer=bundle.tok if with_tok else None,
        **kw, **draws)
    assert got_img.shape == (2, H, W, 3) and got_img.dtype == np.uint8
    assert np.abs(got_img.astype(np.int16)
                  - want_img.astype(np.int16)).max() <= 1
    assert want_img.std() > 0


@pytest.mark.parametrize("mode", ["txt2img", "img2img"])
def test_sd1_generator_matches_jax(bundle, mode):
    """The generator objects of both packages, with a tokenizer and CFG:
    txt2img, and img2img at strength 0.5, where the LMS table is rebuilt from
    ``start_step`` = 2."""
    seed, prompts = 5, ["photo of a cat"]
    kw = dict(sampler="k_lms", n_inference_steps=STEPS, height=H, width=W)
    call = dict(seed=seed)
    if mode == "img2img":
        call.update(input_images=_images(50, 1), strength=0.5)
    want = jpipe.SD1Generator(bundle.jax, tokenizer=bundle.jax_tok, **kw)(
        prompts, **call)
    gen = tpipe.SD1Generator(bundle.torch, tokenizer=bundle.tok, **kw)
    got = gen(prompts, **call, **_jax_draws(seed, 1))
    assert got.shape == want.shape == (1, H, W, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    # the port's own draws: reproducible per seed, and they do matter
    a, b = gen(prompts, **call), gen(prompts, **call)
    np.testing.assert_array_equal(a, b)
    call["seed"] = seed + 1
    assert np.abs(a.astype(int) - gen(prompts, **call).astype(int)).max() > 0


def test_per_sample_seeds_do_not_depend_on_the_batch(bundle):
    gen = tpipe.SD1Generator(bundle.torch, sampler="k_euler",
                             n_inference_steps=2, height=H, width=W)
    alone = gen.initial_noise(1, per_sample_seeds=[123])
    batch = gen.initial_noise(4, per_sample_seeds=[5, None, 123, 7])
    assert alone.shape == (1, *LATENT) and batch.shape == (4, *LATENT)
    assert torch.equal(alone[0], batch[2])                # bit for bit
    assert not torch.equal(batch[0], batch[2])
    # None entries: base * 100003 + 17 * i + 1, as the JAX generator fills
    filled = gen.initial_noise(2, seed=3, per_sample_seeds=[None, None])
    assert torch.equal(filled[1], gen.initial_noise(
        1, per_sample_seeds=[3 * 100003 + 17 + 1])[0])
    one = gen(["a"], per_sample_seeds=[123])
    four = gen(["b", "c", "a", "d"], per_sample_seeds=[5, None, 123, 7])
    assert np.abs(one[0].astype(int) - four[2].astype(int)).max() <= 1
    assert np.abs(one[0].astype(int) - four[0].astype(int)).max() > 1


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_validation_messages_are_the_jax_ones(bundle):
    bad_calls = [
        dict(prompts=[]), dict(prompts="a cat"),
        dict(prompts=["a"], uncond_prompts="x"),
        dict(prompts=["a"], uncond_prompts=["x", "y"]),
        dict(prompts=["a"], strength=0.0), dict(prompts=["a"], strength=1.5),
        dict(prompts=["a"], height=100), dict(prompts=["a"], sampler="ddim"),
    ]
    for kw in bad_calls:
        prompts = kw.pop("prompts")
        assert (_message(lambda: tpipe.generate(prompts, bundle.torch, **kw))
                == _message(lambda: jpipe.generate(prompts, bundle.jax,
                                                   **kw))), kw
    for kw in (dict(height=100), dict(sampler="ddim"), dict(loop="x")):
        assert (_message(lambda: tpipe.SD1Generator(bundle.torch, **kw))
                == _message(lambda: jpipe.SD1Generator(bundle.jax, **kw))), kw
    size = dict(height=H, width=W, n_inference_steps=1)
    jgen = jpipe.SD1Generator(bundle.jax, **size)
    tgen = tpipe.SD1Generator(bundle.torch, **size)
    for kw in (dict(per_sample_seeds=[1], input_images=_images(1, 1)),
               dict(per_sample_seeds=[1, 2]),
               dict(input_images=_images(1, 1), strength=2.0)):
        assert (_message(lambda: tgen(["a"], **kw))
                == _message(lambda: jgen(["a"], **kw))), kw
    with pytest.raises(NotImplementedError, match="queue A2"):
        tpipe.SD1Generator(bundle.torch, loop="trajectory")


def test_img2img_without_an_encoder_says_so(bundle):
    params = {k: v for k, v in bundle.jax.params.items() if k != "encoder"}
    models = tpipe.SD1Models.from_jax(params, device="cpu", clip_heads=4,
                                      unet_heads=4)
    assert models.encoder is None
    gen = tpipe.SD1Generator(models, n_inference_steps=1, height=H, width=W)
    assert gen(["a"]).shape == (1, H, W, 3)              # txt2img still runs
    with pytest.raises(ValueError, match="img2img needs the VAE encoder"):
        gen(["a"], input_images=_images(1, 1))
    whole = tpipe.SD1Generator(bundle.torch, n_inference_steps=1, height=H,
                               width=W)
    with pytest.raises(ValueError, match="input_images must be"):
        whole(["a"], input_images=[np.zeros((32, 32, 3), np.uint8)])
    with pytest.raises(ValueError, match="enc_noise must be"):
        whole(["a"], input_images=_images(1, 1),
              enc_noise=np.zeros((1, 4, 4, 4), np.float32))
