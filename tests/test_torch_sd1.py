"""The SD1 text→image slice, JAX package against the PyTorch port, on the CPU.

The JAX ``SD1Generator`` runs the reduced bundle of
``tests/test_sd1.py::_FakeModels`` (1-layer CLIP, 32-channel UNet, full VAE
decoder; 64x64, 3 k-LMS steps, CFG, batch 1), in fp32. The port gets the
same parameters through ``SD1Models.from_jax`` and the same initial-latent
noise (drawn here from the key the JAX generator draws it from), since
seeds cannot match across frameworks. The uint8 images must agree to ±1;
the final latents before decode to rtol 1e-4 / atol 1e-4.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import sd1 as jsd1
from from_ddpm_to_stable_diffusion_tpu.pipelines import sd1 as jpipe
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd1 as tpipe
from tests.test_torch_models import jax_random_params

H = W = 64
STEPS = 3


class _Tokenizer:
    """Stand-in with the duck-typed ``encode_batch`` both pipelines call."""

    def encode_batch(self, texts):
        ids = np.zeros((len(texts), 77), np.int32)
        for i, text in enumerate(texts):
            codes = [ord(ch) % 63 + 1 for ch in text][:77]
            ids[i, :len(codes)] = codes
        return ids


@pytest.fixture(scope="module")
def jax_bundle():
    clip = jsd1.CLIPText(vocab_size=64, num_layers=1, num_heads=4,
                         embed_dim=768)
    unet = jsd1.SD1UNet(model_channels=32, num_heads=4)
    decoder = jsd1.VAEDecoder()
    params = {
        "clip": jax_random_params(clip, jnp.zeros((1, 77), jnp.int32),
                                  seed=1),
        "unet": jax_random_params(unet, jnp.zeros((1, 8, 8, 4)),
                                  jnp.zeros((1, 77, 768)),
                                  jnp.zeros((1, 320)), seed=2),
        "decoder": jax_random_params(decoder, jnp.zeros((1, 8, 8, 4)),
                                     seed=3),
    }
    return types.SimpleNamespace(clip=clip, unet=unet, decoder=decoder,
                                 encoder=None, params=params)


def _jax_noise(seed, shape):
    """The initial-latent draw of the JAX SD1Generator and generate()."""
    _, noise_key, _, _ = jax.random.split(jax.random.key(seed), 4)
    return np.asarray(jax.random.normal(noise_key, shape))


def test_sd1_txt2img_slice_matches_jax(jax_bundle):
    seed, prompts = 7, ["a cat"]
    want_img = jpipe.SD1Generator(jax_bundle, sampler="k_lms",
                                  n_inference_steps=STEPS, height=H,
                                  width=W)(prompts, seed=seed)
    want_lat = jpipe.generate(prompts, jax_bundle, height=H, width=W,
                              n_inference_steps=STEPS, seed=seed,
                              return_latents=True)

    models = tpipe.SD1Models.from_jax(jax_bundle.params, device="cpu",
                                      clip_heads=4,
                                      unet_heads=4)
    gen = tpipe.SD1Generator(models, sampler="k_lms", n_inference_steps=STEPS,
                             height=H, width=W)
    noise = _jax_noise(seed, (1, H // 8, W // 8, 4))
    got_img = gen(prompts, noise=noise)
    assert got_img.shape == want_img.shape == (1, H, W, 3)
    assert got_img.dtype == np.uint8
    np.testing.assert_allclose(got_img.astype(np.int16),
                               want_img.astype(np.int16), atol=1)
    assert want_img.std() > 0

    with torch.inference_mode():
        context = gen._encode_text(prompts, None)
        latents = gen._sample(torch.tensor(noise)
                              * gen.tables["initial_scale"], context)
    np.testing.assert_allclose(latents.numpy(), np.asarray(want_lat),
                               rtol=1e-4, atol=1e-4)


def test_text_conditioning_matches_jax(jax_bundle):
    """A tokenizer's ids for [prompts | uncond prompts] through CLIP."""
    prompts, uncond = ["a cat", "two dogs"], ["", "blurry"]
    tok = _Tokenizer()
    want = jax.jit(jax_bundle.clip.apply)(
        {"params": jax_bundle.params["clip"]},
        jnp.asarray(tok.encode_batch(prompts + uncond)))
    models = tpipe.SD1Models.from_jax(jax_bundle.params, device="cpu",
                                      clip_heads=4,
                                      unet_heads=4)
    gen = tpipe.SD1Generator(models, tokenizer=tok, height=H, width=W)
    with torch.inference_mode():
        got = gen._encode_text(prompts, uncond)
    assert got.shape == (4, 77, 768)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_entry_points_default_to_the_card():
    """The port's entry points run on the card unless the caller asks for
    the CPU, as these tests do."""
    import inspect

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import (
        ddpm_trainer, mmdit_trainer, sd3, vlm_trainer)

    for fn in (tpipe.SD1Models.from_jax, sd3.SD3Models.from_jax,
               tpipe.SD1Models.from_checkpoint_dir,
               sd3.SD3Models.from_checkpoints,
               sd3.SD3Models.initialize, ddpm_trainer.DDPMTrainer.__init__,
               mmdit_trainer.MMDiTTrainer.__init__,
               vlm_trainer.VLMTrainer.__init__):
        default = inspect.signature(fn).parameters["device"].default
        assert str(default) == "cuda", (fn.__qualname__, default)
    # generate() and SD1Generator run where the bundle lies (from_jax puts
    # it on the card by default): they take no device of their own, and
    # their arguments are the JAX ones, plus the test hooks
    for fn, jax_fn, dropped in (
            (tpipe.generate, jpipe.generate, {"loop"}),
            (tpipe.SD1Generator.__init__, jpipe.SD1Generator.__init__,
             {"mesh"}),
            (tpipe.SD1Generator.__call__, jpipe.SD1Generator.__call__,
             set())):
        names = list(inspect.signature(fn).parameters)
        want = [n for n in inspect.signature(jax_fn).parameters
                if n not in dropped]
        assert "device" not in names
        hooks = {"noise", "enc_noise", "step_noise"}
        assert [n for n in names if n not in hooks] == want, fn.__qualname__
    # SD3 serving, int8, the tiled decode and the VAE encode run where the
    # bundle (or the module) lies, and take the JAX arguments plus the test
    # hooks; the JAX ``vae_encode(images, rng)`` takes its noise or a
    # generator instead of a key, ``tiled_decode`` the decoder module
    # instead of its tree and configuration
    from from_ddpm_to_stable_diffusion_tpu.models import (
        sd3_vae_tiled as jtiled)
    from from_ddpm_to_stable_diffusion_tpu.pipelines import sd3 as jsd3
    from from_ddpm_to_stable_diffusion_tpu_torch.models import (
        sd3_vae_tiled as ttiled)
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import quantize

    for fn, jax_fn in (
            (sd3.SD3Inferencer.gen_image, jsd3.SD3Inferencer.gen_image),
            (sd3.SD3Inferencer.denoise, jsd3.SD3Inferencer.denoise),
            (sd3.SD3Inferencer.get_cond, jsd3.SD3Inferencer.get_cond),
            (sd3.SD3Inferencer.vae_decode, jsd3.SD3Inferencer.vae_decode),
            (sd3.SD3Inferencer.gen_image_text,
             jsd3.SD3Inferencer.gen_image_text),
            (sd3.SD3Inferencer.gen_images_text,
             jsd3.SD3Inferencer.gen_images_text),
            (sd3.SD3Inferencer.__init__, jsd3.SD3Inferencer.__init__),
            (sd3.SD3Models.quantize_int8, jsd3.SD3Models.quantize_int8),
            (tpipe.SD1Models.quantize_int8, jpipe.SD1Models.quantize_int8),
            (sd3.SD3Models.free, jsd3.SD3Models.free)):
        names = list(inspect.signature(fn).parameters)
        assert "device" not in names
        hooks = {"noise", "enc_noise"}
        assert ([n for n in names if n not in hooks]
                == list(inspect.signature(jax_fn).parameters)), fn.__qualname__
    for fn in (sd3.SD3Inferencer.vae_encode, ttiled.tiled_decode,
               quantize.quantize_module, quantize.int8_dot):
        assert "device" not in inspect.signature(fn).parameters
    assert (list(inspect.signature(ttiled.tiled_decode).parameters)[-2:]
            == list(inspect.signature(jtiled.tiled_decode).parameters)[-2:]
            == ["strip", "image_batch"])
    assert "int8" in inspect.signature(sd3.SD3Models.initialize).parameters


def test_sd1_generator_contract(jax_bundle):
    models = tpipe.SD1Models.from_jax(jax_bundle.params, device="cpu",
                                      clip_heads=4,
                                      unet_heads=4)
    gen = tpipe.SD1Generator(models, n_inference_steps=1, height=H, width=W)
    a, b = gen(["a"], seed=3), gen(["a"], seed=3)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - gen(["a"], seed=4).astype(int)).max() > 0
    with pytest.raises(ValueError):
        gen(["a"], noise=np.zeros((2, 8, 8, 4), np.float32))
    with pytest.raises(ValueError):
        gen(["a"], uncond_prompts=["x", "y"])
    with pytest.raises(ValueError):
        tpipe.SD1Generator(models, height=100)
    tpipe.SD1Generator(models, sampler="k_euler")      # ported since
    with pytest.raises(ValueError, match="unknown sampler value 'k_heun'"):
        tpipe.SD1Generator(models, sampler="k_heun")
    with pytest.raises(NotImplementedError, match="queue A2"):
        tpipe.SD1Generator(models, loop="trajectory")
