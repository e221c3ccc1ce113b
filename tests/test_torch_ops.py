"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both frameworks; the JAX side
runs its Pallas kernels in interpret mode (or its XLA reference), the port
its plain PyTorch versions (its CUDA kernels take CUDA tensors only).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.ops import attention as jattn
from from_ddpm_to_stable_diffusion_tpu.ops import embeddings as jemb
from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from from_ddpm_to_stable_diffusion_tpu.ops import groupnorm as jgn
from from_ddpm_to_stable_diffusion_tpu.ops import image as jimage
from from_ddpm_to_stable_diffusion_tpu.ops import schedules as jsched
from from_ddpm_to_stable_diffusion_tpu.ops.groupnorm_pallas import (
    group_norm_pallas)
from from_ddpm_to_stable_diffusion_tpu.samplers import k_samplers as jks
from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as tattn
from from_ddpm_to_stable_diffusion_tpu_torch.ops import embeddings as temb
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as tgn
from from_ddpm_to_stable_diffusion_tpu_torch.ops import image as timage
from from_ddpm_to_stable_diffusion_tpu_torch.ops import schedules as tsched
from from_ddpm_to_stable_diffusion_tpu_torch.samplers import k_samplers as tks
from test_torch_gn_plan import check_group_norm_plan
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

GOLD = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                            "goldens.npz"))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- schedules
def test_schedules_match_goldens_and_jax():
    sig, ts = tsched.karras_sigma_schedule(12, 1000)
    np.testing.assert_allclose(np.asarray(sig, np.float32),
                               GOLD["karras_sigmas"], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ts, np.float32),
                               GOLD["karras_timesteps"], rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(tsched.lms_coefficients(sig, 4), np.float32),
        GOLD["lms_coeffs"], rtol=1e-5, atol=1e-8)
    for steps in (3, 50):
        jsig, jts = jsched.karras_sigma_schedule(steps, 1000)
        tsig, tts = tsched.karras_sigma_schedule(steps, 1000)
        np.testing.assert_array_equal(tsig, jsig)
        np.testing.assert_array_equal(tts, jts)
        np.testing.assert_array_equal(tsched.input_scale(tsig),
                                      jsched.input_scale(jsig))
        for start in (0, 2):
            np.testing.assert_array_equal(
                tsched.lms_coefficients(tsig, 4, start_step=start),
                jsched.lms_coefficients(jsig, 4, start_step=start))
    np.testing.assert_array_equal(tsched.get_alphas_cumprod(),
                                  jsched.get_alphas_cumprod())


@pytest.mark.parametrize("steps", [3, 50])
def test_sigma_tables_match_jax(steps):
    cfg_t = tks.KSamplerConfig(n_inference_steps=steps)
    cfg_j = jks.KSamplerConfig(n_inference_steps=steps)
    want, got = jks.sigma_tables(cfg_j), tks.sigma_tables(cfg_t)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_k_lms_trajectory_matches_golden():
    """The port's k-LMS body over the goldens' linear denoiser."""
    cfg = tks.KSamplerConfig(method="k_lms", n_inference_steps=12)
    body, make_carry, extract = tks.make_sampler_body(
        lambda x, t: 0.1 * x + 0.01 * t.to(x.dtype), cfg)
    carry = make_carry(torch.from_numpy(GOLD["sampler_x0"].copy()))
    for t in range(12):
        carry = body(carry, t)
    np.testing.assert_allclose(extract(carry).numpy(), GOLD["sampler_k_lms"],
                               rtol=2e-5, atol=1e-6)


def test_unported_samplers_raise():
    """No sampler of the JAX module is unported any more: the three that
    used to raise build, the ancestral one only with a source of noise, and
    an unknown name still raises."""
    for method in ("k_euler", "dpmpp_2m"):
        tks.make_sampler_body(lambda x, t: x,
                              tks.KSamplerConfig(method=method))
    ancestral = tks.KSamplerConfig(method="k_euler_ancestral")
    tks.make_sampler_body(lambda x, t: x, ancestral,
                          generator=torch.Generator())
    with pytest.raises(ValueError, match="generator or step_noise"):
        tks.make_sampler_body(lambda x, t: x, ancestral)
    with pytest.raises(ValueError):
        tks.make_sampler_body(lambda x, t: x, tks.KSamplerConfig(method="x"))


# ------------------------------------------------------- embeddings, image
def test_time_embedding_matches_jax():
    t = np.asarray([999.0, 500.5, 20.0, 0.0], np.float32)
    want = np.asarray(jemb.sd1_time_embedding(jnp.asarray(t)))
    got = temb.sd1_time_embedding(torch.from_numpy(t)).numpy()
    assert got.shape == (4, 320)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(temb.sd1_time_embedding(999.0).numpy(),
                               want[:1], atol=1e-5)


def test_image_ops_match_jax():
    x = _rand((2, 5, 3, 4), 0, scale=0.8)
    jx, tx = _both(x)
    np.testing.assert_array_equal(timage.upsample_nearest_2x(tx).numpy(),
                                  np.asarray(jimage.upsample_nearest_2x(jx)))
    np.testing.assert_array_equal(timage.to_uint8(tx).numpy(),
                                  np.asarray(jimage.to_uint8(jx)))
    np.testing.assert_allclose(
        timage.rescale(tx, (-1, 1), (0, 255), clamp=True).numpy(),
        np.asarray(jimage.rescale(jx, (-1, 1), (0, 255), clamp=True)),
        rtol=1e-6)


# ----------------------------------------------------------------- norms
GN_CASES = [((2, 6, 5, 64), 8), ((2, 6, 5, 320), 32)]


@pytest.mark.parametrize("shape,groups", GN_CASES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_fp32_matches_jax(shape, groups, act):
    x = _rand(shape, 1, scale=2.0, shift=0.5)
    s, b = _rand(shape[-1:], 2, 0.3, 1.0), _rand(shape[-1:], 3, 0.2)
    (jx, tx), (js, ts), (jb, tb) = _both(x), _both(s), _both(b)
    got = tgn.group_norm(tx, groups, ts, tb, 1e-5, act).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jgn._group_norm_xla(jx, groups, js, jb, 1e-5, act)),
        atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(group_norm_pallas(jx, groups, js, jb, 1e-5, act,
                                          interpret=True)), atol=2e-5)
    np.testing.assert_allclose(
        tgn.group_norm_plain_one_pass(tx, groups, ts, tb, 1e-5, act).numpy(),
        np.asarray(jgn._group_norm_xla_lane_aligned(jx, groups, js, jb, 1e-5,
                                                    act)), atol=2e-5)


@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_bf16_matches_jax(shape, groups):
    """bf16 input takes the one-pass formula on both sides; outputs agree
    to two bf16 ulps at |y| < 4."""
    x = _rand(shape, 4, scale=2.0, shift=0.5)
    s, b = _rand(shape[-1:], 5, 0.3, 1.0), _rand(shape[-1:], 6, 0.2)
    want = jgn.group_norm(jnp.asarray(x, jnp.bfloat16), groups,
                          jnp.asarray(s), jnp.asarray(b), 1e-5, "silu")
    got = tgn.group_norm(torch.from_numpy(x).to(torch.bfloat16), groups,
                         torch.from_numpy(s), torch.from_numpy(b), 1e-5,
                         "silu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1.6e-2, rtol=1.6e-2)


def test_layer_norm_matches_jax():
    x = _rand((2, 7, 48), 7, scale=3.0, shift=1.0)
    s, b = _rand((48,), 8, 0.3, 1.0), _rand((48,), 9, 0.2)
    want = jgn.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = tgn.layer_norm(*(torch.from_numpy(a) for a in (x, s, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4096, 320), (8, 4096, 320),
                                   (2, 1024, 640), (2, 64, 1280),
                                   (2, 256, 2560), (2, 1024, 1920),
                                   (2, 4096, 960), (1, 262144, 128),
                                   (4, 65536, 256), (1, 4096, 512)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_group_norm_launch_config_covers_rows(shape, itemsize):
    """Every row is visited once by the kernel's walk over its launch plan
    (``group_norm_plan``), and the plan fits one block per SM."""
    b, hw, c = shape
    plan = tgn.group_norm_plan(b, hw, c, 32, itemsize)
    check_group_norm_plan(plan, b, hw, c, 32, itemsize)


# ------------------------------------------------------------- attention
def _fa_inputs(b, h, lq, lk, d, seed):
    return (_rand((b, h, lq, d), seed, 0.7), _rand((b, h, lk, d), seed + 1,
                                                    0.7),
            _rand((b, h, lk, d), seed + 2))


@pytest.mark.parametrize("b,h,lq,lk,d,block", [
    (1, 2, 256, 256, 80, 128),      # SD1 32^2 head dim, blocked kernel
    (1, 1, 256, 256, 512, 512),     # VAE mid attention head dim
])
def test_flash_plain_matches_jax_blocked_kernel(b, h, lq, lk, d, block):
    q, k, v = _fa_inputs(b, h, lq, lk, d, 10)
    want_out, want_lse = jfa._flash_fwd(
        *map(jnp.asarray, (q, k, v)), None, None, False, d ** -0.5, block,
        block, interpret=True)
    got_out, got_lse = tfa.flash_attention_forward(
        *map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=2e-5, rtol=1e-4)
    jout = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), block_q=block,
                               block_k=block, interpret=True)
    np.testing.assert_allclose(
        tfa.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(jout), atol=2e-5, rtol=1e-4)


def test_flash_plain_matches_jax_wide_kernel(monkeypatch):
    """The single-pass whole-K/V route, shrunk to interpret-mode size the
    way tests/test_flash_attention.py does."""
    monkeypatch.setattr(jfa, "_WIDE_MIN_LQ", 512)
    b, h, lq, lk, d = 1, 2, 512, 512, 40
    assert jfa._wide_eligible(lq, lk, d, jnp.float32, False, False, False)
    q, k, v = _fa_inputs(b, h, lq, lk, d, 20)
    want_out, want_lse = jfa._flash_fwd_wide(
        *map(jnp.asarray, (q, k, v)), d ** -0.5, interpret=True)
    got_out, got_lse = tfa.flash_attention_forward(
        *map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal,with_bias", [(False, False), (True, False),
                                              (False, True)])
def test_plain_attention_matches_xla(causal, with_bias):
    q, k, v = _fa_inputs(2, 3, 77, 77, 16, 30)
    bias = _rand((1, 3, 77, 77), 33) if with_bias else None
    want = jattn._xla_attention(*map(jnp.asarray, (q, k, v)),
                                None if bias is None else jnp.asarray(bias),
                                causal, 16 ** -0.5)
    got = tattn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)),
        bias=None if bias is None else torch.from_numpy(bias), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_multi_head_attention_matches_jax():
    q, k, v = (_rand((2, 600, 64), s, 0.7) for s in (40, 41, 42))
    want = jattn.multi_head_attention(*map(jnp.asarray, (q, k, v)), 4)
    got = tattn.multi_head_attention(*map(torch.from_numpy, (q, k, v)), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_kernel_wrappers_take_only_cuda_tensors():
    """On the CPU the wrappers never launch: the public entries run the
    plain versions, the kernel entries refuse, the counters stay put."""
    q, k, v = map(torch.from_numpy, _fa_inputs(1, 1, 600, 600, 40, 50))
    x = torch.from_numpy(_rand((1, 4, 4, 64), 51))
    ones, zeros = torch.ones(64), torch.zeros(64)
    n1, n2 = tfa.flash_attention_cuda.launches, tgn.group_norm_cuda.launches
    tattn.dot_product_attention(q, k, v)
    tgn.group_norm(x, 32, ones, zeros)
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(q.to(torch.bfloat16), k.to(torch.bfloat16),
                                 v.to(torch.bfloat16))
    with pytest.raises(ValueError):
        tgn.group_norm_cuda(x, 32, ones, zeros)
    causal = tfa.flash_attention(q, k, v, causal=True)   # the plain version
    torch.testing.assert_close(causal, tattn.plain_attention(
        q, k, v, causal=True), atol=2e-5, rtol=1e-5)
    assert (tfa.flash_attention_cuda.launches,
            tgn.group_norm_cuda.launches) == (n1, n2)


def test_port_never_imports_jax():
    port = "from_ddpm_to_stable_diffusion_tpu_torch"
    modules = ["pipelines.sd1", "pipelines.ddpm_trainer", "pipelines.sd3",
               "pipelines.mmdit_trainer", "utils.dtypes", "io.from_jax", "io.data", "models.tiny_unet", "models.mmdit",
               "models.text_encoders", "models.sd3_vae", "samplers.ddpm",
               "samplers.flow", "utils.config", "pipelines.vlm_trainer",
               "models.siglip", "models.tiny_vlm", "io.shapes_dataset",
               "ops.attention", "ops.flash_attention", "io.tokenizer",
               "io.prompt_weights", "samplers.k_samplers", "models.sd1",
               "io.weights", "io.weights_sd3", "io.weights_clip",
               "ops.quantize", "models.sd3_vae_tiled", "io.spm_tokenizer",
               "ops.image", "serving", "serving.batcher", "serving.server",
               "cli", "cli.serve", "cli.sd1", "cli.sd3", "cli.tiny_sd",
               "cli.multimodal", "__main__", "models.tiny_video_unet",
               "models.vae", "models.vit", "pipelines.vae_trainer",
               "pipelines.vit_trainer", "cli.video", "cli.vae", "cli.vit",
               "models.clip", "models.inception", "io.weights_inception",
               "utils.metrics", "pipelines.clip_trainer", "cli.checks",
               "cli.demos", "parallel", "parallel.mesh",
               "parallel.ring_attention", "parallel.expert",
               "parallel.pipeline", "io.native"]
    # Pillow and matplotlib are not promised on the card's machine: only the
    # calls that read an image or draw a plot import them
    code = ("import sys\n"
            + "".join(f"import {port}.{m}\n" for m in modules) +
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'regex', 'yaml',\n"
            "              'safetensors', 'PIL', 'matplotlib'))\n"
            "assert not bad, bad\n"
            "assert 'from_ddpm_to_stable_diffusion_tpu' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
