"""Parity of the port's evaluation slice with the JAX package's, on the CPU
in fp32: the FID InceptionV3 (``InceptionA``, ``InceptionE(pool="max")``,
the whole ``InceptionV3FID`` at batch 2 on 107^2), ``resize_for_fid``
(upsampling from 64^2, the antialiased downsample from 512^2), a synthetic
pytorch-fid checkpoint through both ``import_inception_fid``s, and
``utils/metrics.py``: ``frechet_distance`` / ``fid_from_features`` (also
against scipy's float64 ``sqrtm``), ``kid_from_features``, ``clip_score``,
``clip_fid`` and ``inception_features``.

Tolerances: the Inception blocks and the whole model within 1e-5 / 1e-4 of
the output's largest magnitude (fp32 convolutions summed in another order,
carried through 94 layers); ``resize_for_fid`` 1e-5 absolute (the JAX
bilinear resize antialiases as torch's ``antialias=True`` does); the
imported tensors bit for bit (the same fp32 fold); FID within 1e-4
relative of JAX's (fp32 statistics; the port takes its square roots in
fp64, JAX in fp32) and 2e-3 of scipy's float64 ``sqrtm`` value; with 64
samples of 2048-d features (a rank-deficient covariance) within 1e-3 of
JAX's; KID exactly (the same float64 numpy code); CLIP score and CLIP-FID
within 1e-4 relative; Inception features within 1e-4 of their largest
magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from from_ddpm_to_stable_diffusion_tpu.io import weights_inception as jwi
from from_ddpm_to_stable_diffusion_tpu.models import clip as jclip
from from_ddpm_to_stable_diffusion_tpu.models import inception as jinc
from from_ddpm_to_stable_diffusion_tpu.utils import metrics as jmetrics
from from_ddpm_to_stable_diffusion_tpu_torch.io import (
    weights_inception as twi)
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    jax_params_from_module, load_jax_params, state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import clip as tclip
from from_ddpm_to_stable_diffusion_tpu_torch.models import inception as tinc
from from_ddpm_to_stable_diffusion_tpu_torch.utils import metrics as tmetrics
from test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _uniform(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


# ------------------------------------------------------------- Inception
@pytest.mark.parametrize("block", ["A", "E max"])
def test_inception_blocks_match_jax(block):
    if block == "A":
        jmod, tmod, x = (jinc.InceptionA(32), tinc.InceptionA(32, 32),
                         _rand((2, 19, 19, 32), 1))
    else:
        jmod, tmod, x = (jinc.InceptionE(pool="max"),
                         tinc.InceptionE(64, pool="max"),
                         _rand((2, 8, 8, 64), 2))
    params = jax_random_params(jmod, jnp.asarray(x), seed=3)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = load_jax_params(tmod, params).eval()
    with torch.no_grad():
        _close(tmod(torch.from_numpy(x)), want, 1e-5)


@pytest.fixture(scope="module")
def inception_params():
    return jax_random_params(jinc.InceptionV3FID(),
                             jnp.zeros((1, 107, 107, 3)), seed=4)


def test_inception_v3_fid_matches_jax(inception_params):
    """The whole model at batch 2 on 107^2 in [0, 1], and the tree carried
    back by ``jax_params_from_module`` (BasicConv2d's affine as
    ``scale``)."""
    x = _uniform((2, 107, 107, 3), 5)
    model = jinc.InceptionV3FID()
    want = jax.jit(lambda p, x: model.apply({"params": p}, x))(
        inception_params, jnp.asarray(x))
    tmod = load_jax_params(tinc.InceptionV3FID(), inception_params).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 2048)
    _close(got, want, 1e-4)
    tree = jax_params_from_module(tmod)
    assert set(tree["Mixed_7c"]["branch_pool"]) == {"conv", "scale", "bias"}
    np.testing.assert_array_equal(
        tree["Mixed_5b"]["branch1x1"]["scale"],
        inception_params["Mixed_5b"]["branch1x1"]["scale"])


@pytest.mark.parametrize("size", [64, 512, 300])
def test_resize_for_fid_matches_jax(size):
    """From 64^2 (upsampling), 512^2 (the antialiased downsample, where
    pytorch-fid's ``F.interpolate`` without antialias is ~0.5 off) and
    300^2."""
    x = _uniform((2, size, size, 3), size)
    want = np.asarray(jinc.resize_for_fid(jnp.asarray(x)))
    got = tinc.resize_for_fid(torch.from_numpy(x))
    assert got.shape == (2, 299, 299, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def pytorch_fid_state(seed=6):
    """A pytorch-fid-layout state dict: each BasicConv2d's conv weight and
    BatchNorm (weight, bias, running statistics, num_batches_tracked), plus
    the ``fc`` and ``AuxLogits`` heads the importers drop."""
    shapes = jax.eval_shape(jinc.InceptionV3FID().init, jax.random.key(0),
                            jnp.zeros((1, 75, 75, 3)))["params"]
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    state = {}
    for path in jwi.basic_conv_paths():
        node = shapes
        for p in path.split("."):
            node = node[p]
        kh, kw, cin, cout = node["conv"]["kernel"].shape
        state[f"{path}.conv.weight"] = f32(rng.standard_normal(
            (cout, cin, kh, kw)) / np.sqrt(kh * kw * cin))
        state[f"{path}.bn.weight"] = f32(1.0 + 0.3 * rng.standard_normal(
            cout))
        state[f"{path}.bn.bias"] = f32(0.3 * rng.standard_normal(cout))
        state[f"{path}.bn.running_mean"] = f32(0.5 * rng.standard_normal(
            cout))
        state[f"{path}.bn.running_var"] = f32(rng.random(cout) + 0.5)
        state[f"{path}.bn.num_batches_tracked"] = torch.tensor(7)
    state["fc.weight"] = f32(rng.standard_normal((1008, 2048)))
    state["fc.bias"] = f32(np.zeros(1008))
    state["AuxLogits.conv0.conv.weight"] = f32(rng.standard_normal(
        (128, 768, 1, 1)))
    return state


def test_pytorch_fid_checkpoint_through_both_importers(tmp_path):
    path = tmp_path / "pt_inception.pth"
    torch.save(pytorch_fid_state(), path)
    want = state_dict_from_jax(jwi.import_inception_fid(str(path)))
    got = twi.import_inception_fid(str(path))
    assert set(got) == set(want) == set(tinc.InceptionV3FID().state_dict())
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=0, atol=0, msg=k)
    assert twi.BN_EPS == jwi.BN_EPS
    assert twi.basic_conv_paths() == jwi.basic_conv_paths()


# --------------------------------------------------------------- metrics
def _features(n, d, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((d, d)) / np.sqrt(d)
    return (rng.standard_normal((n, d)) @ mix + shift).astype(np.float32)


def _fid64(a, b):
    """The Fréchet distance in float64 with scipy's ``sqrtm``."""
    mu1, mu2 = a.astype(np.float64).mean(0), b.astype(np.float64).mean(0)
    c1, c2 = (np.cov(x.astype(np.float64), rowvar=False) for x in (a, b))
    covmean = scipy.linalg.sqrtm(c1 @ c2).real
    return float(((mu1 - mu2) ** 2).sum() + np.trace(c1 + c2 - 2 * covmean))


def test_frechet_distance_matches_jax_and_float64():
    a, b = _features(300, 64, 7), _features(300, 64, 8, shift=0.3)
    want = jmetrics.fid_from_features(a, b)
    got = tmetrics.fid_from_features(a, b, device="cpu")
    assert got == pytest.approx(want, rel=1e-4)
    assert got == pytest.approx(_fid64(a, b), rel=2e-3)
    mu1, c1 = tmetrics.feature_statistics(a, device="cpu")
    jmu1, jc1 = jmetrics.feature_statistics(a)
    _close(mu1, jmu1, 1e-5)
    _close(c1, jc1, 1e-5)
    mu2, c2 = tmetrics.feature_statistics(b, device="cpu")
    assert tmetrics.frechet_distance(mu1, c1, mu2, c2,
                                     device="cpu") == pytest.approx(
        jmetrics.frechet_distance(jmu1, jc1, *jmetrics.feature_statistics(b)),
        rel=1e-4)
    assert abs(tmetrics.fid_from_features(a, a, device="cpu")) < 1e-3


def test_frechet_distance_of_few_samples_matches_jax():
    """64 samples of 2048-d features: the covariances have rank 63 and the
    inner matrix a cluster of near-zero eigenvalues (cuSOLVER's fp32 syevd
    does not converge there, so the port's square roots are fp64); JAX's
    fp32 square roots sit ~6e-4 from exact."""
    a = _features(64, 2048, 17) * 0.1
    b = _features(64, 2048, 18, shift=0.3) * 0.1
    want = jmetrics.fid_from_features(a, b)
    assert tmetrics.fid_from_features(a, b, device="cpu") == pytest.approx(
        want, rel=1e-3)


def test_kid_matches_jax_exactly():
    a, b = _features(60, 32, 9), _features(50, 32, 10, shift=0.2)
    for kw in ({}, dict(n_subsets=3, subset_size=20, seed=4)):
        assert tmetrics.kid_from_features(a, b, **kw) == \
            jmetrics.kid_from_features(a, b, **kw)
    with pytest.raises(ValueError, match="KID"):
        tmetrics.kid_from_features(a[:1], b)


SMALL_CLIP = dict(embed_dim=16, image_resolution=28, vision_layers=2,
                  vision_width=32, vision_patch_size=14, context_length=10,
                  vocab_size=50, transformer_width=16, transformer_heads=2,
                  transformer_layers=2)


@pytest.fixture(scope="module")
def small_clip():
    jmod = jclip.CLIP(**SMALL_CLIP)
    params = jax_random_params(jmod, jnp.zeros((1, 28, 28, 3)),
                               jnp.zeros((1, 10), jnp.int32), seed=11)
    tmod = load_jax_params(tclip.CLIP(**SMALL_CLIP), params).eval()
    return jmod, params, tmod


def test_clip_score_and_clip_fid_match_jax(small_clip):
    jmod, params, tmod = small_clip
    images_a = np.tanh(_rand((40, 28, 28, 3), 12))
    images_b = np.tanh(_rand((40, 28, 28, 3), 13) + 0.5)
    tokens = np.random.default_rng(14).integers(1, 50, (40, 10)).astype(
        np.int32)
    want = jmetrics.clip_score(images_a, tokens, jmod, params)
    got = tmetrics.clip_score(images_a, tokens, tmod, device="cpu")
    assert got == pytest.approx(want, rel=1e-4)
    feats = tmetrics.clip_image_features(images_a, tmod, batch_size=16,
                                         device="cpu")
    _close(feats, jmetrics.clip_image_features(images_a, jmod, params,
                                               batch_size=16), 1e-5)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)
    want = jmetrics.clip_fid(images_a, images_b, jmod, params)
    got = tmetrics.clip_fid(images_a, images_b, tmod, device="cpu")
    assert got == pytest.approx(want, rel=1e-4)


def test_inception_features_and_fid_match_jax(inception_params):
    """4 images at 64^2 in batches of 2, resized inside each batch, through
    the model built from the carried-across ``state_dict``."""
    sd = state_dict_from_jax(inception_params)
    images_a = _uniform((4, 64, 64, 3), 15)
    images_b = _uniform((4, 64, 64, 3), 16) ** 2
    want = jmetrics.inception_features(images_a, inception_params,
                                       batch_size=2)
    got = tmetrics.inception_features(images_a, sd, batch_size=2,
                                      device="cpu")
    assert got.shape == (4, 2048) and got.dtype == np.float32
    _close(got, want, 1e-4)
    fid = tmetrics.inception_fid(images_a, images_b, sd, device="cpu")
    assert np.isfinite(fid) and fid > 0.0
