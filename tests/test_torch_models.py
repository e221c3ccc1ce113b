"""Parity of the PyTorch port's SD1 modules with the JAX package's, on the
CPU in fp32: the same Flax parameters (seeded numpy, shaped by
``jax.eval_shape``, so no Flax init is compiled) go through
``io.from_jax`` into the port, and both get the same inputs.

Tolerance: fp32, atol 1e-4 and rtol 1e-4 (summation order differs between
XLA and PyTorch's CPU kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import layers as jl
from from_ddpm_to_stable_diffusion_tpu.models import sd1 as jsd1
from from_ddpm_to_stable_diffusion_tpu.utils.dtypes import (
    cast_params_for_inference as jax_cast)
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params, state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import layers as tl
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd1 as tsd1
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
    flax_default_init_)
from from_ddpm_to_stable_diffusion_tpu_torch.utils.dtypes import (
    cast_params_for_inference)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

ATOL = RTOL = 1e-4


def jax_random_params(module, *args, seed=0):
    """Flax parameters for ``module.init(key, *args)`` drawn with numpy:
    fan-in normal kernels and embeddings, scales near 1, small biases."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "embedding":
            a = rng.standard_normal(s.shape) / np.sqrt(s.shape[-1])
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _compare(jmod, tmod, params, *inputs):
    want = jax.jit(jmod.apply)({"params": params},
                               *(jnp.asarray(a) for a in inputs))
    load_jax_params(tmod, params).eval()
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(np.array(a)) for a in inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    return params


TOKENS = np.random.default_rng(3).integers(0, 64, (2, 77)).astype(np.int32)
CTX = _rand((2, 77, 768), 4)


def _clip():
    return (jsd1.CLIPText(vocab_size=64, num_layers=1, num_heads=4,
                          embed_dim=64),
            tsd1.CLIPText(vocab_size=64, num_layers=1, num_heads=4,
                          embed_dim=64), (TOKENS,))


def _resblock():
    x, t = _rand((2, 8, 8, 64), 5), _rand((2, 128), 6)
    return jsd1.SD1ResBlock(96), tsd1.SD1ResBlock(64, 96, 128), (x, t)


def _transformer():
    return (jl.TransformerBlock(num_heads=4), tl.TransformerBlock(64, 768, 4),
            (_rand((2, 8, 8, 64), 7), CTX))


def _unet():
    x, t = _rand((2, 8, 8, 4), 8), _rand((2, 320), 9)
    return (jsd1.SD1UNet(model_channels=32, num_heads=4),
            tsd1.SD1UNet(model_channels=32, num_heads=4), (x, CTX, t))


def _decoder():
    return jsd1.VAEDecoder(), tsd1.VAEDecoder(), (_rand((1, 8, 8, 4), 10),)


MODULES = {"clip": _clip, "resblock": _resblock,
           "transformer": _transformer, "unet": _unet, "decoder": _decoder}


@pytest.fixture(scope="module")
def built():
    """(jax module, port module, inputs, params) per module, built once."""
    out = {}
    for name, make in MODULES.items():
        jmod, tmod, inputs = make()
        out[name] = (jmod, tmod, inputs,
                     jax_random_params(jmod, *inputs, seed=len(out)))
    return out


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_jax(built, name):
    jmod, tmod, inputs, params = built[name]
    _compare(jmod, tmod, params, *inputs)


@pytest.mark.parametrize("name", list(MODULES))
def test_converter_is_complete_both_ways(built, name):
    """Every JAX leaf lands on a port parameter and every port parameter
    gets a JAX leaf; a missing or a stray leaf is refused."""
    _, tmod, _, params = built[name]
    assert set(state_dict_from_jax(params)) == set(tmod.state_dict())
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(list(tmod.parameters()))
    first = next(iter(params))
    with pytest.raises(ValueError, match="without a JAX leaf"):
        load_jax_params(tmod, {k: v for k, v in params.items() if k != first})
    with pytest.raises(ValueError, match="without a port parameter"):
        load_jax_params(tmod, {**params, "stray": {"bias": np.zeros(3)}})


def test_cast_params_for_inference_matches_jax(built):
    """bf16 storage picks the same parameters on both sides: conv and
    dense weights and biases, embeddings; norm parameters stay fp32."""
    _, _, _, params = built["unet"]
    tmod = load_jax_params(tsd1.SD1UNet(model_channels=32, num_heads=4),
                           params)
    cast_params_for_inference(tmod, torch.bfloat16)
    # float16 marks the leaves JAX stored in bf16 (numpy has no bf16)
    marks = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float16 if a.dtype == jnp.bfloat16
                           else np.float32),
        jax_cast(jax.tree_util.tree_map(jnp.asarray, params)))
    want = {k: "bfloat16" if v.dtype == torch.float16 else "float32"
            for k, v in state_dict_from_jax(marks).items()}
    got = {k: str(v.dtype).replace("torch.", "")
           for k, v in tmod.state_dict().items()}
    assert got == want
    assert want["enc1_res.norm1.weight"] == "float32"
    assert want["enc1_res.conv1.bias"] == "bfloat16"


def test_flax_default_init():
    g = torch.Generator().manual_seed(0)
    m = flax_default_init_(tsd1.CLIPText(vocab_size=64, num_layers=1,
                                         num_heads=4, embed_dim=64), g)
    w = m.layer0.fc1.weight
    std = 64 ** -0.5 / 0.87962566103423978
    assert w.abs().max() <= 2 * std and abs(w.std() / (64 ** -0.5) - 1) < 0.1
    assert bool((m.layer0.fc1.bias == 0).all())
    assert bool((m.layer0.ln1.weight == 1).all())
    assert bool((m.position_value == 0).all())
    assert abs(m.token_embedding.weight.std() * 8 - 1) < 0.1
