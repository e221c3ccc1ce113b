"""Parity of the SD3 slice's modules with the JAX package's, on the CPU: the
same Flax parameters (seeded numpy, shaped by ``jax.eval_shape``) go through
``io.from_jax`` into the port, and both get the same inputs.

Tolerance in fp32: atol 1e-4 and rtol 1e-4 (summation order differs between
XLA and PyTorch's CPU kernels). The bf16 case compares the two packages'
bf16 forwards: both round every activation to 8 significant bits at the same
places but sum in different orders, so outputs of magnitude ~1 may differ by
a few bf16 ulps after a few layers: atol 6e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.models import sd3_vae as jvae
from from_ddpm_to_stable_diffusion_tpu.models import text_encoders as jte
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params, state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd3_vae as tvae
from from_ddpm_to_stable_diffusion_tpu_torch.models import (
    text_encoders as tte)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
    flax_default_init_)
from from_ddpm_to_stable_diffusion_tpu_torch.utils.dtypes import (
    cast_params_for_inference)
from tests.test_torch_models import jax_random_params

ATOL = RTOL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _outputs(x):
    return [a for a in (x if isinstance(x, (tuple, list)) else (x,))
            if a is not None]


def _compare(jmod, tmod, params, *inputs, atol=ATOL, rtol=RTOL):
    want = _outputs(jax.jit(jmod.apply)({"params": params},
                                        *(jnp.asarray(a) for a in inputs)))
    load_jax_params(tmod, params).eval()
    with torch.no_grad():
        got = _outputs(tmod(*(torch.from_numpy(np.array(a)).long()
                              if np.issubdtype(a.dtype, np.integer)
                              else torch.from_numpy(np.array(a))
                              for a in inputs)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol)


TOKENS = np.random.default_rng(3).integers(0, 64, (2, 77)).astype(np.int32)
TOKENS[1, 40] = 63          # the arg-max (EOS) position differs per row


# ------------------------------------------------------------ text encoders
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("tap", [-2, -1])
def test_clip_text_model_matches_jax(act, tap):
    """Three layers, tap at −2 (as SD3 takes it) and at the last layer: last
    hidden, tapped hidden, pooled."""
    jcfg = jte.CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=3,
                              num_heads=4, hidden_act=act)
    tcfg = tte.CLIPTextConfig(**dataclasses.asdict(jcfg))
    jmod = jte.CLIPTextModel(jcfg, intermediate_output=tap)
    tmod = tte.CLIPTextModel(tcfg, intermediate_output=tap)
    params = jax_random_params(jmod, jnp.asarray(TOKENS), seed=1)
    _compare(jmod, tmod, params, TOKENS)
    with torch.no_grad():
        last, tap, pooled = tmod(torch.from_numpy(TOKENS).long())
    assert tap is not None and pooled.dtype == torch.float32
    assert pooled.shape == (2, 32)


def test_clip_text_model_without_tap_and_configs():
    cfg = tte.CLIPTextConfig(vocab_size=64, hidden_size=32, num_layers=1,
                             num_heads=4)
    with torch.no_grad():
        _, tap, _ = tte.CLIPTextModel(cfg)(torch.zeros(1, 77,
                                                       dtype=torch.long))
    assert tap is None
    assert (dataclasses.asdict(tte.CLIP_L_CONFIG)
            == dataclasses.asdict(jte.CLIP_L_CONFIG))
    assert (dataclasses.asdict(tte.CLIP_G_CONFIG)
            == dataclasses.asdict(jte.CLIP_G_CONFIG))
    assert (dataclasses.asdict(tte.T5Config())
            == dataclasses.asdict(jte.T5Config()))
    with pytest.raises(ValueError):
        tte.CLIPTextLayer(dataclasses.replace(cfg, hidden_act="relu"))
    int8 = tte.T5Encoder(tte.T5Config(vocab_size=8, d_model=32, d_ff=64,
                                      num_layers=1, num_heads=2,
                                      int8_mm=True))
    assert type(int8.block0.wo).__name__ == "QuantLinear"
    assert type(int8.block0.attn.q).__name__ == "QuantLinear"


def test_t5_encoder_matches_jax():
    """Three blocks share block 0's bucket bias; unscaled logits."""
    jcfg = jte.T5Config(vocab_size=100, d_model=64, d_ff=128, num_layers=3,
                        num_heads=4)
    tcfg = tte.T5Config(**dataclasses.asdict(jcfg))
    jmod, tmod = jte.T5Encoder(jcfg), tte.T5Encoder(tcfg)
    params = jax_random_params(jmod, jnp.asarray(TOKENS), seed=2)
    assert "relative_attention_bias" in params["block0"]["attn"]
    assert "relative_attention_bias" not in params["block1"]["attn"]
    _compare(jmod, tmod, params, TOKENS)


# -------------------------------------------------------------------- MMDiT
def _mmdit_cfgs(depth, qk_norm):
    kw = dict(depth=depth, pos_embed_max_size=16, adm_in_channels=32,
              context_dim=48, qk_norm=qk_norm)
    return jmm.MMDiTConfig(**kw), tmm.MMDiTConfig(**kw)


MMDIT_INPUTS = (_rand((2, 8, 12, 16), 10), np.asarray([999.0, 371.5],
                                                       np.float32),
                _rand((2, 32), 11), _rand((2, 10, 48), 12))


@pytest.mark.parametrize("depth,qk_norm", [(2, None), (3, None), (2, "rms"),
                                           (3, "ln")])
def test_mmdit_matches_jax(depth, qk_norm):
    """Depth 2 and 3 cover an ordinary block and the pre-only last block; a
    non-square latent covers the centre crop of the position grid."""
    jcfg, tcfg = _mmdit_cfgs(depth, qk_norm)
    jmod, tmod = jmm.MMDiT(jcfg), tmm.MMDiT(tcfg)
    params = jax_random_params(jmod, *map(jnp.asarray, MMDIT_INPUTS), seed=3)
    last = params[f"joint_block{depth - 1}"]["context_block"]
    assert "proj" not in last and "mlp_fc1" not in last
    assert last["adaLN"]["kernel"].shape[-1] == 2 * jcfg.hidden_size
    _compare(jmod, tmod, params, *MMDIT_INPUTS)
    if qk_norm:
        want = jmm.qk_norm_logit_bound(params, 64, qk_norm)
        got = tmm.qk_norm_logit_bound(tmod, 64, qk_norm)
        assert want > 0 and got == pytest.approx(want, rel=1e-6)
        block = tmod.joint_block0
        assert block.stability == "bounded"
    else:
        assert tmod.joint_block0.stability == "online"
        assert tmm.qk_norm_logit_bound(tmod, 64) == 0.0
    assert tmm.BOUNDED_LOGIT_BUDGET == jmm.BOUNDED_LOGIT_BUDGET


def test_mmdit_bf16_matches_jax():
    """The serving dtype: bf16 weights and activations on both sides."""
    jcfg, tcfg = _mmdit_cfgs(2, None)
    params = jax_random_params(jmm.MMDiT(jcfg),
                               *map(jnp.asarray, MMDIT_INPUTS), seed=4)
    want = jax.jit(jmm.MMDiT(jcfg, dtype=jnp.bfloat16).apply)(
        {"params": params}, *map(jnp.asarray, MMDIT_INPUTS))
    tmod = cast_params_for_inference(
        load_jax_params(tmm.MMDiT(tcfg), params)).eval()
    assert tmod.joint_block0.x_block.qkv.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, MMDIT_INPUTS))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=6e-2)


def test_mmdit_dismantled_block_alone_and_modulate():
    jblock = jmm.DismantledBlock(128, 2, qk_norm="rms")
    tblock = tmm.DismantledBlock(128, 2, qk_norm="rms")
    x, c = _rand((2, 20, 128), 20), _rand((2, 128), 21)
    params = jax_random_params(jblock, jnp.asarray(x), jnp.asarray(c), seed=5)
    _compare(jblock, tblock, params, x, c)
    shift, scale = _rand((2, 128), 22), _rand((2, 128), 23)
    np.testing.assert_allclose(
        tmm.modulate(*map(torch.from_numpy, (x, shift, scale))).numpy(),
        np.asarray(jmm.modulate(*map(jnp.asarray, (x, shift, scale)))),
        atol=1e-6)


@pytest.mark.parametrize("field,value", [("attention_impl", "ring"),
                                         ("attention_impl", "ulysses"),
                                         ("moe_experts", 4)])
def test_mmdit_unported_options_raise(field, value):
    with pytest.raises(NotImplementedError, match="A8"):
        tmm.MMDiT(tmm.MMDiTConfig(depth=1, pos_embed_max_size=4,
                                  **{field: value}))


def test_mmdit_config_defaults_match_jax():
    assert (dataclasses.asdict(tmm.MMDiTConfig())
            == dataclasses.asdict(jmm.MMDiTConfig()))
    assert tmm.MMDiTConfig().hidden_size == 1536


# ---------------------------------------------------------------------- VAE
def test_sd3_vae_decoder_matches_jax():
    kw = dict(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1)
    z = _rand((1, 4, 6, 16), 30, 0.5)
    jmod, tmod = jvae.SD3VAEDecoder(**kw), tvae.SD3VAEDecoder(**kw)
    params = jax_random_params(jmod, jnp.asarray(z), seed=6)
    _compare(jmod, tmod, params, z)


def test_sd3_latent_format_matches_jax():
    x = _rand((2, 4, 4, 16), 31)
    for name in ("process_in", "process_out"):
        np.testing.assert_allclose(
            getattr(tvae.SD3LatentFormat, name)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jvae.SD3LatentFormat, name)(jnp.asarray(x))),
            rtol=1e-6)
    np.testing.assert_array_equal(tvae.SD3LatentFormat.PREVIEW_FACTORS,
                                  jvae.SD3LatentFormat.PREVIEW_FACTORS)
    want = np.asarray(jvae.SD3LatentFormat.decode_latent_to_preview(
        jnp.asarray(x * 3)))
    got = tvae.SD3LatentFormat.decode_latent_to_preview(x * 3).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, 4, 4, 3)
    np.testing.assert_allclose(got.astype(np.int16), want.astype(np.int16),
                               atol=1)


# ----------------------------------------------------------------- from_jax
def _groups():
    """(name, JAX module, port module, init inputs) of the five groups."""
    tok = jnp.asarray(TOKENS)
    jcfg, tcfg = _mmdit_cfgs(2, "ln")
    clip = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4)
    t5 = dict(vocab_size=64, d_model=64, d_ff=96, num_layers=2, num_heads=4)
    vae = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    return [
        ("mmdit", jmm.MMDiT(jcfg), tmm.MMDiT(tcfg),
         tuple(map(jnp.asarray, MMDIT_INPUTS))),
        ("vae_decoder", jvae.SD3VAEDecoder(**vae), tvae.SD3VAEDecoder(**vae),
         (jnp.zeros((1, 4, 4, 16)),)),
        ("clip_l", jte.CLIPTextModel(jte.CLIPTextConfig(**clip), -2),
         tte.CLIPTextModel(tte.CLIPTextConfig(**clip), -2), (tok,)),
        ("clip_g", jte.CLIPTextModel(
            jte.CLIPTextConfig(hidden_act="gelu", **clip), -2),
         tte.CLIPTextModel(tte.CLIPTextConfig(hidden_act="gelu", **clip), -2),
         (tok,)),
        ("t5", jte.T5Encoder(jte.T5Config(**t5)),
         tte.T5Encoder(tte.T5Config(**t5)), (tok,)),
    ]


@pytest.mark.parametrize("index", range(5))
def test_from_jax_is_complete_both_ways(index):
    """Every Flax leaf lands on exactly one port parameter of the same
    size, and a missing or an extra leaf is refused."""
    name, jmod, tmod, args = _groups()[index]
    params = jax_random_params(jmod, *args, seed=7)
    sd = state_dict_from_jax(params)
    own = tmod.state_dict()
    assert set(sd) == set(own), name
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves == len(list(tmod.parameters()))
    assert all(sd[k].shape == own[k].shape for k in sd)
    load_jax_params(tmod, params)
    for key, value in tmod.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), sd[key].numpy(), key)
    first = next(iter(params))
    with pytest.raises(ValueError):
        load_jax_params(tmod, {k: v for k, v in params.items()
                               if k != first})
    with pytest.raises(ValueError):
        load_jax_params(tmod, {**params, "extra": {"kernel": np.zeros((2,
                                                                       2))}})


def test_flax_default_init_of_the_sd3_parameters():
    """Scales one, biases and position tables zero, ``text_projection`` the
    identity, T5's bucket table standard normal, embeddings fan-in normal:
    the initializers the JAX modules declare."""
    gen = torch.Generator().manual_seed(0)
    t5 = flax_default_init_(tte.T5Encoder(tte.T5Config(
        vocab_size=64, d_model=64, d_ff=96, num_layers=2, num_heads=4,
        rel_buckets=32)), gen)
    assert bool((t5.block1.ln1_scale == 1).all())
    assert bool((t5.final_ln_scale == 1).all())
    table = t5.block0.attn.relative_attention_bias
    assert 0.5 < table.std().item() < 1.5
    assert abs(t5.embed_tokens.weight.std().item() - 64 ** -0.5) < 0.02
    assert abs(t5.block0.wi_0.weight.std().item() - 64 ** -0.5) < 0.02
    clip = flax_default_init_(tte.CLIPTextModel(tte.CLIPTextConfig(
        vocab_size=64, hidden_size=32, num_layers=1, num_heads=4)), gen)
    assert torch.equal(clip.text_projection, torch.eye(32))
    assert not bool(clip.position_embedding.any())
    mm = flax_default_init_(tmm.MMDiT(_mmdit_cfgs(2, "ln")[1]), gen)
    assert not bool(mm.pos_embed.any())
    norm = mm.joint_block0.x_block.ln_q
    assert bool((norm.weight == 1).all()) and not bool(norm.bias.any())
    assert not bool(mm.final_linear.bias.any())
    assert mm.x_embedder.weight.std().item() > 0
