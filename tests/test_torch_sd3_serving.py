"""The rest of SD3 serving, JAX package against the PyTorch port, on the CPU:
the VAE encoder and img2img, the tiled VAE decode, ``per_sample_seeds``,
CLIP prompt weights, int8 serving, freeing the text encoders, and the text
entry points over the SentencePiece / CLIP tokenizer trio.

The bundle is the reduced one of ``tests/test_torch_sd3_pipeline.py``
(depth-2 MMDiT, 2-layer CLIPs at the real widths 768 and 1280 over a
1024-token vocabulary that holds the synthetic CLIP vocabulary, a 1-layer
T5 at d_model 4096, the full VAE encoder and decoder) in fp32, 64x64, 4
steps, CFG 5, shift 3. The port gets the JAX parameters through
``SD3Models.from_jax`` and the JAX draws through ``noise=`` /
``enc_noise=``, since seeds cannot match across frameworks.

Tolerances: conditioning, encoder outputs and latents rtol = atol = 1e-4
(summation order); uint8 images +-1 level. The tiled decode: fp32 max abs
3e-5 against the whole decode and against JAX's ``tiled_decode`` (the JAX
test's bound), bf16 0.2 (13 GroupNorms amplify ulp-level differences with
random gains), strip invariance 5e-6. int8 end to end: the final latents
within 2e-3 relative L2 of JAX's from the same conditioning, or three times
JAX's own movement under a 1e-6 relative change of that conditioning,
whichever is larger (one-step rounding flips of the per-token quantization,
``tests/test_torch_quantize.py``); the int8 conditioning within 2e-3.
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.io import spm_tokenizer as jspm
from from_ddpm_to_stable_diffusion_tpu.io import tokenizer as jtok
from from_ddpm_to_stable_diffusion_tpu.models import sd3_vae as jvae
from from_ddpm_to_stable_diffusion_tpu.models import sd3_vae_tiled as jtiled
from from_ddpm_to_stable_diffusion_tpu.models import text_encoders as jte
from from_ddpm_to_stable_diffusion_tpu.pipelines import sd3 as jpipe
from from_ddpm_to_stable_diffusion_tpu_torch.io import spm_tokenizer as tspm
from from_ddpm_to_stable_diffusion_tpu_torch.io import tokenizer as ttok
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params)
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd3_vae as tvae
from from_ddpm_to_stable_diffusion_tpu_torch.models import (
    sd3_vae_tiled as ttiled)
from from_ddpm_to_stable_diffusion_tpu_torch.models import (
    text_encoders as tte)
from from_ddpm_to_stable_diffusion_tpu_torch.ops import quantize as tq
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd3 as tpipe
from tests.test_torch_spm_tokenizer import PIECES, WORDS
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

H = W = 64
STEPS = 4
LATENT = (H // 8, W // 8, 16)
CLIP_L = dict(vocab_size=1024, hidden_size=768, num_layers=2, num_heads=4)
CLIP_G = dict(vocab_size=1024, hidden_size=1280, num_layers=2, num_heads=4,
              hidden_act="gelu")
T5 = dict(vocab_size=64, d_model=4096, d_ff=64, num_layers=1, num_heads=4)
RNG = np.random.default_rng(9)
CLIP_TOKENS = RNG.integers(1, 1024, (1, 77)).astype(np.int32)
T5_TOKENS = RNG.integers(1, 64, (1, 77)).astype(np.int32)
INIT_IMAGE = RNG.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
WEIGHTS = np.where(np.arange(77) % 5 == 1, 1.3,
                   np.where(np.arange(77) % 7 == 2, 0.7, 1.0))[None]
KW = dict(t5_tokens=T5_TOKENS, width=W, height=H, steps=STEPS,
          cfg_scale=5.0)


def _jax_models():
    return jpipe.SD3Models.initialize(
        jax.random.key(0), dtype="fp32", depth=2, pos_embed_max_size=16,
        clip_l_cfg=jte.CLIPTextConfig(**CLIP_L),
        clip_g_cfg=jte.CLIPTextConfig(**CLIP_G),
        t5_config=jte.T5Config(**T5))


def _port_models(params):
    return tpipe.SD3Models.from_jax(
        params, device="cpu",
        mmdit_config=tmm.MMDiTConfig(depth=2, pos_embed_max_size=16),
        clip_l_cfg=tte.CLIPTextConfig(**CLIP_L),
        clip_g_cfg=tte.CLIPTextConfig(**CLIP_G),
        t5_config=tte.T5Config(**T5))


@pytest.fixture(scope="module")
def bundles():
    """(JAX inferencer, port inferencer) over the same parameters, each
    with its own package's tokenizer trio on one synthetic model file."""
    jmodels = _jax_models()
    blob = jspm.build_spm_model(PIECES)
    jvocab, jmerges = jtok.build_simple_vocab(WORDS)
    tvocab, tmerges = ttok.build_simple_vocab(WORDS)
    assert len(tvocab) <= CLIP_L["vocab_size"]
    jtrio = jspm.SD3Tokenizer(
        jtok.CLIPTokenizer(jvocab, jmerges),
        jspm.T5XXLTokenizer(jspm.SentencePieceUnigram(
            jspm.parse_spm_model(blob))))
    ttrio = tspm.SD3Tokenizer(
        ttok.CLIPTokenizer(tvocab, tmerges),
        tspm.T5XXLTokenizer(tspm.SentencePieceUnigram(
            tspm.parse_spm_model(blob))))
    tmodels = _port_models(jmodels.params)
    assert tmodels.vae_encoder is not None
    return (jmodels, jpipe.SD3Inferencer(jmodels, shift=3.0,
                                         tokenizer=jtrio,
                                         decode_mode="whole"),
            tpipe.SD3Inferencer(tmodels, shift=3.0, tokenizer=ttrio))


def _jax_noise(seed, shape):
    """The starting noise of the JAX ``SD3Inferencer.denoise``."""
    return np.asarray(jax.random.normal(jax.random.key(seed), shape))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _levels(got, want, levels=1):
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_allclose(got.astype(np.int16), want.astype(np.int16),
                               atol=levels)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ------------------------------------------------------------ VAE encoder
def test_sd3_vae_encoder_matches_jax(bundles):
    jmodels, _, tinf = bundles
    want = jax.jit(jmodels.vae_encoder.apply)(
        {"params": jmodels.params["vae_encoder"]}, jnp.asarray(INIT_IMAGE))
    with torch.no_grad():
        got = tinf.models.vae_encoder(torch.from_numpy(INIT_IMAGE))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 8, 8, 32)
    _close(got.numpy(), want)
    # the port's module names are the checkpoint rules' and the JAX tree's
    assert set(tinf.models.vae_encoder.state_dict()) == set(
        load_jax_params(tvae.SD3VAEEncoder(),
                        jmodels.params["vae_encoder"]).state_dict())


def test_vae_encode_matches_jax(bundles):
    _, jinf, tinf = bundles
    want = jinf.vae_encode(INIT_IMAGE, jax.random.key(5))
    enc_noise = _jax_noise(5, (1, *LATENT))
    got = tinf.vae_encode(INIT_IMAGE, enc_noise=enc_noise)
    _close(got.numpy(), want)
    # a generator's draw instead: same shape, finite, another latent
    drawn = tinf.vae_encode(INIT_IMAGE, generator=torch.Generator()
                            .manual_seed(5))
    assert drawn.shape == got.shape and torch.isfinite(drawn).all()
    with pytest.raises(ValueError, match="enc_noise"):
        tinf.vae_encode(INIT_IMAGE, enc_noise=np.zeros((1, 4, 4, 16)))


def test_img2img_matches_jax(bundles):
    """``init_image`` at strength 0.6: JAX draws the encoder's noise from
    key(seed + 1), the denoise noise from key(seed)."""
    _, jinf, tinf = bundles
    seed = 7
    want = jinf.gen_image(CLIP_TOKENS, seed=seed, init_image=INIT_IMAGE,
                          denoise_strength=0.6, **KW)
    got = tinf.gen_image(CLIP_TOKENS, init_image=INIT_IMAGE,
                         denoise_strength=0.6,
                         noise=_jax_noise(seed, (1, *LATENT)),
                         enc_noise=_jax_noise(seed + 1, (1, *LATENT)), **KW)
    assert want.std() > 0
    _levels(got, want)
    # without hooks: the port's own draws (generators seeded seed, seed+1)
    a = tinf.gen_image(CLIP_TOKENS, seed=seed, init_image=INIT_IMAGE,
                       denoise_strength=0.6, **KW)
    np.testing.assert_array_equal(a, tinf.gen_image(
        CLIP_TOKENS, seed=seed, init_image=INIT_IMAGE, denoise_strength=0.6,
        **KW))


# ------------------------------------------------------------ tiled decode
def _small_decoders(dtype):
    """The JAX tiled test's small decoder (ch 32, z 4, GN affines moved off
    1 / 0), its parameters, and the port's decoder over them."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    dec = jvae.SD3VAEDecoder(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                             z_channels=4, dtype=jdt)
    z = jax.random.normal(jax.random.key(1), (2, 4, 4, 4), jnp.float32)
    params = dec.init(jax.random.key(0), z)["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 * np.prod(p.shape) % 7 if p.ndim == 1 else p,
        params)
    port = load_jax_params(tvae.SD3VAEDecoder(ch=32, z_channels=4), params)
    if dtype == torch.bfloat16:
        from from_ddpm_to_stable_diffusion_tpu_torch.utils.dtypes import (
            cast_params_for_inference)
        cast_params_for_inference(port, torch.bfloat16)
    return dec, params, port.eval(), z


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 3e-5),
                                        (torch.bfloat16, 0.2)],
                         ids=["fp32", "bf16"])
def test_tiled_decode_matches_whole_and_jax(dtype, atol):
    dec, params, port, z = _small_decoders(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want_tiled = np.asarray(jtiled.tiled_decode(
        params, z, ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2, dtype=jdt,
        strip=8))
    tz = torch.from_numpy(np.asarray(z))
    with torch.no_grad():
        whole = port(tz)
        got = ttiled.tiled_decode(port, tz, strip=8)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 32, 32, 3)
    assert np.abs(got.numpy() - whole.numpy()).max() < atol
    assert np.abs(got.numpy() - want_tiled).max() < atol


def test_tiled_decode_strip_invariance_and_image_batch():
    _, _, port, z = _small_decoders(torch.float32)
    tz = torch.from_numpy(np.asarray(z))
    with torch.no_grad():
        small = ttiled.tiled_decode(port, tz, strip=8)
        one = ttiled.tiled_decode(port, tz, strip=4096)
        odd = ttiled.tiled_decode(port, tz, strip=5)     # a short last strip
        sub = ttiled.tiled_decode(port, tz, strip=8, image_batch=1)
    np.testing.assert_allclose(small.numpy(), one.numpy(), atol=5e-6)
    np.testing.assert_allclose(odd.numpy(), one.numpy(), atol=5e-6)
    np.testing.assert_allclose(sub.numpy(), small.numpy(), atol=1e-3)


def test_decode_modes_match_jax(bundles):
    """The full-width decoder through ``vae_decode``: "tiled" against the
    JAX inferencer's tiled decode and the port's whole one; "auto" at 8x8
    latents takes the whole decode."""
    _, jinf, tinf = bundles
    latent = np.random.default_rng(3).standard_normal(
        (2, *LATENT)).astype(np.float32)
    want = jinf.vae_decode(jnp.asarray(latent), mode="tiled")
    got = tinf.vae_decode(latent, mode="tiled")
    _levels(got, want)
    _levels(tinf.vae_decode(latent, mode="whole"), got)
    np.testing.assert_array_equal(tinf.vae_decode(latent),
                                  tinf.vae_decode(latent, mode="whole"))
    tiled = tpipe.SD3Inferencer(tinf.models, decode_mode="tiled")
    img = tiled.gen_image(CLIP_TOKENS, noise=_jax_noise(2, (1, *LATENT)),
                          **KW)
    _levels(img, jinf.gen_image(CLIP_TOKENS, seed=2, **KW))
    with pytest.raises(ValueError, match="decode"):
        tinf.vae_decode(latent, mode="strips")


# ------------------------------------------------------- per-sample seeds
def test_per_sample_seeds_match_jax(bundles):
    """Seeds filled as JAX fills them, each sample's noise its own: the
    JAX request's images from the draws of the port's filled seeds."""
    _, jinf, tinf = bundles
    seeds = [11, None]
    clip = np.concatenate([CLIP_TOKENS, CLIP_TOKENS[:, ::-1]])
    kw = dict(KW, t5_tokens=np.concatenate([T5_TOKENS] * 2))
    want = jinf.gen_image(clip, seed=7, per_sample_seeds=seeds, **kw)
    filled = tpipe.sample_seeds(7, seeds)
    assert filled == [11, (7 * 100003 + 17 + 1) & 0xFFFFFFFF]
    assert tpipe.sample_seeds(2 ** 40, [None])[0] == (
        2 ** 40 * 100003 + 1) & 0xFFFFFFFF
    noise = np.stack([_jax_noise(s, LATENT) for s in filled])
    got = tinf.gen_image(clip, noise=noise, **kw)
    _levels(got, want)
    # the port's own draws: a sample's noise whatever batch it rides in
    alone = tinf.initial_noise((1, *LATENT), per_sample_seeds=[11])
    batch = tinf.initial_noise((3, *LATENT), seed=7,
                               per_sample_seeds=[5, 11, None])
    torch.testing.assert_close(batch[1], alone[0], rtol=0, atol=0)
    torch.testing.assert_close(alone, tinf.initial_noise((1, *LATENT),
                                                         seed=11),
                               rtol=0, atol=0)
    torch.testing.assert_close(batch[2], tinf.initial_noise(
        (1, *LATENT), seed=7 * 100003 + 2 * 17 + 1)[0], rtol=0, atol=0)
    two = tinf.gen_image(clip, seed=7, per_sample_seeds=seeds, **kw)
    one = tinf.gen_image(clip[1:], seed=7, per_sample_seeds=[filled[1]],
                         **dict(kw, t5_tokens=T5_TOKENS))
    _levels(one[0], two[1])
    with pytest.raises(ValueError, match="per_sample_seeds"):
        tinf.gen_image(clip, per_sample_seeds=[1], **kw)


# --------------------------------------------------------- prompt weights
def test_clip_weights_match_jax(bundles):
    _, jinf, tinf = bundles
    want_ctx, want_pooled = jinf.get_cond(CLIP_TOKENS, T5_TOKENS,
                                          clip_weights=WEIGHTS)
    got_ctx, got_pooled = tinf.get_cond(CLIP_TOKENS, T5_TOKENS,
                                        clip_weights=WEIGHTS)
    _close(got_ctx, want_ctx)
    _close(got_pooled, want_pooled)
    plain = tinf.get_cond(CLIP_TOKENS, T5_TOKENS)[0]
    assert (got_ctx - plain)[:, :77].abs().max() > 1e-3
    torch.testing.assert_close(got_ctx[:, 77:], plain[:, 77:])  # T5: as is
    want = jinf.gen_image(CLIP_TOKENS, seed=4, clip_weights=WEIGHTS,
                          neg_clip_weights=WEIGHTS[:, ::-1], **KW)
    got = tinf.gen_image(CLIP_TOKENS, clip_weights=WEIGHTS,
                         neg_clip_weights=WEIGHTS[:, ::-1],
                         noise=_jax_noise(4, (1, *LATENT)), **KW)
    _levels(got, want)


# ------------------------------------------------------------ text entry
PROMPT = "a photo of a cat"


def test_text_entry_points_match_jax(bundles):
    _, jinf, tinf = bundles
    for got, want in zip(tinf.tokenize(PROMPT), jinf.tokenize(PROMPT)):
        np.testing.assert_array_equal(got, want)
        assert got.shape == (1, 77) and got.dtype == np.int32
    for got, want in zip(tinf.get_cond_text(PROMPT),
                         jinf.get_cond_text(PROMPT)):
        _close(got, want)
    kw = dict(width=W, height=H, steps=STEPS)
    want = jinf.gen_image_text(PROMPT, "cats", seed=3, **kw)
    got = tinf.gen_image_text(PROMPT, "cats",
                              noise=_jax_noise(3, (1, *LATENT)), **kw)
    _levels(got, want)
    # the same request through token ids: the same image, 0 values apart
    l_ids, g_ids, t5_ids = tinf.tokenize(PROMPT)
    nl, ng, nt5 = tinf.tokenize("cats")
    same = tinf.gen_image(l_ids, t5_tokens=t5_ids, neg_clip_tokens=nl,
                          neg_t5_tokens=nt5, clip_g_tokens=g_ids,
                          neg_clip_g_tokens=ng,
                          noise=_jax_noise(3, (1, *LATENT)), **kw)
    np.testing.assert_array_equal(same, got)
    weighted = "a (photo:1.3) of a [cat]"
    want = jinf.gen_image_text(weighted, seed=3, prompt_weighting=True, **kw)
    got = tinf.gen_image_text(weighted, prompt_weighting=True,
                              noise=_jax_noise(3, (1, *LATENT)), **kw)
    _levels(got, want)


def test_batched_text_entry_matches_jax(bundles):
    _, jinf, tinf = bundles
    prompts, seeds = ["a photo of a cat", "cats of a photo"], [11, None]
    kw = dict(width=W, height=H, steps=STEPS)
    want = jinf.gen_images_text(prompts, ["cats", ""], seed=7,
                                per_sample_seeds=seeds, **kw)
    noise = np.stack([_jax_noise(s, LATENT)
                      for s in tpipe.sample_seeds(7, seeds)])
    got = tinf.gen_images_text(prompts, ["cats", ""], noise=noise, **kw)
    _levels(got, want)
    with pytest.raises(ValueError, match="neg_prompts"):
        tinf.gen_images_text(prompts, ["x"], **kw)
    with pytest.raises(ValueError, match="tokenizer"):
        tpipe.SD3Inferencer(tinf.models).tokenize(PROMPT)


# ------------------------------------------------------------------ int8
def test_quantize_int8_end_to_end_matches_jax(bundles):
    """``quantize_int8()`` on both bundles (copies: the fixture's stay
    fp32): the same q / scale bits, then one request's final latents."""
    jmodels, _, _ = bundles
    # JAX's quantize_int8 donates (deletes) the group trees it converts
    jq_models = dataclasses.replace(jmodels, params=jax.tree_util.tree_map(
        jnp.copy, jmodels.params))
    jq_models.quantize_int8()
    tmodels = _port_models(jmodels.params)
    assert tmodels.quantize_int8() is tmodels
    assert tmodels.mmdit.config.int8_mm and tmodels.t5.config.int8_mm
    carried = tpipe.SD3Models.from_jax(
        jq_models.params, device="cpu",
        mmdit_config=tmm.MMDiTConfig(depth=2, pos_embed_max_size=16,
                                     int8_mm=True),
        clip_l_cfg=tte.CLIPTextConfig(**CLIP_L),
        clip_g_cfg=tte.CLIPTextConfig(**CLIP_G),
        t5_config=tte.T5Config(**T5, int8_mm=True))
    for group in ("mmdit", "t5"):
        own = getattr(tmodels, group).state_dict()
        other = getattr(carried, group).state_dict()
        assert set(own) == set(other)
        quant = [k for k in own if k.endswith((".q", ".scale"))]
        assert quant and all(torch.equal(own[k], other[k]) for k in quant)
    assert isinstance(tmodels.mmdit.joint_block0.x_block.mlp_fc2,
                      tq.QuantLinear)
    assert not isinstance(tmodels.mmdit.joint_block0.x_block.adaLN,
                          tq.QuantLinear)
    assert not isinstance(tmodels.clip_l.layer0.attn.qkv, tq.QuantLinear)

    jinf = jpipe.SD3Inferencer(jq_models, shift=3.0, decode_mode="whole")
    tinf = tpipe.SD3Inferencer(tmodels, shift=3.0)
    cond = jinf.get_cond(CLIP_TOKENS, T5_TOKENS)
    neg = jinf.get_cond(np.zeros_like(CLIP_TOKENS), None)
    tcond = tinf.get_cond(CLIP_TOKENS, T5_TOKENS)
    assert _rel_l2(tcond[0].numpy(), cond[0]) <= 2e-3
    # the int8 MMDiT alone: both denoise loops fed JAX's conditioning
    latent = jinf.get_empty_latent(W, H)
    want = jinf.denoise(latent, *cond, *neg, STEPS, 5.0, 6)
    moved = jinf.denoise(latent, cond[0] * np.float32(1 + 1e-6), cond[1],
                         *neg, STEPS, 5.0, 6)
    jitter = _rel_l2(moved, want)
    as_torch = [torch.from_numpy(np.array(a)) for a in (*cond, *neg)]
    got = tinf.denoise(tinf.get_empty_latent(W, H), *as_torch, STEPS, 5.0,
                       noise=_jax_noise(6, (1, *LATENT)))
    assert _rel_l2(got.numpy(), want) <= max(2e-3, 3 * jitter)
    with pytest.raises(ValueError, match="vae_decoder"):
        tmodels.quantize_int8(("vae_decoder",))
    with pytest.raises(ValueError, match="vae_decoder"):
        jq_models.quantize_int8(("vae_decoder",))


# ------------------------------------------------------- free / offload
def test_free_and_offload_text_encoders(bundles):
    jmodels, _, tinf = bundles
    tmodels = _port_models(jmodels.params)
    inf = tpipe.SD3Inferencer(tmodels, shift=3.0)
    assert tmodels.hbm_bytes_live() is None          # a CPU bundle
    noise = _jax_noise(1, (1, *LATENT))
    kept = inf.gen_image(CLIP_TOKENS, noise=noise, **KW)
    gone = weakref.ref(tmodels.t5)
    offloaded = inf.gen_image(CLIP_TOKENS, noise=noise,
                              offload_text_encoders=True, **KW)
    np.testing.assert_array_equal(offloaded, kept)
    assert tmodels.clip_l is None and tmodels.clip_g is None
    assert tmodels.t5 is None and tmodels.freed == {"clip_l", "clip_g",
                                                    "t5"}
    gc.collect()
    assert gone() is None                # nothing else holds the module
    with pytest.raises(ValueError, match="clip_l"):
        inf.get_cond(CLIP_TOKENS, T5_TOKENS)
    with pytest.raises(ValueError, match="freed"):
        inf.gen_image(CLIP_TOKENS, noise=noise, **KW)
    tmodels.quantize_int8()              # a freed T5 is skipped
    assert tmodels.t5 is None and tmodels.mmdit.config.int8_mm
    tmodels.free("vae_encoder")
    with pytest.raises(ValueError, match="encoder"):
        inf.vae_encode(INIT_IMAGE)


def test_inferencer_contract(bundles):
    _, _, tinf = bundles
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh

    # a ring MMDiT and a model axis on one mesh: both switched, each head
    # shard's ring over seq (the JAX parity: tests/test_torch_tp_sp.py)
    mesh = build_mesh({"seq": 2, "model": 2}, ["cpu"] * 4)
    ring = tpipe.SD3Models.initialize(
        torch.Generator().manual_seed(0), "cpu", "fp32", depth=2,
        pos_embed_max_size=8, with_t5=False,
        clip_l_cfg=tte.CLIPTextConfig(**CLIP_L),
        clip_g_cfg=tte.CLIPTextConfig(**CLIP_G))
    ring.mmdit.set_attention("ring", mesh)
    img = tpipe.SD3Inferencer(ring, mesh=mesh).gen_image(
        np.zeros((1, 77), np.int32), width=32, height=32, steps=1)
    blk = ring.mmdit.joint_block0
    assert blk.x_block.tp.n == 2 and blk.mesh is mesh
    assert img.shape == (1, 32, 32, 3)
    with pytest.raises(ValueError, match="decode_mode"):
        tpipe.SD3Inferencer(tinf.models, decode_mode="strips")
    models = tpipe.SD3Models.initialize(
        torch.Generator().manual_seed(0), "cpu", "bf16", depth=1,
        pos_embed_max_size=8, with_t5=False,
        clip_l_cfg=tte.CLIPTextConfig(**CLIP_L),
        clip_g_cfg=tte.CLIPTextConfig(**CLIP_G), int8=True)
    assert models.mmdit.config.int8_mm and models.t5 is None
    qkv = models.mmdit.joint_block0.x_block.qkv
    assert isinstance(qkv, tq.QuantLinear)
    assert qkv.compute_dtype == torch.bfloat16 and qkv.q.dtype == torch.int8
    img = tpipe.SD3Inferencer(models).gen_image(
        np.zeros((1, 77), np.int32), width=32, height=32, steps=1)
    assert img.shape == (1, 32, 32, 3)
