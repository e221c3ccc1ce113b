"""Parity of the port's stage-05 slice with the JAX package's, on the CPU in
fp32: ``CLIP`` (``encode_image``, ``encode_text``, both logits) at a small
config with the JAX parameters carried across, the two losses, an
OpenAI-layout checkpoint read by both ``import_openai_clip``s, three
``CLIPTrainer`` steps against the JAX trainer (optax's AdamW and the
logit-scale clamp), and ``clip_preprocess`` on a synthetic PNG.

Tolerances, fp32: forwards and losses within 1e-5 relative (rtol 1e-5,
atol 1e-5 of the output's largest magnitude); bf16 compute within 5e-2 of
the largest logit; the imported tensors bit for bit; the trainer's
parameters as ``torch_trainer_parity.assert_adamw_close`` (the tolerance
of ``test_slice_adamw_step_and_ema_match_jax``), the loss rtol 1e-5;
``clip_preprocess`` exactly (the same numpy arithmetic on the same PIL
image).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.io import weights as jw
from from_ddpm_to_stable_diffusion_tpu.io import weights_clip as jwc
from from_ddpm_to_stable_diffusion_tpu.models import clip as jclip
from from_ddpm_to_stable_diffusion_tpu.ops import image as jimage
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    clip_trainer as jtrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.io import weights as tw
from from_ddpm_to_stable_diffusion_tpu_torch.io import weights_clip as twc
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    jax_params_from_module, load_jax_params, state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import clip as tclip
from from_ddpm_to_stable_diffusion_tpu_torch.ops import image as timage
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.clip_trainer import (
    MAX_LOGIT_SCALE, CLIPTrainer)
from test_torch_models import jax_random_params
from torch_trainer_parity import (assert_adamw_close, lr_bound,
                                  one_device_mesh, port_flat, port_flat_jax)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

SMALL = dict(embed_dim=16, image_resolution=28, vision_layers=2,
             vision_width=32, vision_patch_size=14, context_length=10,
             vocab_size=50, transformer_width=16, transformer_heads=2,
             transformer_layers=2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(b, seed):
    """(b, 10) ids below 50; row 0 holds its largest id twice, so the EOS
    pooling must take the first maximum."""
    t = np.random.default_rng(seed).integers(1, 40, (b, 10)).astype(np.int32)
    t[:, 6] = 49
    t[0, 8] = 49
    return t


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def small():
    img, txt = _rand((3, 28, 28, 3), 1), _tokens(3, 2)
    jmod = jclip.CLIP(**SMALL)
    params = jax_random_params(jmod, jnp.asarray(img), jnp.asarray(txt),
                               seed=3)
    tmod = load_jax_params(tclip.CLIP(**SMALL), params).eval()
    return dict(img=img, txt=txt, jmod=jmod, params=params, tmod=tmod)


@pytest.mark.parametrize("what", ["encode_image", "encode_text", "logits"])
def test_clip_matches_jax(small, what):
    jmod, params, tmod = small["jmod"], small["params"], small["tmod"]
    img, txt = small["img"], small["txt"]
    with torch.no_grad():
        if what == "logits":
            want = jmod.apply({"params": params}, jnp.asarray(img),
                              jnp.asarray(txt))
            got = tmod(torch.from_numpy(img), torch.from_numpy(txt).long())
            for g, w in zip(got, want):
                assert g.dtype == torch.float32 and g.shape == (3, 3)
                _close(g, w)
            return
        x = img if what == "encode_image" else txt
        want = jmod.apply({"params": params}, jnp.asarray(x),
                          method=getattr(jclip.CLIP, what))
        arg = torch.from_numpy(x)
        got = getattr(tmod, what)(arg if what == "encode_image"
                                  else arg.long())
    assert got.shape == (3, 16)
    _close(got, want)


def test_clip_carries_the_jax_tree_both_ways(small):
    """Every Flax leaf lands on a port parameter of the same name, and
    ``jax_params_from_module`` gives the tree back."""
    tree = jax_params_from_module(small["tmod"])
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in path): v
                      for path, v in jax.tree_util.tree_leaves_with_path(t)}
    want, got = flat(small["params"]), flat(tree)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)


def test_clip_bf16_compute_keeps_fp32_parameters(small):
    img, txt, params = small["img"], small["txt"], small["params"]
    want = jclip.CLIP(**SMALL, dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(img), jnp.asarray(txt))[0]
    tmod = load_jax_params(tclip.CLIP(**SMALL, dtype=torch.bfloat16),
                           params).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(img), torch.from_numpy(txt).long())[0]
    assert got.dtype == torch.float32
    assert {p.dtype for p in tmod.parameters()} == {torch.float32}
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= 5e-2 * np.abs(want).max()


def test_clip_losses_match_jax():
    logits = _rand((5, 5), 4) * 3.0
    want = jclip.clip_contrastive_loss(jnp.asarray(logits))
    _close(tclip.clip_contrastive_loss(torch.from_numpy(logits)), want)
    img, txt = _rand((5, 8), 5), _rand((5, 8), 6)
    want = jclip.siglip_loss(jnp.asarray(img), jnp.asarray(txt), 10.0, -3.0)
    _close(tclip.siglip_loss(torch.from_numpy(img), torch.from_numpy(txt),
                             10.0, -3.0), want)


def openai_state(params, vision_layers=2, text_layers=2):
    """An OpenAI-layout state dict (``in_proj_weight`` names, the
    TorchScript metadata tensors) that the JAX rules map onto ``params``."""
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    state = {}
    for torch_key, flax_path, conv in jwc.openai_clip_rules(vision_layers,
                                                            text_layers):
        a = flat["/".join(p for p in flax_path.split("/") if p)]
        if conv is jw.t_conv:
            a = a.transpose(3, 2, 0, 1)
        elif conv is jw.t_dense:
            a = a.T
        state[torch_key.replace("in_proj.", "in_proj_")] = torch.from_numpy(
            np.array(a, order="C"))
    state.update(input_resolution=torch.tensor(28),
                 context_length=torch.tensor(10), vocab_size=torch.tensor(50))
    return state


def test_openai_checkpoint_through_both_importers(small, tmp_path):
    """One synthetic OpenAI-layout .pt through both importers: the same
    config, the same tensors bit for bit, the same logits through both
    models."""
    path = tmp_path / "clip.pt"
    torch.save(openai_state(small["params"]), path)
    jparams, jcfg = jwc.import_openai_clip(str(path))
    sd, cfg = twc.import_openai_clip(str(path))
    # the heads are sniffed as width // 64, at least 1
    assert cfg == jcfg == dict(SMALL, transformer_heads=1)
    want_sd = state_dict_from_jax(jparams)
    assert set(sd) == set(want_sd)
    for k, w in want_sd.items():
        torch.testing.assert_close(sd[k], w, rtol=0, atol=0, msg=k)
    tmod = tclip.CLIP(**cfg)
    tmod.load_state_dict(sd)
    img, txt = small["img"], small["txt"]
    want = jclip.CLIP(**jcfg).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, jparams)},
        jnp.asarray(img), jnp.asarray(txt))[0]
    with torch.no_grad():
        _close(tmod.eval()(torch.from_numpy(img),
                           torch.from_numpy(txt).long())[0], want)


def test_sniff_and_rules_match_jax():
    assert twc.openai_clip_rules(3, 2) == [
        (t, f, getattr(tw, c.__name__))
        for t, f, c in jwc.openai_clip_rules(3, 2)]
    state = {"a.in_proj_weight": torch.zeros(2), "b.in_proj_bias":
             torch.zeros(1), "c.out_proj.weight": torch.zeros(1)}
    twc.normalize_openai_attn(state)
    assert sorted(state) == ["a.in_proj.weight", "b.in_proj.bias",
                             "c.out_proj.weight"]


# ---------------------------------------------------------- the trainer
STEPS, LR, WD, BATCH = 3, 1e-3, 0.1, 4


def _split_key_bias(params):
    """The key third of each fused qkv bias apart: it adds one constant to
    a query's every logit, which softmax ignores, so its gradient is
    analytically zero and both frameworks return rounding noise there,
    which AdamW turns into ±lr moves."""
    out, dead = {}, {}
    for name, a in params.items():
        if name.endswith("attn.qkv.bias"):
            c = a.shape[0] // 3
            out[name] = np.concatenate([a[:c], a[2 * c:]])
            dead[name] = a[c:2 * c]
        else:
            out[name] = a
    return out, dead


@pytest.fixture(scope="module")
def clip_run():
    """Three steps of each trainer from the same parameters, logit_scale
    started at ln(100) + 0.01 so that the clamp bites."""
    jt = jtrainer.CLIPTrainer(jclip.CLIP(**SMALL), lr=LR, weight_decay=WD,
                              mesh=one_device_mesh())
    jstate = jt.create_state((28, 28, 3), 10)
    params = jax_random_params(jclip.CLIP(**SMALL), jnp.zeros((1, 28, 28, 3)),
                               jnp.zeros((1, 10), jnp.int32), seed=7)
    params["logit_scale"] = np.float32(MAX_LOGIT_SCALE + 0.01)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                            opt_state=jstate.tx.init(params))
    batches = [(_rand((BATCH, 28, 28, 3), 10 + i), _tokens(BATCH, 20 + i))
               for i in range(STEPS)]
    jax_steps = []
    for images, tokens in batches:
        jstate, loss = jt.train_step(jstate, images, tokens)
        mu = jstate.opt_state[0].mu["logit_scale"]
        jax_steps.append(dict(loss=float(loss), mu=float(mu),
                              params=port_flat_jax(jstate.params)))
    trainer = CLIPTrainer(tclip.CLIP(**SMALL), lr=LR, weight_decay=WD,
                          device="cpu")
    state = trainer.create_state((28, 28, 3), 10, params=params)
    port_steps = []
    for images, tokens in batches:
        state, loss = trainer.train_step(state, images, tokens)
        scale = state.model.logit_scale
        port_steps.append(dict(
            loss=loss.item(),
            mu=state.optimizer.state[scale]["exp_avg"].item(),
            params=port_flat(state.params)))
    return dict(jax=jax_steps, port=port_steps, trainer=trainer, state=state,
                batches=batches)


@pytest.mark.parametrize("i", range(STEPS))
def test_clip_train_steps_match_jax(clip_run, i):
    """Loss, the parameters within the AdamW tolerance (the key biases, see
    ``_split_key_bias``, within the bound alone), the clamped logit scale
    and its first Adam moment, which the clamp leaves alone."""
    js, ps = clip_run["jax"][i], clip_run["port"][i]
    np.testing.assert_allclose(ps["loss"], js["loss"], rtol=1e-5)
    bound = lr_bound(lambda count: LR, i + 1)
    (got, got_dead), (want, want_dead) = map(
        _split_key_bias, (ps["params"], js["params"]))
    assert len(got_dead) == SMALL["vision_layers"] + SMALL[
        "transformer_layers"]
    assert_adamw_close(got, want, bound, "params")
    for name, w in want_dead.items():
        assert np.abs(got_dead[name] - w).max() <= bound, name
    assert got["logit_scale"] <= np.float32(MAX_LOGIT_SCALE)
    if i == 0:   # started above the clamp: both sit on it
        assert got["logit_scale"] == want["logit_scale"] == np.float32(
            MAX_LOGIT_SCALE)
        assert ps["mu"] != 0.0
    np.testing.assert_allclose(ps["mu"], js["mu"], rtol=1e-4, atol=1e-7)


def test_clip_trainer_fit_checkpoint_and_signature(clip_run, tmp_path):
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    trainer, state = clip_run["trainer"], clip_run["state"]
    state = trainer.fit(clip_run["batches"][:2], state, epochs=1,
                        image_shape=(28, 28, 3), text_len=10,
                        checkpoint_dir=str(tmp_path))
    assert state.updates == STEPS + 2 and len(trainer.history) == 1
    assert np.isfinite(trainer.history[0]["loss"])
    saved, step = CheckpointManager(str(tmp_path)).restore()
    assert step == 0 and set(saved["params"]) == set(state.trainable())
    # a data mesh (tests/test_torch_data_mesh.py holds its steps)
    meshed = CLIPTrainer(tclip.CLIP(**SMALL), device="cpu", mesh=build_mesh(
        {"data": 2}, [torch.device("cpu")] * 2))
    assert meshed.device == torch.device("cpu") and meshed.data.n == 2
    with pytest.raises(ValueError, match="context_length"):
        trainer.create_state((28, 28, 3), 77)
    # the position table is sized by image_shape, as the JAX tower's is by
    # its first input
    big = trainer.create_state((56, 56, 3), 10)
    assert big.model.visual.positional_embedding.shape == (17, 32)
    assert big.model.logit_scale.item() == pytest.approx(math.log(1 / 0.07))


def test_clip_preprocess_matches_jax(tmp_path):
    from PIL import Image

    path = tmp_path / "img.png"
    Image.fromarray((np.random.default_rng(3).random((40, 57, 3)) * 255)
                    .astype(np.uint8)).save(path)
    assert timage.CLIP_IMAGE_MEAN == jimage.CLIP_IMAGE_MEAN
    assert timage.CLIP_IMAGE_STD == jimage.CLIP_IMAGE_STD
    for res in (28, 224):
        want = jimage.clip_preprocess(Image.open(path), res)
        got = timage.clip_preprocess(Image.open(path), res)
        assert got.shape == (1, res, res, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
