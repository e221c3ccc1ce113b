"""Parity of the port's video-diffusion slice with the JAX package's, on the
CPU in fp32: ``SyntheticVideoDataset``, ``TemporalAttention``,
``TinyVideoUNet`` (base 32, 16², 4 frames), and
``DDPMTrainer(model=TinyVideoUNet, sample_shape=(T, H, W, 3))``: two train
steps and CFG sampling against the JAX trainer fed its own random draws;
then the ``video`` CLI at a tiny size. The attention routes at the video
CLI's operating point are in ``tests/test_torch_k1_sm90.py`` and
``tests/test_torch_bwd_sm90.py``, its GroupNorms in
``tests/test_torch_gn_plan.py``.

Tolerances, fp32: module forwards within 1e-5 relative (rtol 1e-5, atol
1e-5 of the output's largest magnitude: summation order); the loss rtol
1e-5; parameters after AdamW as ``torch_trainer_parity.assert_adamw_close``
(the tolerance of ``test_slice_adamw_step_and_ema_match_jax``); the sampled
clips atol 1e-4. The trainer runs at base 64: at base 32 every GroupNorm
group of a ResBlock holds one channel, so each time projection and conv
bias in front of one has an analytically zero gradient that both
frameworks return as rounding noise, which AdamW turns into ±lr moves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.io import data as jdata
from from_ddpm_to_stable_diffusion_tpu.models import tiny_video_unet as jvid
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    ddpm_trainer as jddpm_trainer)
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu_torch.io import data as tdata
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params)
from from_ddpm_to_stable_diffusion_tpu_torch.models import (
    tiny_video_unet as tvid)
from from_ddpm_to_stable_diffusion_tpu_torch.ops import schedules as tsched
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
    DDPMTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from test_torch_models import jax_random_params
from torch_trainer_parity import (assert_adamw_close, ddpm_draws, lr_bound,
                                  one_device_mesh, port_flat, port_flat_jax)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * np.abs(want).max())


def _forward(jmod, tmod, *inputs, seed=0):
    params = jax_random_params(jmod, *inputs, seed=seed)
    want = jax.jit(jmod.apply)({"params": params},
                               *(jnp.asarray(a) for a in inputs))
    load_jax_params(tmod, params).eval()
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(np.array(a)) for a in inputs))
    return got, want


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("size,frames,seed", [(16, 4, 0), (32, 8, 3),
                                              (8, 8, 1)])
def test_synthetic_video_dataset_matches_jax(size, frames, seed):
    jds = jdata.SyntheticVideoDataset(7, size, frames=frames, seed=seed)
    tds = tdata.SyntheticVideoDataset(7, size, frames=frames, seed=seed)
    assert len(tds) == len(jds) == 7
    assert tds.class_names == jds.class_names
    for i in range(7):
        (jc, jl), (tc, tl) = jds.load(i), tds.load(i)
        assert tc.dtype == np.float32 and tc.shape == (frames, size, size, 3)
        np.testing.assert_array_equal(tc, jc)
        assert tl == jl


def test_video_loader_batches_match_jax():
    jl = jdata.DataLoader(jdata.SyntheticVideoDataset(6, 8, frames=4), 2,
                          prefetch=0, decode_threads=1)
    tl = tdata.DataLoader(tdata.SyntheticVideoDataset(6, 8, frames=4), 2)
    for (jc, jlab), (tc, tlab) in zip(jl, tl):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tlab, jlab)


# -------------------------------------------------------------- modules
@pytest.mark.parametrize("heads", [4, 1])
def test_temporal_attention_matches_jax(heads):
    x = _rand((2, 4, 3, 5, 32), 1)
    got, want = _forward(jvid.TemporalAttention(heads),
                         tvid.TemporalAttention(32, heads), x)
    _close(got.numpy(), want)


def test_tiny_video_unet_matches_jax():
    """Base 32, 16² frames, 4 frames, batch 2 (8 folded frames)."""
    x = _rand((2, 4, 16, 16, 3), 2)
    t = np.asarray([3, 917], np.int32)
    labels = np.asarray([0, 2], np.int32)
    jmod = jvid.TinyVideoUNet(base_channels=32, num_classes=3)
    tmod = tvid.TinyVideoUNet(base_channels=32, num_classes=3)
    got, want = _forward(jmod, tmod, x, t, labels, seed=3)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got.numpy(), want)


def test_tiny_video_unet_bf16_compute_keeps_fp32_parameters():
    """bf16 compute over fp32 parameters, against the JAX module with
    dtype=bf16: within 5e-2 of the output's largest magnitude (bf16
    roundings through ~40 layers)."""
    x = _rand((1, 2, 8, 8, 3), 4)
    t, labels = np.asarray([5], np.int32), np.asarray([1], np.int32)
    jmod = jvid.TinyVideoUNet(base_channels=32, num_classes=3,
                              dtype=jnp.bfloat16)
    tmod = tvid.TinyVideoUNet(base_channels=32, num_classes=3,
                              dtype=torch.bfloat16)
    got, want = _forward(jmod, tmod, x, t, labels, seed=5)
    assert got.dtype == torch.float32
    assert {p.dtype for p in tmod.parameters()} == {torch.float32}
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= 5e-2 * np.abs(want).max()


# ---------------------------------------------------------- the trainer
STEPS, SPE = 2, 1
CFG = dict(epoch=2, batch_size=2, img_size=16, num_class=3, T=10,
           channel=64, dropout=0.0, lr=1e-4, max_lr=1e-3, warmup_epochs=1,
           dtype="fp32", w=1.8, train_rand=0.3, ema_decay=0.9, seed=0)
CLIP = (4, 16, 16, 3)


@pytest.fixture(scope="module")
def video_run():
    """Two steps of the JAX DDPMTrainer over TinyVideoUNet, then the port's
    trainer from the same initial parameters fed the same draws."""
    jcfg = jconfig.TinySDConfig(**CFG)
    jt = jddpm_trainer.DDPMTrainer(
        jcfg, mesh=one_device_mesh(),
        model=jvid.TinyVideoUNet(base_channels=64, num_classes=3),
        sample_shape=CLIP)
    jstate = jt.create_state(steps_per_epoch=SPE)
    params0 = jax.tree_util.tree_map(np.array, jstate.params)
    batches = list(tdata.DataLoader(tdata.SyntheticVideoDataset(
        4, 16, frames=4), 2, shuffle=False))[:STEPS]
    rng = jax.random.key(jcfg.seed + 1)
    jax_steps = []
    for i, (clips, labels) in enumerate(batches):
        draws = ddpm_draws(jcfg, i, labels.shape, clips.shape)
        draws.pop("enc_key")
        jstate, loss = jt.train_step(jstate, clips, labels, rng)
        jax_steps.append(dict(draws, loss=float(loss),
                              params=port_flat_jax(jstate.params),
                              ema=port_flat_jax(jstate.ema_params)))
    trainer = DDPMTrainer(
        tconfig.TinySDConfig(**CFG), device="cpu",
        model=tvid.TinyVideoUNet(base_channels=64, num_classes=3),
        sample_shape=CLIP)
    state = trainer.create_state(SPE, params=params0)
    port_steps = []
    for (clips, labels), js in zip(batches, jax_steps):
        state, loss = trainer.train_step(state, clips, labels,
                                         drop=js["drop"], t=js["t"],
                                         noise=js["noise"])
        port_steps.append(dict(loss=loss.item(),
                               params=port_flat(state.params),
                               ema=port_flat(state.ema_params)))
    return dict(jax=jax_steps, port=port_steps, jt=jt, jstate=jstate,
                trainer=trainer, jcfg=jcfg)


@pytest.mark.parametrize("i", range(STEPS))
def test_video_train_steps_match_jax(video_run, i):
    js, ps = video_run["jax"][i], video_run["port"][i]
    np.testing.assert_allclose(ps["loss"], js["loss"], rtol=1e-5)
    bound = lr_bound(tsched.cosine_warmup_lr(
        CFG["lr"], CFG["max_lr"], CFG["warmup_epochs"], CFG["epoch"], SPE),
        i + 1)
    for key in ("params", "ema"):
        assert_adamw_close(ps[key], js[key], bound, key)


def test_video_sample_matches_jax(video_run):
    """``DDPMTrainer.sample`` of 3 clips over T = 10 CFG steps from the
    JAX state's parameters, fed the JAX sampler's x_T and step noise."""
    jt, jstate, jcfg = video_run["jt"], video_run["jstate"], video_run["jcfg"]
    labels = [1, 2, 3]
    want = np.asarray(jt.sample(jstate, labels))
    noise_key, samp_key = jax.random.split(jax.random.key(jcfg.seed + 2))
    x_T = np.array(jax.random.normal(noise_key, (3,) + CLIP))
    steps = [np.array(jax.random.normal(jax.random.fold_in(samp_key, s),
                                        (3,) + CLIP))
             for s in range(jcfg.T)]
    trainer = video_run["trainer"]
    state = trainer.create_state(SPE, params=jax.tree_util.tree_map(
        np.array, jstate.params))
    got = trainer.sample(state, labels, noise=x_T, step_noise=steps)
    assert got.shape == (3,) + CLIP and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    drawn = trainer.sample(state, labels)
    assert drawn.shape == got.shape and bool(torch.isfinite(drawn).all())
    assert drawn.abs().max() <= 1.0


# ------------------------------------------------------------------ CLI
def test_video_cli_trains_and_writes_the_clip_grid(tmp_path, capsys):
    """``video train`` at a tiny size on the CPU: one epoch of 2 steps, 3
    sampled clips over T = 3, the (class rows × frame columns) PNG."""
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import video

    out = tmp_path / "grid.png"
    assert video.main(["train", "--epochs", "1", "--clips", "4",
                       "--img-size", "8", "--frames", "2", "--batch-size",
                       "2", "--channel", "32", "--T", "3", "--dtype", "fp32",
                       "--out", str(out), "--device", "cpu"]) == 0
    assert "cols: 2 frames" in capsys.readouterr().out
    from PIL import Image

    with Image.open(out) as im:
        grid = np.asarray(im)
    assert grid.shape == (3 * 8, 2 * 8, 3) and grid.std() > 0
