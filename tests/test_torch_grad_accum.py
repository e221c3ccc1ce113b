"""Gradient accumulation of the port's trainers against the JAX trainers
(``optax.MultiSteps`` over clip + AdamW, the EMA advanced only when the
window emits), on the CPU in fp32.

``DDPMTrainer`` at the small tiny-SD config of ``test_torch_tiny_sd.py``
(``TinyUNet`` base 64, 16², batch 2) and ``MMDiTTrainer`` at the small
MMDiT of ``test_torch_mmdit_trainer.py``, each with ``grad_accum=2`` for 4
micro-steps (2 updates) from the same parameters, the JAX trainer on a
one-device mesh and the port fed the JAX step's own draws. With 2 batches
an epoch the schedule runs over one update an epoch, so the second update
is at the cosine's peak, 10 × the first: an LR counted by micro-steps
would fail the parameter comparison.

Tolerances: losses 1e-5 relative; parameters and EMA as
``test_slice_adamw_step_and_ema_match_jax`` (within 1e-5 but for 1 element
in 10⁴, none further than 2·lr per update made); the micro-steps that do
not emit leave the port's parameters, EMA and moments bit-identical.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    ddpm_trainer as jddpm_trainer)
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    mmdit_trainer as jmmdit_trainer)
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu_torch.io import data as tdata
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.ops import schedules as tsched
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
    DDPMTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
    MMDiTTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from test_torch_mmdit_trainer import MODEL, TRAIN, _params
from torch_trainer_parity import (assert_adamw_close, ddpm_draws, lr_bound,
                                  mmdit_draws, one_device_mesh, port_flat,
                                  port_flat_jax)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

ACCUM, SPE, MICRO = 2, 2, 4
CFG = dict(epoch=3, batch_size=2, img_size=16, num_class=3, T=4, channel=64,
           channel_multy=[1, 2, 2, 2], dropout=0.0, dtype="fp32",
           lr=1e-4, max_lr=1e-3, warmup_epochs=1, train_rand=0.5, w=1.8,
           ema_decay=0.9, seed=0, grad_accum=ACCUM)


def _port_step(state):
    return dict(params=port_flat(state.params),
                ema=port_flat(state.ema_params),
                moments={i: {k: v.clone() for k, v in s.items()} for i, s
                         in enumerate(state.optimizer.state.values())},
                step=state.step, updates=state.updates,
                mini=state.mini_step)


@pytest.fixture(scope="module")
def ddpm_run():
    jcfg = jconfig.TinySDConfig(**CFG)
    jt = jddpm_trainer.DDPMTrainer(jcfg, mesh=one_device_mesh())
    jstate = jt.create_state(steps_per_epoch=SPE)
    params0 = jax.tree_util.tree_map(np.array, jstate.params)
    batches = list(tdata.DataLoader(tdata.SyntheticImageDataset(8, 16), 2,
                                    shuffle=False))[:MICRO]
    rng = jax.random.key(jcfg.seed + 1)
    jax_steps = []
    for i, (images, labels) in enumerate(batches):
        draws = ddpm_draws(jcfg, i, labels.shape, images.shape)
        jstate, loss = jt.train_step(jstate, images, labels, rng)
        jax_steps.append(dict(
            draws, loss=float(loss),
            params=port_flat_jax(jstate.params),
            ema=port_flat_jax(jstate.ema_params)))
    trainer = DDPMTrainer(tconfig.TinySDConfig(**CFG), device="cpu")
    state = trainer.create_state(SPE, params=params0)
    port_steps = [_port_step(state)]
    losses = []
    for (images, labels), js in zip(batches, jax_steps):
        state, loss = trainer.train_step(state, images, labels,
                                         drop=js["drop"], t=js["t"],
                                         noise=js["noise"])
        losses.append(loss.item())
        port_steps.append(_port_step(state))
    return dict(jax=jax_steps, port=port_steps, losses=losses,
                trainer=trainer, state=state)


def _schedule(cfg, steps_per_update):
    return tsched.cosine_warmup_lr(cfg["lr"], cfg["max_lr"],
                                   cfg["warmup_epochs"], cfg["epoch"],
                                   steps_per_update)


@pytest.mark.parametrize("i", range(MICRO))
def test_ddpm_accum_loss_matches_jax(ddpm_run, i):
    np.testing.assert_allclose(ddpm_run["losses"][i],
                               ddpm_run["jax"][i]["loss"], rtol=1e-5)


@pytest.mark.parametrize("i", range(MICRO))
def test_ddpm_accum_params_and_ema_match_jax(ddpm_run, i):
    ps = ddpm_run["port"][i + 1]
    bound = lr_bound(_schedule(CFG, SPE // ACCUM), ps["updates"])
    for key in ("params", "ema"):
        assert_adamw_close(ps[key], ddpm_run["jax"][i][key], bound, key)


@pytest.mark.parametrize("run", ["ddpm_run", "mmdit_run"])
def test_non_emitting_micro_steps_hold_the_state_bit_for_bit(run, request):
    """Micro-steps 1 and 3 fold their gradient into the window's mean and
    touch nothing else; micro-steps 2 and 4 update every parameter, the
    EMA and the moments."""
    steps = request.getfixturevalue(run)["port"]
    assert [(s["step"], s["updates"], s["mini"]) for s in steps] == [
        (0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1), (4, 2, 0)]
    for i in range(1, MICRO + 1):
        before, after = steps[i - 1], steps[i]
        same = [all(np.array_equal(before[k][n], after[k][n])
                    for n in after[k]) for k in ("params", "ema")]
        a, b = before["moments"], after["moments"]
        same.append(a.keys() == b.keys() and all(
            a[j].keys() == b[j].keys() and all(torch.equal(a[j][k], b[j][k])
                                               for k in a[j]) for j in a))
        emits = i % ACCUM == 0
        assert same == [not emits] * 3, i
        if emits:
            moved = [n for n in after["params"]
                     if not np.array_equal(before["params"][n],
                                           after["params"][n])]
            assert len(moved) > 0.9 * len(after["params"])


def test_lr_schedule_counts_updates(ddpm_run):
    """The rate runs over steps_per_epoch // grad_accum updates an epoch and
    follows the update count, not the micro-steps."""
    state = ddpm_run["state"]
    want, per_micro = _schedule(CFG, SPE // ACCUM), _schedule(CFG, SPE)
    assert [state.schedule(c) for c in range(6)] == [want(c) for c in
                                                    range(6)]
    assert want(1) == CFG["max_lr"] and per_micro(1) == CFG["lr"]
    assert [g["lr"] for g in state.optimizer.param_groups] == [want(1)]


# ------------------------------------------------------------------ MMDiT
def _mmdit_batch(i, b=8):
    r = np.random.default_rng(100 + i)
    return (r.normal(size=(b, 8, 8, 4)).astype(np.float32),
            r.normal(size=(b, 4, 16)).astype(np.float32),
            r.normal(size=(b, 8)).astype(np.float32))


@pytest.fixture(scope="module")
def mmdit_run():
    train = dict(TRAIN, grad_accum=ACCUM)
    jcfg = jconfig.FlowTrainConfig(**train, dtype="fp32")
    jt = jmmdit_trainer.MMDiTTrainer(jmm.MMDiTConfig(**MODEL), jcfg,
                                     mesh=one_device_mesh())
    params = _params()
    as_jax = lambda: jax.tree_util.tree_map(jax.numpy.array, params)
    jstate = jt.create_state(steps_per_epoch=SPE)
    jstate = jstate.replace(params=as_jax(), ema_params=as_jax())
    rng = jax.random.key(jcfg.seed + 1)
    batches = [_mmdit_batch(i) for i in range(MICRO)]
    jax_steps = []
    for i, batch in enumerate(batches):
        draws = mmdit_draws(jcfg, i, batch[0].shape)
        jstate, loss = jt.train_step(jstate, *batch, rng)
        jax_steps.append(dict(draws, loss=float(loss),
                              params=port_flat_jax(jstate.params),
                              ema=port_flat_jax(jstate.ema_params)))
    trainer = MMDiTTrainer(tmm.MMDiTConfig(**MODEL),
                           tconfig.FlowTrainConfig(**train, dtype="fp32"),
                           device="cpu")
    state = trainer.create_state(SPE, params=params)
    port_steps, losses = [_port_step(state)], []
    for batch, js in zip(batches, jax_steps):
        state, loss = trainer.train_step(state, *batch, t_lin=js["t_lin"],
                                         noise=js["noise"], drop=js["drop"])
        losses.append(loss.item())
        port_steps.append(_port_step(state))
    return dict(jax=jax_steps, port=port_steps, losses=losses, train=train)


@pytest.mark.parametrize("i", range(MICRO))
def test_mmdit_accum_matches_jax(mmdit_run, i):
    np.testing.assert_allclose(mmdit_run["losses"][i],
                               mmdit_run["jax"][i]["loss"], rtol=1e-5)
    ps = mmdit_run["port"][i + 1]
    bound = lr_bound(_schedule(mmdit_run["train"], SPE // ACCUM),
                     ps["updates"])
    for key in ("params", "ema"):
        assert_adamw_close(ps[key], mmdit_run["jax"][i][key], bound, key)


def test_accumulator_is_the_window_mean(ddpm_run):
    """After one micro-step the fp32 buffer holds that step's gradient; the
    config's dataclass keeps the JAX field."""
    trainer = ddpm_run["trainer"]
    state = trainer.create_state(SPE)
    images, labels = next(iter(tdata.DataLoader(
        tdata.SyntheticImageDataset(2, 16), 2, shuffle=False)))
    state, _ = trainer.train_step(state, images, labels)
    assert all(a.dtype == torch.float32 for a in state.acc_grads)
    for acc, p in zip(state.acc_grads, state.trainable().values()):
        assert torch.equal(acc, p.grad)
    assert dataclasses.asdict(trainer.cfg)["grad_accum"] == ACCUM


def test_trainers_take_every_jax_option():
    """The port's trainers (the VAE and ViT ones too) and their ``fit``
    take the JAX trainers' arguments, in order, plus ``device`` (and, for
    the TinyVLM, the model's own arguments in place of the Flax module)."""
    import inspect

    from from_ddpm_to_stable_diffusion_tpu.pipelines import (
        vlm_trainer as jvlm_trainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import (
        vlm_trainer as tvlm_trainer)

    def names(fn, drop=()):
        return [n for n in inspect.signature(fn).parameters if n not in drop]

    from from_ddpm_to_stable_diffusion_tpu.pipelines import (
        vae_trainer as jvae_trainer, vit_trainer as jvit_trainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import (
        vae_trainer as tvae_trainer, vit_trainer as tvit_trainer)

    for port, jax_cls in ((DDPMTrainer, jddpm_trainer.DDPMTrainer),
                          (MMDiTTrainer, jmmdit_trainer.MMDiTTrainer),
                          (tvae_trainer.VAETrainer, jvae_trainer.VAETrainer),
                          (tvit_trainer.ViTTrainer, jvit_trainer.ViTTrainer)):
        assert names(port.__init__, {"device"}) == names(jax_cls.__init__)
        assert names(port.fit) == names(jax_cls.fit)
    port = tvlm_trainer.VLMTrainer
    jax_names = names(jvlm_trainer.VLMTrainer.__init__, {"model"})
    assert [n for n in names(port.__init__) if n in jax_names] == jax_names
    assert names(port.fit) == names(jvlm_trainer.VLMTrainer.fit)
