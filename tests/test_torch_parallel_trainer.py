"""The parallel slice as a whole against the JAX package, on the CPU: one
``MMDiTTrainer`` step of the ring and of the Ulysses MMDiT on a
{"data": 2, "seq": 4} mesh (the JAX test ``test_sp_training_step``'s
configuration), and one MoE step with the balance-loss term on a
{"data": 2, "expert": 4} mesh, each against the JAX trainer's step from the
same parameters, the port fed the JAX step's own draws.

The JAX trainer runs on its 8 virtual CPU devices; the port on a one-process
mesh of the host device repeated, so the batch stays one tensor. Tolerances
as ``tests/test_torch_mmdit_trainer.py``: the loss rtol 1e-5; parameters
after AdamW within 1e-5 but for at most 1 element in 10⁴, none further than
2·lr (``torch_trainer_parity.assert_adamw_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh as jmesh
from from_ddpm_to_stable_diffusion_tpu.parallel import replicate as jreplicate
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    mmdit_trainer as jtrainer)
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
    MMDiTTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from torch_trainer_parity import (assert_adamw_close, lr_bound, mmdit_draws,
                                  port_flat, port_flat_jax)

MODEL = dict(patch_size=2, in_channels=4, adm_in_channels=8, context_dim=16,
             pos_embed_max_size=8)
TRAIN = dict(epoch=1, img_size=8, context_len=4, lr=1e-4, max_lr=1e-3,
             warmup_epochs=1, train_rand=0.1, sample_steps=3, w=2.0,
             dtype="fp32", seed=0)


def _batch(b):
    r = np.random.default_rng(0)
    return (r.normal(size=(b, 8, 8, 4)).astype(np.float32),
            r.normal(size=(b, 4, 16)).astype(np.float32),
            r.normal(size=(b, 8)).astype(np.float32))


def _one_step(model, train, jax_shape, port_shape, devices8):
    """(JAX loss, JAX params, port trainer, port state, port loss)."""
    latents, ctx, y = _batch(train["batch_size"])
    n = int(np.prod(list(jax_shape.values())))
    jcfg = jconfig.FlowTrainConfig(**TRAIN, batch_size=train["batch_size"])
    mesh = jmesh(jax_shape, devices8[:n])
    jt = jtrainer.MMDiTTrainer(jmm.MMDiTConfig(**MODEL, **model), jcfg,
                               mesh=mesh)
    params = jax_random_params(jmm.MMDiT(jmm.MMDiTConfig(**MODEL, **model)),
                               latents[:1], np.zeros((1,), np.float32),
                               y[:1], ctx[:1], seed=7)
    state = jt.create_state(steps_per_epoch=2)
    # on the mesh: uncommitted one-device parameters fed to the SP step give
    # the JAX trainer another loss than its own forward computes
    state = state.replace(params=jreplicate(
        mesh, jax.tree_util.tree_map(jnp.array, params)))
    draws = mmdit_draws(jcfg, 0, latents.shape)
    state, jloss = jt.train_step(state, latents, ctx, y,
                                 jax.random.key(jcfg.seed + 1))
    m = int(np.prod(list(port_shape.values())))
    trainer = MMDiTTrainer(
        tmm.MMDiTConfig(**MODEL, **model),
        tconfig.FlowTrainConfig(**TRAIN, batch_size=train["batch_size"]),
        device="cpu", mesh=build_mesh(port_shape, ["cpu"] * m))
    tstate = trainer.create_state(steps_per_epoch=2, params=params)
    tstate, loss = trainer.train_step(tstate, latents, ctx, y, **draws)
    return float(jloss), port_flat_jax(state.params), trainer, tstate, \
        loss.item()


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp_train_step_matches_jax(devices8, impl):
    # joint sequence 4 + 16 = 20 over seq 4; heads = depth = 4 for Ulysses
    jloss, want, trainer, tstate, loss = _one_step(
        dict(depth=4, attention_impl=impl), dict(batch_size=2),
        {"data": 2, "seq": 4}, {"data": 2, "seq": 4}, devices8)
    blk = tstate.model.joint_block0
    assert blk.seq_impl == impl and blk.mesh.shape == {"data": 2, "seq": 4}
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert_adamw_close(port_flat(tstate.params), want,
                       lr_bound(tstate.schedule, 1), f"{impl} params")
    # sampling runs through the same sequence-parallel model
    _, ctx, y = _batch(2)
    out = trainer.sample(tstate, ctx, y, steps=2)
    assert out.shape == (2, 8, 8, 4) and bool(out.isfinite().all())


def test_moe_train_step_with_aux_matches_jax(devices8):
    jloss, want, trainer, tstate, loss = _one_step(
        dict(depth=2, moe_experts=4), dict(batch_size=8), {"data": 1},
        {"data": 2, "expert": 4}, devices8)
    assert tstate.model.joint_block0.x_block.moe_mesh.shape == {
        "data": 2, "expert": 4}
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert_adamw_close(port_flat(tstate.params), want,
                       lr_bound(tstate.schedule, 1), "moe params")
    # the balance term is in the loss: without it the loss is lower
    latents, ctx, y = _batch(8)
    draws = mmdit_draws(trainer.cfg, 0, latents.shape)
    with torch.no_grad():
        with_aux = trainer.loss(tstate, latents, ctx, y, **draws)
        trainer.cfg.moe_aux_weight = 0.0
        without = trainer.loss(tstate, latents, ctx, y, **draws)
    assert with_aux.item() > without.item()


def test_trainer_mesh_options():
    mc = tmm.MMDiTConfig(**MODEL, depth=2)
    cfg = tconfig.FlowTrainConfig(**TRAIN, batch_size=8)
    hybrid = MMDiTTrainer(mc, cfg, device="cpu", mesh=build_mesh(
        {"data": 2, "model": 2}, ["cpu"] * 4))
    assert hybrid.create_state(2).model.joint_block1.x_block.tp.n == 2
    # cfg.mesh_shape over the visible devices of the trainer's kind: the
    # JAX error where they are too few
    with pytest.raises(ValueError, match="!= 1 devices"):
        MMDiTTrainer(mc, tconfig.FlowTrainConfig(
            **TRAIN, batch_size=8, mesh_shape={"data": 8}), device="cpu")
    t = MMDiTTrainer(mc, tconfig.FlowTrainConfig(
        **TRAIN, batch_size=8, mesh_shape={"data": 1}), device="cpu")
    assert t.mesh.shape == {"data": 1} and t.model_mesh is None
