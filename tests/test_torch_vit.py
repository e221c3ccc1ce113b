"""Parity of the port's stage-04 ViT slice with the JAX package's, on the
CPU in fp32: ``ViTTrainConfig``, ``ViTBlock`` and ``ViT`` (32², patch 8,
depth 2) logits and ``return_features``, and ``ViTTrainer``'s
``train_step`` (two steps) and ``evaluate`` against the JAX trainer, with
dropout 0 (its draws cannot be the JAX step's); then ``fit``, the random
init, and the stage-04 operating point's attention (plain).

Tolerances, fp32: forwards within 1e-5 relative (rtol 1e-5, atol 1e-5 of
the output's largest magnitude); bf16 compute within 5e-2 of the largest
logit; the loss and accuracy rtol 1e-5; parameters after AdamW as
``torch_trainer_parity.assert_adamw_close``, the tolerance of
``test_slice_adamw_step_and_ema_match_jax``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.io import data as jdata
from from_ddpm_to_stable_diffusion_tpu.models import vit as jvit
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    vit_trainer as jvit_trainer)
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.io import data as tdata
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params)
from from_ddpm_to_stable_diffusion_tpu_torch.models import vit as tvit
from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as tattn
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vit_trainer import (
    ViTTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from test_torch_models import jax_random_params
from torch_trainer_parity import (assert_adamw_close, lr_bound,
                                  one_device_mesh, port_flat, port_flat_jax)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

SMALL = dict(image_size=32, patch_size=8, num_classes=3, dim=64, depth=2,
             heads=4, mlp_dim=128, dropout=0.0, emb_dropout=0.0)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rel,
                               atol=rel * np.abs(want).max())


def test_vit_train_config_matches_jax(tmp_path):
    jf = [f.name for f in dataclasses.fields(jconfig.ViTTrainConfig)]
    assert [f.name for f in dataclasses.fields(tconfig.ViTTrainConfig)] == jf
    assert (dataclasses.asdict(tconfig.ViTTrainConfig())
            == dataclasses.asdict(jconfig.ViTTrainConfig()))
    path = tmp_path / "vit.yml"
    path.write_text("epoch: 2\npatch_size: 16\ndim: 256\n")
    assert (dataclasses.asdict(tconfig.ViTTrainConfig.from_yaml(str(path)))
            == dataclasses.asdict(jconfig.ViTTrainConfig.from_yaml(
                str(path))))


def test_vit_block_matches_jax():
    x = _rand((2, 17, 64), 1)
    jmod = jvit.ViTBlock(4, 128)
    params = jax_random_params(jmod, x, seed=2)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = load_jax_params(tvit.ViTBlock(64, 4, 128), params).eval()
    with torch.no_grad():
        _close(tmod(torch.from_numpy(x)), want)


@pytest.mark.parametrize("features", [False, True])
def test_vit_matches_jax(features):
    """Logits, or the post-``ln_final`` class token in fp32."""
    x = _rand((3, 32, 32, 3), 3)
    jmod = jvit.ViT(**SMALL)
    params = jax_random_params(jmod, x, seed=4)
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      return_features=features)
    tmod = load_jax_params(tvit.ViT(**SMALL), params).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), return_features=features)
    assert got.dtype == torch.float32
    assert got.shape == ((3, 64) if features else (3, 3))
    _close(got, want)


def test_vit_bf16_compute_keeps_fp32_parameters():
    x = _rand((2, 32, 32, 3), 5)
    params = jax_random_params(jvit.ViT(**SMALL), x, seed=6)
    want = np.asarray(jvit.ViT(**SMALL, dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x)), np.float32)
    tmod = load_jax_params(tvit.ViT(**SMALL, dtype=torch.bfloat16),
                           params).eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert {p.dtype for p in tmod.parameters()} == {torch.float32}
    assert np.abs(got.numpy() - want).max() <= 5e-2 * np.abs(want).max()


# ---------------------------------------------------------- the trainer
STEPS = 2
TRAIN = dict(epoch=1, batch_size=6, img_size=32, patch_size=8, dim=64,
             depth=2, heads=4, mlp_dim=128, num_class=3, dropout=0.0,
             emb_dropout=0.0, lr=1e-3, dtype="fp32", seed=0)


@pytest.fixture(scope="module")
def vit_run():
    jcfg = jconfig.ViTTrainConfig(**TRAIN)
    jt = jvit_trainer.ViTTrainer(jcfg, mesh=one_device_mesh())
    jstate = jt.create_state()
    params0 = jax.tree_util.tree_map(np.array, jstate.params)
    batches = list(tdata.DataLoader(tdata.SyntheticImageDataset(
        12, 32, num_classes=3), 6, shuffle=False))
    rng = jax.random.key(jcfg.seed + 1)
    jax_steps = []
    for images, labels in batches[:STEPS]:
        jstate, loss, acc = jt.train_step(jstate, images, labels, rng)
        jax_steps.append(dict(loss=float(loss), acc=float(acc),
                              params=port_flat_jax(jstate.params)))
    val = jdata.DataLoader(jdata.SyntheticImageDataset(
        8, 32, num_classes=3, seed=1), 4, shuffle=False, prefetch=0,
        decode_threads=1)
    jax_acc = jt.evaluate(jstate, val)
    trainer = ViTTrainer(tconfig.ViTTrainConfig(**TRAIN), device="cpu")
    state = trainer.create_state(params=params0)
    port_steps = []
    for images, labels in batches[:STEPS]:
        state, loss, acc = trainer.train_step(state, images, labels)
        port_steps.append(dict(loss=loss.item(), acc=acc.item(),
                               params=port_flat(state.params)))
    return dict(jax=jax_steps, port=port_steps, jax_acc=jax_acc,
                trainer=trainer, state=state, jt=jt, jstate=jstate)


def _split_key_bias(params, dim=TRAIN["dim"]):
    """The key third of each fused qkv bias apart: it adds one constant to
    a query's every logit, which softmax ignores, so its gradient is
    analytically zero and both frameworks return rounding noise there,
    which AdamW turns into ±lr moves."""
    out, dead = {}, {}
    for name, a in params.items():
        if name.endswith("attn.qkv.bias"):
            out[name] = np.concatenate([a[:dim], a[2 * dim:]])
            dead[name] = a[dim:2 * dim]
        else:
            out[name] = a
    return out, dead


@pytest.mark.parametrize("i", range(STEPS))
def test_vit_train_steps_match_jax(vit_run, i):
    """Loss, accuracy, and the parameters within the AdamW tolerance; the
    key biases (see ``_split_key_bias``) within the bound alone."""
    js, ps = vit_run["jax"][i], vit_run["port"][i]
    np.testing.assert_allclose(ps["loss"], js["loss"], rtol=1e-5)
    assert ps["acc"] == pytest.approx(js["acc"])
    bound = lr_bound(lambda count: TRAIN["lr"], i + 1)
    (got, got_dead), (want, want_dead) = map(
        _split_key_bias, (ps["params"], js["params"]))
    assert len(got_dead) == TRAIN["depth"]
    assert_adamw_close(got, want, bound, "params")
    for name, w in want_dead.items():
        assert np.abs(got_dead[name] - w).max() <= bound, name


def test_vit_evaluate_matches_jax(vit_run):
    """``evaluate`` from the JAX state's parameters on the same loader."""
    trainer = vit_run["trainer"]
    state = trainer.create_state(params=jax.tree_util.tree_map(
        np.array, vit_run["jstate"].params))
    val = tdata.DataLoader(tdata.SyntheticImageDataset(
        8, 32, num_classes=3, seed=1), 4, shuffle=False)
    got = trainer.evaluate(state, val)
    assert got == pytest.approx(vit_run["jax_acc"])
    assert 0.0 <= got <= 1.0 and not state.model.training


def test_vit_trainer_fit_and_checkpoint(vit_run, tmp_path):
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    trainer, state = vit_run["trainer"], vit_run["state"]
    train = tdata.DataLoader(tdata.SyntheticImageDataset(12, 32), 6)
    val = tdata.DataLoader(tdata.SyntheticImageDataset(8, 32, seed=1), 4,
                           shuffle=False)
    state = trainer.fit(train, val, state, epochs=1,
                        checkpoint_dir=str(tmp_path))
    assert state.updates == STEPS + 2 and len(trainer.history) == 1
    assert 0.0 <= trainer.history[0]["val_acc"] <= 1.0
    saved, step = CheckpointManager(str(tmp_path)).restore()
    assert step == 0 and set(saved["params"]) == set(state.params)


def test_vit_trainer_random_init_and_mesh():
    """Flax's initializers: normal(0.02) class token and positions, seeded;
    a data mesh is taken (tests/test_torch_data_mesh.py holds its steps)."""
    cfg = tconfig.ViTTrainConfig(**TRAIN)
    a = ViTTrainer(cfg, device="cpu").create_state()
    b = ViTTrainer(cfg, device="cpu").create_state()
    for (n, p), (_, q) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(p, q), n
    for t in (a.model.cls_token, a.model.pos_embed):
        assert 0.01 < float(t.detach().std()) < 0.03
    meshed = ViTTrainer(cfg, device="cuda", mesh=build_mesh(
        {"data": 2}, [torch.device("cpu")] * 2))
    assert meshed.device == torch.device("cpu") and meshed.data.n == 2
    state = meshed.create_state()
    assert all(b.data_axis is meshed.data for b in state.model.modules()
               if hasattr(b, "data_axis"))


def test_vit_stage04_attention_is_plain():
    """At 128² with patch 32 the blocks attend over 17 tokens: below the
    flash kernels' 512 on the card too."""
    model = tvit.ViT()
    n = (128 // 32) ** 2 + 1
    assert model.pos_embed.shape == (1, n, 512)
    q = types.SimpleNamespace(is_cuda=True, shape=(256, 8, n, 64))
    assert not tattn._flash_eligible(q, q)


def test_vit_cli_trains_on_synthetic_images(tmp_path):
    """``vit train --synthetic`` at 32², patch 8, batch 4, one epoch on the
    CPU, with its checkpoint."""
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import vit

    assert vit.main(["train", "--synthetic", "--img-size", "32",
                     "--patch-size", "8", "--batch-size", "4", "--epochs",
                     "1", "--model-dir", str(tmp_path), "--device",
                     "cpu"]) == 0
    assert (tmp_path / "0" / "state.pt").is_file()
