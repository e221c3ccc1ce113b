"""Parity of the port's tiny-SD training slice with the JAX package's, on
the CPU in fp32: schedules, config, synthetic data, the tiny-SD layers, and
a small ``TinyUNet`` (base 64, [1,2,2,2], 16², batch 2, dropout 0) through
the forward, ``ddpm_loss``, every gradient, two clipped AdamW steps with the
warmup-cosine rate, the EMA, and a 4-step CFG ``ddpm_sample``.

Random numbers cannot match across frameworks, so the JAX draws (the
``fold_in``/``split`` keys of the JAX train step, ``ddpm_loss``'s t and
noise, the sampler's ``fold_in(rng, step)`` noise) are made with JAX and fed
to the port. Parameters come from ``test_torch_models.jax_random_params``.

Tolerances, all fp32: modules atol = rtol = 1e-4 (summation order);
gradients atol 1e-4 relative to the largest gradient of the tensor (a
backward sums over the batch and all pixels, so absolute errors scale with
the gradient); parameters after AdamW atol 1e-5 but for at most 1 element
in 10⁴ (see the test); the sampled images atol 1e-4.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from from_ddpm_to_stable_diffusion_tpu.io import data as jdata
from from_ddpm_to_stable_diffusion_tpu.models import layers as jl
from from_ddpm_to_stable_diffusion_tpu.models.tiny_unet import (
    TinyUNet as JTinyUNet)
from from_ddpm_to_stable_diffusion_tpu.ops import embeddings as jemb
from from_ddpm_to_stable_diffusion_tpu.ops import schedules as jsched
from from_ddpm_to_stable_diffusion_tpu.samplers import ddpm as jddpm
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu_torch.io import data as tdata
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params, state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import layers as tl
from from_ddpm_to_stable_diffusion_tpu_torch.models.tiny_unet import TinyUNet
from from_ddpm_to_stable_diffusion_tpu_torch.ops import embeddings as temb
from from_ddpm_to_stable_diffusion_tpu_torch.ops import schedules as tsched
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
    DDPMTrainer, clip_by_global_norm_)
from from_ddpm_to_stable_diffusion_tpu_torch.samplers import ddpm as tddpm
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

ATOL = RTOL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _compare(jmod, tmod, *inputs, atol=ATOL, rtol=RTOL, seed=0):
    params = jax_random_params(jmod, *inputs, seed=seed)
    want = jax.jit(jmod.apply)({"params": params},
                               *(jnp.asarray(a) for a in inputs))
    load_jax_params(tmod, params).eval()
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(np.array(a)) for a in inputs))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)
    return got


# ------------------------------------------------- schedules, embeddings
@pytest.mark.parametrize("T", [4, 1000])
def test_ddpm_tables_match_jax(T):
    want = jsched.ddpm_tables(0.0015, 0.0195, T)
    got = tsched.ddpm_tables(0.0015, 0.0195, T)
    for f in dataclasses.fields(want):
        a, w = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == np.float32 and a.shape == (T,), f.name
        np.testing.assert_array_equal(a, w, err_msg=f.name)


@pytest.mark.parametrize("warmup,total,spe", [(7, 70, 25), (1, 3, 1),
                                              (0, 5, 2)])
def test_cosine_warmup_lr_matches_jax(warmup, total, spe):
    """fp32 on the JAX side, float64 in the port: rtol 1e-6, and atol
    1e-6·max_lr where the cosine nears 0 (fp32 cos rounds relative to 1)."""
    want = jsched.cosine_warmup_lr(2e-6, 1e-4, warmup, total, spe)
    got = tsched.cosine_warmup_lr(2e-6, 1e-4, warmup, total, spe)
    for count in [0, 1, spe - 1, spe, 3 * spe + 1, warmup * spe,
                  (total - 1) * spe, total * spe + 5]:
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-10, err_msg=str(count))
    assert got(0) == (2e-6 if warmup else 1e-4)


def test_timestep_embedding_matches_jax():
    t = np.asarray([999, 500, 3, 0], np.int32)
    for dim in (256, 7):
        want = np.asarray(jemb.timestep_embedding(jnp.asarray(t), dim))
        got = temb.timestep_embedding(torch.from_numpy(t), dim)
        assert got.dtype == torch.float32 and got.shape == (4, dim)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ------------------------------------------------------ config and data
def test_tiny_sd_config_matches_jax():
    jf = {f.name: f for f in dataclasses.fields(jconfig.TinySDConfig)}
    tf = {f.name: f for f in dataclasses.fields(tconfig.TinySDConfig)}
    assert list(tf) == list(jf)
    assert tconfig.TinySDConfig().to_dict() == jconfig.TinySDConfig().to_dict()
    raw = {"epoch": 3, "channel_multy": [1, 2], "T": 10}
    assert (tconfig.TinySDConfig.from_dict(raw).to_dict()
            == jconfig.TinySDConfig.from_dict(raw).to_dict())
    with pytest.raises(ValueError, match="unknown config keys"):
        tconfig.TinySDConfig.from_dict({"epochs": 3})


def test_tiny_sd_config_from_yaml(tmp_path):
    path = tmp_path / "tiny.yml"
    path.write_text("epoch: 5\nbatch_size: 8\nchannel_multy: [1, 2]\n")
    assert (tconfig.TinySDConfig.from_yaml(str(path)).to_dict()
            == jconfig.TinySDConfig.from_yaml(str(path)).to_dict())


def test_synthetic_dataset_matches_jax():
    jds, tds = (m.SyntheticImageDataset(7, 8, seed=3) for m in (jdata, tdata))
    assert len(tds) == len(jds) == 7
    for i in (0, 4, 6):
        (ja, jlab), (ta, tlab) = jds.load(i), tds.load(i)
        np.testing.assert_array_equal(ta, ja)
        assert tlab == jlab and ta.dtype == np.float32


@pytest.mark.parametrize("n,bs,shuffle", [(11, 4, True), (8, 4, False)])
def test_data_loader_matches_jax(n, bs, shuffle):
    """Same batches in the same order, two epochs, remainder dropped."""
    jl_ = jdata.DataLoader(jdata.SyntheticImageDataset(n, 4), bs, seed=5,
                           shuffle=shuffle, prefetch=0, decode_threads=1)
    tl_ = tdata.DataLoader(tdata.SyntheticImageDataset(n, 4), bs, seed=5,
                           shuffle=shuffle)
    assert len(tl_) == len(jl_) == n // bs
    for _ in range(2):
        jb, tb = list(jl_), list(tl_)
        assert len(tb) == len(jb) == n // bs
        for (ji, jlab), (ti, tlab) in zip(jb, tb):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tlab, jlab)
            assert tlab.dtype == np.int32


# ---------------------------------------------------------------- layers
def test_resblock_with_skip_matches_jax():
    x, t = _rand((2, 8, 8, 64), 1), _rand((2, 128), 2)
    _compare(jl.ResBlock(96, dropout=0.5),
             tl.ResBlock(64, 96, 128, dropout=0.5), x, t)


def test_timestep_embedder_matches_jax():
    t = np.asarray([0, 17, 999], np.int32)
    _compare(jl.TimestepEmbedder(64), tl.TimestepEmbedder(64), t)


def test_label_embedder_matches_jax_and_nulls_label_zero():
    labels = np.asarray([0, 1, 3, 0], np.int32)
    got = _compare(jl.LabelEmbedder(3, 32, 64), tl.LabelEmbedder(3, 32, 64),
                   labels)
    np.testing.assert_array_equal(got[0].numpy(), got[3].numpy())
    mod = tl.LabelEmbedder(3, 32, 64)
    with torch.no_grad():
        mod.table.weight.normal_()
        null = mod.fc2(torch.nn.functional.silu(mod.fc1.bias))
        np.testing.assert_allclose(mod(torch.tensor([0]))[0].numpy(),
                                   null.numpy(), atol=1e-6)


def test_transformer_block_derived_heads_and_2d_context():
    """256 channels -> 2 heads of 128; the label context is one 2-D token."""
    x, ctx = _rand((2, 4, 4, 256), 3), _rand((2, 64), 4)
    tmod = tl.TransformerBlock(256, 64)
    assert tmod.attn1.num_heads == tmod.attn2.num_heads == 2
    _compare(jl.TransformerBlock(), tmod, x, ctx)


@pytest.mark.parametrize("size", [16, 15])
def test_stride2_same_conv_matches_flax(size):
    """Flax pads a stride-2 3×3 'SAME' conv (0, 1) on an even size; the
    symmetric padding=1 of nn.Conv2d gives other numbers."""
    x = _rand((2, size, size, 4), 5)
    jmod = nn.Conv(8, (3, 3), strides=2)
    got = _compare(jmod, tl.Conv2d(4, 8, 3, stride=2, same=True), x)
    assert got.shape == (2, -(-size // 2), -(-size // 2), 8)
    sym = tl.Conv2d(4, 8, 3, stride=2, padding=1)
    sym.load_state_dict(state_dict_from_jax(
        jax_random_params(jmod, x, seed=0)))
    with torch.no_grad():
        off = (sym(torch.from_numpy(x)) - got).abs().max().item()
    assert (off > 1e-2) == (size % 2 == 0)


def test_compute_dtype_keeps_fp32_parameters():
    """bf16 compute over fp32 parameters (Flax dtype=bf16): the output is
    bf16 and equals the JAX module's to bf16 rounding (rtol = atol =
    1.6e-2, two bf16 ulps at |y| < 1)."""
    t = np.asarray([0, 17, 999], np.int32)
    tmod = tl.TimestepEmbedder(64, compute_dtype=torch.bfloat16)
    got = _compare(jl.TimestepEmbedder(64, dtype=jnp.bfloat16), tmod, t,
                   atol=1.6e-2, rtol=1.6e-2)
    assert got.dtype == torch.bfloat16
    assert {p.dtype for p in tmod.parameters()} == {torch.float32}


# --------------------------------------------------- the slice as a whole
# base 64: two channels per GroupNorm group. At base 32 each group is one
# channel, so every bias and time projection in front of a norm has a zero
# gradient and both frameworks return rounding noise there.
CFG = dict(epoch=3, batch_size=2, img_size=16, num_class=3, T=4, channel=64,
           channel_multy=[1, 2, 2, 2], dropout=0.0, dtype="fp32",
           lr=1e-4, max_lr=1e-3, warmup_epochs=1, train_rand=0.5, w=1.8,
           ema_decay=0.9, seed=0)
STEPS = 2   # steps_per_epoch 1: update 0 at base_lr, update 1 in the cosine


@pytest.fixture(scope="module")
def slice_run():
    """The JAX train step of pipelines/ddpm_trainer.py (keys, label drop,
    ddpm_loss, clip + AdamW, EMA) for two updates from seeded parameters,
    and the port's trainer fed the same draws."""
    cfg = jconfig.TinySDConfig(**CFG)
    model = JTinyUNet(out_channels=3, base_channels=64,
                      channel_mult=(1, 2, 2, 2), num_classes=3, dropout=0.0)
    images, labels = next(iter(jdata.DataLoader(
        jdata.SyntheticImageDataset(2, 16), 2, prefetch=0)))
    params = jax_random_params(model, images, labels, labels, seed=7)
    tables = jsched.ddpm_tables(cfg.beta_1, cfg.beta_T, cfg.T)
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip), optax.adamw(
        jsched.cosine_warmup_lr(cfg.lr, cfg.max_lr, cfg.warmup_epochs,
                                cfg.epoch, 1)))
    bs, d = cfg.batch_size, cfg.ema_decay

    @jax.jit
    def step(params, opt_state, ema, rng, count):
        rng = jax.random.fold_in(rng, count)
        drop_key, loss_key, dropout_key, _ = jax.random.split(rng, 4)
        drop = jax.random.uniform(drop_key, labels.shape) < cfg.train_rand
        y = jnp.where(drop, 0, labels + 1)
        t_key, n_key = jax.random.split(loss_key)   # ddpm_loss's draws
        t = jax.random.randint(t_key, (bs,), 0, cfg.T)
        noise = jax.random.normal(n_key, images.shape, jnp.float32)

        def loss_fn(p):
            preds = []

            def apply(x, t_, y_):
                preds.append(model.apply({"params": p}, x, t_, y_,
                                         deterministic=False,
                                         rngs={"dropout": dropout_key}))
                return preds[-1]

            el = jddpm.ddpm_loss(apply, tables, images, y, loss_key, cfg.T)
            return el.sum() / (bs * bs), preds[0]

        (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: d * e + (1.0 - d) * p,
                                     ema, params)
        return params, opt_state, ema, dict(
            loss=loss, pred=pred, grads=grads, drop=drop, t=t, noise=noise)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state, ema, rng = tx.init(jp), jp, jax.random.key(cfg.seed + 1)
    jax_steps = []
    for count in range(STEPS):
        jp, opt_state, ema, out = step(jp, opt_state, ema, rng, count)
        jax_steps.append(jax.tree_util.tree_map(np.array,
                                                dict(out, params=jp, ema=ema)))

    trainer = DDPMTrainer(tconfig.TinySDConfig(**CFG), device="cpu")
    state = trainer.create_state(steps_per_epoch=1, params=params)
    port_steps = []
    for js in jax_steps:
        model_t = state.model
        x_t = tddpm.q_sample(trainer.tables, torch.from_numpy(images),
                             torch.from_numpy(js["t"]),
                             torch.from_numpy(js["noise"]))
        y = torch.from_numpy(np.where(js["drop"], 0, labels + 1))
        model_t.zero_grad()
        pred = model_t(x_t, torch.from_numpy(js["t"]), y)
        ((pred - torch.from_numpy(js["noise"])) ** 2).sum().div(
            bs * bs).backward()
        grads = {n: p.grad.numpy().copy()
                 for n, p in model_t.named_parameters()}
        state, loss = trainer.train_step(state, images, labels,
                                         drop=js["drop"], t=js["t"],
                                         noise=js["noise"])
        port_steps.append(dict(
            loss=loss.item(), pred=pred.detach().numpy(), grads=grads,
            params={n: p.detach().numpy().copy()
                    for n, p in state.params.items()},
            ema={n: e.numpy().copy() for n, e in state.ema_params.items()}))
    return dict(params=params, model=model, trainer=trainer, state=state,
                jax=jax_steps, port=port_steps, images=images)


def _flat(tree):
    return state_dict_from_jax(tree)


@pytest.mark.parametrize("i", range(STEPS))
def test_slice_forward_and_loss_match_jax(slice_run, i):
    js, ps = slice_run["jax"][i], slice_run["port"][i]
    np.testing.assert_allclose(ps["pred"], js["pred"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ps["loss"], js["loss"], rtol=1e-5)


@pytest.mark.parametrize("i", range(STEPS))
def test_slice_gradients_match_jax(slice_run, i):
    want = _flat(slice_run["jax"][i]["grads"])
    got = slice_run["port"][i]["grads"]
    assert set(got) == set(want)
    # cross-attention over one label token: softmax ≡ 1, so attn2.q,
    # attn2.k and the norm2 feeding them get exactly zero gradient in both
    # (and the label embedding too when every label of the batch dropped)
    dead = {n for n in got if re.search(r"_att\.(attn2\.[qk]|norm2)\.", n)}
    zero = {n for n, g in got.items() if not g.any()}
    assert len(dead) == 4 * 10 and dead <= zero
    assert zero == {n for n, w in want.items() if not w.numpy().any()}
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name], w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max() + 1e-10,
                                   err_msg=name)


@pytest.mark.parametrize("i", range(STEPS))
def test_slice_adamw_step_and_ema_match_jax(slice_run, i):
    """AdamW moves an element by lr·m̂/(√v̂+ε), at most lr per update, and
    for a gradient within rounding noise of 0 that quotient is itself
    noise. So: every element within 1e-5 but for at most 1 in 10⁴, and
    none further than the sum of 2·lr over the updates made."""
    cfg = tconfig.TinySDConfig(**CFG)
    lr = tsched.cosine_warmup_lr(cfg.lr, cfg.max_lr, cfg.warmup_epochs,
                                 cfg.epoch, 1)
    bound = sum(2 * lr(c) for c in range(i + 1)) + 1e-6
    for key in ("params", "ema"):
        want = _flat(slice_run["jax"][i][key])
        got = slice_run["port"][i][key]
        assert set(got) == set(want)
        off = total = 0
        for name, w in want.items():
            diff = np.abs(got[name] - w.numpy())
            assert diff.max() <= bound, f"{key} {name}: {diff.max()}"
            off += int((diff > 1e-5 + 1e-5 * np.abs(w.numpy())).sum())
            total += diff.size
        assert off <= 1e-4 * total, f"{key}: {off} of {total} elements off"
    moved = max(np.abs(slice_run["port"][i]["params"][n]
                       - _flat(slice_run["params"])[n].numpy()).max()
                for n in slice_run["port"][i]["params"])
    assert moved > 1e-5


def test_ddpm_sample_matches_jax(slice_run):
    """4 CFG ancestral steps from the same x_T with JAX's per-step noise."""
    cfg = jconfig.TinySDConfig(**CFG)
    model, params = slice_run["model"], slice_run["params"]
    tables = jsched.ddpm_tables(cfg.beta_1, cfg.beta_T, cfg.T)
    x_T = _rand((2, 16, 16, 3), 11)
    labels = np.asarray([1, 3], np.int32)
    rng = jax.random.key(5)
    want = jax.jit(lambda p, x: jddpm.ddpm_sample(
        lambda a, t, y: model.apply({"params": p}, a, t, y), tables, x,
        jnp.asarray(labels), rng, cfg.T, w=cfg.w))(params, jnp.asarray(x_T))
    noise = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(rng, s), x_T.shape))) for s in range(cfg.T)]
    tmod = load_jax_params(TinyUNet(base_channels=64, num_classes=3),
                           params).eval()
    with torch.no_grad():
        got = tddpm.ddpm_sample(tmod, tsched.ddpm_tables(
            cfg.beta_1, cfg.beta_T, cfg.T), torch.from_numpy(x_T),
            torch.from_numpy(labels).long(), cfg.T, w=cfg.w,
            noise_fn=noise.__getitem__)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_ddpm_sample_two_forward_cfg_matches_jax(slice_run):
    """``batched_cfg=False``: cond then uncond as two batch-B forwards, in
    both packages, from the same x_T with JAX's per-step noise; and within
    1e-5 of the port's batch-2B form, as the JAX test holds its two."""
    cfg = jconfig.TinySDConfig(**CFG)
    model, params = slice_run["model"], slice_run["params"]
    tables = jsched.ddpm_tables(cfg.beta_1, cfg.beta_T, cfg.T)
    x_T = _rand((2, 16, 16, 3), 12)
    labels = np.asarray([2, 0], np.int32)
    rng = jax.random.key(6)
    want = jax.jit(lambda p, x: jddpm.ddpm_sample(
        lambda a, t, y: model.apply({"params": p}, a, t, y), tables, x,
        jnp.asarray(labels), rng, cfg.T, w=cfg.w, batched_cfg=False))(
            params, jnp.asarray(x_T))
    noise = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(rng, s), x_T.shape))) for s in range(cfg.T)]
    tmod = load_jax_params(TinyUNet(base_channels=64, num_classes=3),
                           params).eval()
    calls = []
    model_fn = lambda a, t, y: calls.append(a.shape[0]) or tmod(a, t, y)
    run = lambda batched: tddpm.ddpm_sample(
        model_fn, tsched.ddpm_tables(cfg.beta_1, cfg.beta_T, cfg.T),
        torch.from_numpy(x_T), torch.from_numpy(labels).long(), cfg.T,
        w=cfg.w, noise_fn=noise.__getitem__, batched_cfg=batched)
    with torch.no_grad():
        got = run(False)
        assert calls == [2] * (2 * cfg.T)
        batched = run(True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), batched.numpy(), atol=1e-5)


def test_trainer_sample_and_fit_run(slice_run):
    trainer, state = slice_run["trainer"], slice_run["state"]
    for use_ema in (False, True):
        out = trainer.sample(state, [1, 2, 3], use_ema=use_ema)
        assert out.shape == (3, 16, 16, 3) and out.dtype == torch.float32
        assert bool(torch.isfinite(out).all()) and out.abs().max() <= 1
    assert state.model.training is False
    before = {n: p.detach().clone() for n, p in state.params.items()}
    loader = tdata.DataLoader(tdata.SyntheticImageDataset(4, 16), 2)
    state = trainer.fit(loader, state, epochs=1)
    assert state.step == STEPS + 2 and len(trainer.history) == 1
    assert np.isfinite(trainer.history[0]["loss"])
    assert any(not torch.equal(before[n], p) for n, p in
               state.params.items())


def test_clip_by_global_norm_matches_optax():
    grads = [_rand((3, 4), 20, 2.0), _rand((5,), 21)]
    for max_norm in (0.5, 100.0):
        want = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)[0]
        got = [torch.from_numpy(g.copy()) for g in grads]
        norm = clip_by_global_norm_(got, max_norm)
        np.testing.assert_allclose(norm.item(), np.sqrt(
            sum((g.astype(np.float64) ** 2).sum() for g in grads)), rtol=1e-6)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6)


def test_trainer_refuses_unported_options():
    """The mesh options are ported: ``config.mesh_shape`` builds its mesh
    over the visible devices of the trainer's kind and raises the JAX
    mesh-shape error where they are too few; ``mesh=`` and ``fsdp=True``
    are accepted (their steps: ``tests/test_torch_fsdp.py``), and so is
    ``grad_accum``."""
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh

    with pytest.raises(ValueError, match=r"mesh shape \{'data': 8\} != 1 "
                       "devices"):
        DDPMTrainer(tconfig.TinySDConfig(mesh_shape={"data": 8}),
                    device="cpu")
    t = DDPMTrainer(tconfig.TinySDConfig(mesh_shape={"data": 1}),
                    device="cpu")
    assert t.mesh.shape == {"data": 1}
    mesh = build_mesh({"data": 2}, ["cpu"] * 2)
    for kw in (dict(mesh=mesh), dict(mesh=mesh, fsdp=True), dict(fsdp=True)):
        t = DDPMTrainer(tconfig.TinySDConfig(), device="cpu", **kw)
        assert t.fsdp == kw.get("fsdp", False) and t.mesh is kw.get("mesh")
    DDPMTrainer(tconfig.TinySDConfig(grad_accum=2), device="cpu")
