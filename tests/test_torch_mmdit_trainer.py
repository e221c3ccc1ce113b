"""Parity of the port's rectified-flow MMDiT training slice with the JAX
package's ``MMDiTTrainer``, on the CPU: configs and dtype policies, the
MMDiT forward under bf16 compute over fp32 parameters, three train steps
(loss, updated parameters, EMA) in fp32 and in bf16, CFG flow-Euler
sampling, and the parameter tree both ways.

The model is the small one of ``tests/test_mmdit_trainer.py`` (depth 2,
hidden 128, 2 heads of 64, 4×4 = 16 latent tokens, 4 context tokens, batch
8). Random numbers cannot match across frameworks, so the draws of the JAX
train step (``fold_in(rng, step)`` then ``split`` into t, noise and drop
keys) and of ``sample`` are made with JAX and fed to the port. Parameters
are numpy draws loaded into both.

Tolerances. fp32: loss rtol 1e-5; parameters after AdamW within 1e-5 but
for at most 1 element in 10⁴, none further than 2·lr per update (see the
test); the sampled latents atol 1e-4. bf16 compute: the forward to 3e-2 of
the output's largest magnitude (every linear rounds its output to bf16, 8
significant bits, through two blocks); the loss rtol 2e-2; parameters: the
mean absolute difference below a tenth of the mean absolute movement (Adam
turns a gradient's sign into a step of about lr, so an element whose
gradient is bf16 rounding noise may step the other way).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.ops import schedules as jsched
from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    mmdit_trainer as jtrainer)
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu.utils import dtypes as jdtypes
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    jax_params_from_module, load_jax_params, state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.ops import schedules as tsched
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
    MMDiTTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from from_ddpm_to_stable_diffusion_tpu_torch.utils import dtypes as tdtypes
from test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

MODEL = dict(patch_size=2, in_channels=4, depth=2, adm_in_channels=8,
             context_dim=16, pos_embed_max_size=8)
TRAIN = dict(epoch=2, batch_size=8, img_size=8, context_len=4, lr=1e-4,
             max_lr=1e-3, warmup_epochs=1, train_rand=0.3, sample_steps=3,
             w=2.0, seed=0, ema_decay=0.9)
STEPS = 3   # steps_per_epoch 2: update 0 at lr, 1 in the warmup, 2 past it
# the ROADMAP.md queue item an unported option names (A3 trainer features,
# A8 the parallel package)
QUEUE_ITEM = r"ROADMAP\.md, queue items? A[38]"


def _batch(b=8):
    r = np.random.default_rng(0)
    return (r.normal(size=(b, 8, 8, 4)).astype(np.float32),
            r.normal(size=(b, 4, 16)).astype(np.float32),
            r.normal(size=(b, 8)).astype(np.float32))


def _params(seed=7):
    """A numpy parameter tree of the small MMDiT with every leaf non-zero
    (Flax's own init leaves biases and the position table at zero)."""
    x, ctx, y = _batch(1)
    return jax_random_params(jmm.MMDiT(jmm.MMDiTConfig(**MODEL)), x,
                             np.zeros((1,), np.float32), y, ctx, seed=seed)


# ----------------------------------------------------- configs and policies
def test_flow_train_config_matches_jax(tmp_path):
    jf = [f.name for f in dataclasses.fields(jconfig.FlowTrainConfig)]
    tf = [f.name for f in dataclasses.fields(tconfig.FlowTrainConfig)]
    assert tf == jf
    assert (dataclasses.asdict(tconfig.FlowTrainConfig())
            == dataclasses.asdict(jconfig.FlowTrainConfig()))
    path = tmp_path / "flow.yml"
    path.write_text("epoch: 3\nimg_size: 128\nema_decay: 0.999\n")
    assert (dataclasses.asdict(tconfig.FlowTrainConfig.from_yaml(str(path)))
            == dataclasses.asdict(jconfig.FlowTrainConfig.from_yaml(
                str(path))))


def test_dtype_policies_match_jax():
    assert list(tdtypes.POLICIES) == list(jdtypes.POLICIES)
    for name, want in jdtypes.POLICIES.items():
        got = tdtypes.POLICIES[name]
        assert got.name == want.name == name
        for field in ("param_dtype", "compute_dtype"):
            assert (str(getattr(got, field)).split(".")[-1]
                    == jnp.dtype(getattr(want, field)).name)


@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_sigma_of_t_is_the_inference_schedule(shift):
    """Training's σ(t) at t = timestep / 1000 equals the σ table the
    flow-Euler sampler walks, in both packages."""
    cfg = tconfig.FlowTrainConfig(**TRAIN, shift=shift)
    trainer = MMDiTTrainer(tmm.MMDiTConfig(**MODEL), cfg, device="cpu")
    ts = np.arange(1, 1001, dtype=np.float64)
    got = trainer._sigma_of_t(torch.from_numpy(ts / 1000.0)).numpy()
    np.testing.assert_allclose(got, tsched.flow_sigma(ts, shift), rtol=1e-12)
    np.testing.assert_allclose(
        got, np.asarray(jsched.flow_sigma(ts, shift), np.float64), rtol=1e-6)
    sig = tsched.sd3_sigma_schedule(5, shift)
    np.testing.assert_allclose(sig[0], got[-1], rtol=1e-12)


# ------------------------------------------- the forward under bf16 compute
@pytest.mark.parametrize("qk_norm", [None, "rms"])
def test_mmdit_bf16_compute_over_fp32_params_matches_jax(qk_norm):
    cfg = dict(MODEL, qk_norm=qk_norm)
    x, ctx, y = _batch(2)
    t = np.asarray([17.0, 903.5], np.float32)
    jmod = jmm.MMDiT(jmm.MMDiTConfig(**cfg), dtype=jnp.bfloat16)
    params = jax_random_params(jmod, x, t, y, ctx, seed=3)
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, x, t, y, ctx))
    tmod = load_jax_params(tmm.MMDiT(tmm.MMDiTConfig(**cfg),
                                     compute_dtype=torch.bfloat16), params)
    assert {p.dtype for p in tmod.parameters()} == {torch.float32}
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, (x, t, y, ctx)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
    # and it is the bf16 computation, not the fp32 one
    fp32 = load_jax_params(tmm.MMDiT(tmm.MMDiTConfig(**cfg)), params)
    with torch.no_grad():
        exact = fp32(*map(torch.from_numpy, (x, t, y, ctx)))
    assert (got - exact).abs().max() > 1e-4


# --------------------------------------------------- the slice as a whole
def _run(dtype):
    """STEPS updates of the JAX trainer from seeded parameters, and the
    port's trainer fed the same parameters and the same draws."""
    latents, ctx, y = _batch()
    params = _params()
    jcfg = jconfig.FlowTrainConfig(**TRAIN, dtype=dtype)
    jt = jtrainer.MMDiTTrainer(jmm.MMDiTConfig(**MODEL), jcfg,
                               mesh=build_mesh({"data": 1}, jax.devices()[:1]))
    state = jt.create_state(steps_per_epoch=2)
    as_jax = lambda: jax.tree_util.tree_map(jnp.array, params)
    state = state.replace(params=as_jax(), ema_params=as_jax())
    rng = jax.random.key(11)
    jax_steps = []
    for step in range(STEPS):
        t_key, n_key, drop_key = jax.random.split(
            jax.random.fold_in(rng, step), 3)
        draws = dict(
            t_lin=np.array(jax.nn.sigmoid(jax.random.normal(t_key, (8,)))),
            noise=np.array(jax.random.normal(n_key, latents.shape)),
            drop=np.array(jax.random.uniform(drop_key, (8,))
                          < jcfg.train_rand))
        state, loss = jt.train_step(state, latents, ctx, y, rng)
        jax_steps.append(dict(
            draws, loss=float(loss),
            params=jax.tree_util.tree_map(np.array, state.params),
            ema=jax.tree_util.tree_map(np.array, state.ema_params)))

    trainer = MMDiTTrainer(tmm.MMDiTConfig(**MODEL),
                           tconfig.FlowTrainConfig(**TRAIN, dtype=dtype),
                           device="cpu")
    tstate = trainer.create_state(steps_per_epoch=2, params=params)
    port_steps = []
    for js in jax_steps:
        tstate, loss = trainer.train_step(
            tstate, latents, ctx, y, t_lin=js["t_lin"], noise=js["noise"],
            drop=js["drop"])
        port_steps.append(dict(
            loss=loss.item(),
            params={n: p.detach().numpy().copy()
                    for n, p in tstate.params.items()},
            ema={n: e.numpy().copy() for n, e in tstate.ema_params.items()}))
    return dict(params=params, jax=jax_steps, port=port_steps,
                jax_trainer=jt, jax_state=state, trainer=trainer,
                state=tstate)


@pytest.fixture(scope="module")
def run_fp32():
    return _run("fp32")


@pytest.fixture(scope="module")
def run_bf16():
    return _run("bf16")


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(tree).items()}


def _lr_bound(i):
    lr = tsched.cosine_warmup_lr(TRAIN["lr"], TRAIN["max_lr"],
                                 TRAIN["warmup_epochs"], TRAIN["epoch"], 2)
    return sum(2 * lr(c) for c in range(i + 1)) + 1e-6


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_loss_matches_jax(run_fp32, i):
    assert any(s["drop"].any() for s in run_fp32["jax"])
    np.testing.assert_allclose(run_fp32["port"][i]["loss"],
                               run_fp32["jax"][i]["loss"], rtol=1e-5)


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_params_and_ema_match_jax(run_fp32, i):
    """AdamW moves an element by lr·m̂/(√v̂+ε), at most lr per update, and
    for a gradient within rounding noise of 0 that quotient is itself
    noise. So: every element within 1e-5 but for at most 1 in 10⁴, and none
    further than the sum of 2·lr over the updates made."""
    start = _flat(run_fp32["params"])
    for key in ("params", "ema"):
        want, got = _flat(run_fp32["jax"][i][key]), run_fp32["port"][i][key]
        assert set(got) == set(want)
        off = total = 0
        for name, w in want.items():
            diff = np.abs(got[name] - w)
            assert diff.max() <= _lr_bound(i), f"{key} {name}: {diff.max()}"
            off += int((diff > 1e-5 + 1e-5 * np.abs(w)).sum())
            total += diff.size
        assert off <= 1e-4 * total, f"{key}: {off} of {total} elements off"
    moved = [np.abs(run_fp32["port"][i]["params"][n] - start[n]).max()
             for n in start]
    assert min(moved) > 1e-6 and max(moved) > 5e-5   # every tensor trains


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_bf16_compute_matches_jax(run_bf16, i):
    """bf16 compute over fp32 parameters (the JAX ``POLICIES["bf16"]``)."""
    js, ps = run_bf16["jax"][i], run_bf16["port"][i]
    np.testing.assert_allclose(ps["loss"], js["loss"], rtol=2e-2)
    start = _flat(run_bf16["params"])
    for key in ("params", "ema"):
        want, got = _flat(js[key]), ps[key]
        diff = moved = size = 0.0
        for name, w in want.items():
            assert got[name].dtype == np.float32
            d = np.abs(got[name] - w)
            assert d.max() <= _lr_bound(i), f"{key} {name}: {d.max()}"
            diff += d.sum()
            moved += np.abs(w - start[name]).sum()
            size += d.size
        assert moved / size > 1e-6
        assert diff <= 0.1 * moved, f"{key}: {diff / size} vs {moved / size}"


def test_bf16_and_fp32_runs_differ(run_fp32, run_bf16):
    assert run_fp32["port"][0]["loss"] != run_bf16["port"][0]["loss"]
    assert {p.dtype for p in run_bf16["state"].model.parameters()} == {
        torch.float32}
    assert run_bf16["state"].model.compute_dtype == torch.bfloat16
    assert run_fp32["state"].model.compute_dtype is None


@pytest.mark.parametrize("use_ema", [False, True])
def test_sample_matches_jax(run_fp32, use_ema):
    """CFG flow-Euler over 3 steps from the trained states, the same
    initial noise: cond and zeroed uncond as one batch-2B forward."""
    _, ctx, y = _batch(2)
    rng = jax.random.key(5)
    want = np.asarray(run_fp32["jax_trainer"].sample(
        run_fp32["jax_state"], jnp.asarray(ctx), jnp.asarray(y), rng=rng,
        use_ema=use_ema))
    noise = np.array(jax.random.normal(rng, (2, 8, 8, 4)))
    got = run_fp32["trainer"].sample(run_fp32["state"], ctx, y,
                                     use_ema=use_ema, noise=noise)
    assert got.shape == (2, 8, 8, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert run_fp32["state"].model.training is False


def test_sample_draws_its_own_noise_and_checks_shapes(run_fp32):
    trainer, state = run_fp32["trainer"], run_fp32["state"]
    _, ctx, y = _batch(3)
    a = trainer.sample(state, ctx, y, steps=2)
    b = trainer.sample(state, ctx, y, steps=2)
    assert a.shape == (3, 8, 8, 4) and bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, b, rtol=0, atol=0)   # seeded: seed + 2
    with pytest.raises(ValueError):
        trainer.sample(state, ctx, y, noise=np.zeros((3, 4, 4, 4)))


# ------------------------------------------------- the tree, both ways
def test_param_tree_round_trip_and_jax_runs_the_ported_weights(run_fp32):
    """Port → Flax tree is the inverse of Flax tree → port, for the
    parameters and for the EMA; the JAX model gives the port's output on
    the port's trained weights."""
    model, params = run_fp32["state"].model, run_fp32["params"]
    fresh = load_jax_params(tmm.MMDiT(tmm.MMDiTConfig(**MODEL)), params)
    back = jax_params_from_module(fresh)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, w) in zip(got, want):
        np.testing.assert_array_equal(a, w)
    ema_tree = jax_params_from_module(model, run_fp32["state"].ema_params)
    for (_, a), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(ema_tree),
            jax.tree_util.tree_leaves_with_path(run_fp32["jax"][-1]["ema"])):
        np.testing.assert_allclose(a, w, atol=1e-4)
    with pytest.raises(ValueError):
        jax_params_from_module(model, {"pos_embed": model.pos_embed})
    x, ctx, y = _batch(2)
    t = np.asarray([100.0, 700.0], np.float32)
    trained = jax_params_from_module(model)
    want_out = jmm.MMDiT(jmm.MMDiTConfig(**MODEL)).apply(
        {"params": trained}, x, t, y, ctx)
    with torch.no_grad():
        got_out = model.eval()(*map(torch.from_numpy, (x, t, y, ctx)))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-4, rtol=1e-4)


# -------------------------------------------------------- entry points
def test_trainer_defaults_to_the_card_and_seeds_its_state():
    default = inspect.signature(MMDiTTrainer.__init__).parameters["device"]
    assert str(default.default) == "cuda"
    cfg = tconfig.FlowTrainConfig(**TRAIN, dtype="fp32")
    a, b = (MMDiTTrainer(tmm.MMDiTConfig(**MODEL), cfg,
                         device="cpu").create_state(2) for _ in range(2))
    assert a.ema_params is not None and a.step == 0
    for (n, p), (_, q) in zip(a.params.items(), b.params.items()):
        assert p.device.type == "cpu" and p.dtype == torch.float32
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    trainer = MMDiTTrainer(tmm.MMDiTConfig(**MODEL), cfg, device="cpu")
    assert trainer.num_params(a) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(_params()))
    # Flax's defaults: zero biases and position table, lecun-normal kernels
    assert not a.params["pos_embed"].any()
    assert not a.params["joint_block0.x_block.qkv.bias"].any()
    w = a.params["joint_block0.x_block.qkv.weight"]
    np.testing.assert_allclose(w.std().item(), 128 ** -0.5, rtol=0.05)


def test_fit_trains_a_fixed_batch_and_logs():
    """Memorising one batch: the velocity loss falls (as
    tests/test_mmdit_trainer.py asks of the JAX trainer)."""
    cfg = tconfig.FlowTrainConfig(**dict(TRAIN, epoch=5, max_lr=3e-3,
                                         train_rand=0.1), dtype="fp32")
    trainer = MMDiTTrainer(tmm.MMDiTConfig(**MODEL), cfg, device="cpu")
    state = trainer.fit([_batch()] * 8)
    assert state.step == 40 and len(trainer.history) == 5
    losses = [rec["loss"] for rec in trainer.history]
    assert np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0]
    assert all(rec["imgs_per_sec"] > 0 for rec in trainer.history)


class _Recorder:
    """A logger that keeps each event's name and its keys."""

    def __init__(self):
        self.events = []

    def log(self, event, **metrics):
        self.events.append((event, list(metrics)))


def test_fit_logs_the_jax_epoch_keys(run_fp32):
    """The ``epoch`` event carries what the JAX trainer logs (``epoch``,
    ``loss``, ``sec``); ``imgs_per_sec`` stays in the port's history."""
    batch = _batch()
    jt = run_fp32["jax_trainer"]
    jt.logger = _Recorder()
    # train_step donates its state: fit a copy
    jt.fit([batch], state=jax.tree_util.tree_map(jnp.copy,
                                                 run_fp32["jax_state"]),
           epochs=1)
    trainer = MMDiTTrainer(tmm.MMDiTConfig(**MODEL),
                           tconfig.FlowTrainConfig(**TRAIN, dtype="fp32"),
                           device="cpu", logger=_Recorder())
    trainer.fit([batch], epochs=1)
    assert trainer.logger.events == jt.logger.events == [
        ("epoch", ["epoch", "loss", "sec"])]
    assert set(trainer.history[0]) == {"epoch", "loss", "sec",
                                       "imgs_per_sec"}


def test_trainer_refuses_unported_options():
    """FSDP and a tensor-parallel ``model`` mesh axis are ported and
    accepted (their steps: ``tests/test_torch_fsdp.py``); a ``model`` axis
    with ring or Ulysses attention is accepted, the blocks tensor-parallel
    and on the mesh's ``seq`` axis both (its steps:
    ``tests/test_torch_tp_sp.py``); the data / seq / expert meshes, ring and
    Ulysses attention, MoE, LoRA, ``grad_accum``, ``epoch_awoken`` and
    ``checkpoint_dir`` are accepted (the meshes:
    ``tests/test_torch_parallel_trainer.py``)."""
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel import (
        build_mesh as tmesh)

    mc, cfg = tmm.MMDiTConfig(**MODEL), tconfig.FlowTrainConfig(**TRAIN)
    for kw in (dict(mesh=tmesh({"model": 2}, ["cpu"] * 2)),
               dict(fsdp=True)):
        state = MMDiTTrainer(mc, cfg, device="cpu", **kw).create_state(2)
        assert (state.model.joint_block0.x_block.tp is not None) == (
            "mesh" in kw)
    for impl in ("ring", "ulysses"):
        composed = MMDiTTrainer(
            dataclasses.replace(mc, attention_impl=impl), cfg, device="cpu",
            mesh=tmesh({"seq": 2, "model": 2}, ["cpu"] * 4)).create_state(2)
        blk = composed.model.joint_block0
        assert blk.x_block.tp.n == 2 and blk.context_block.tp.n == 2
        assert blk.seq_impl == impl and blk.mesh.shape == {"seq": 2,
                                                           "model": 2}
    for field in (dict(mesh_shape={"data": 8}),):
        with pytest.raises(ValueError, match="!= 1 devices"):
            MMDiTTrainer(mc, dataclasses.replace(cfg, **field), device="cpu")
    mesh = tmesh({"seq": 2}, ["cpu"] * 2)
    for field in (dict(attention_impl="ring"), dict(moe_experts=4)):
        MMDiTTrainer(dataclasses.replace(mc, **field), cfg, device="cpu",
                     mesh=mesh).make_model()
    MMDiTTrainer(mc, dataclasses.replace(cfg, grad_accum=2, epoch_awoken=3),
                 device="cpu", lora_rank=4, base_params={})
