"""Tensor parallelism composed with ring / Ulysses attention, the port
against the JAX package on the CPU.

The JAX ``MMDiTTrainer`` builds both from one mesh: its ``model`` axis
shards the parameters (``tp_shardings``, with FSDP ``fsdp_tp_shardings``),
and its ring or Ulysses MMDiT runs each joint attention over ``seq`` in a
shard_map that keeps the head axis whole. The port's trainer on the same
mesh shape, in form (a) (the host device repeated), runs Megatron's block
per head shard and each head shard's own ring or Ulysses over ``seq``;
where a shard's heads do not divide by ``seq`` (Ulysses on {"data": 1,
"seq": 4, "model": 2}, 2 heads a shard) it gathers them and runs every
head, as the JAX shard_map does.

- One ``train_step`` from the same parameters, the port fed the JAX step's
  own draws: on {"data": 2, "seq": 2, "model": 2} with ring and Ulysses,
  ``fsdp`` False and True, and on {"data": 1, "seq": 4, "model": 2} with
  Ulysses. The JAX parameters are placed with the JAX trainer's own state
  shardings (replicating them would drop the TP layout), and the JAX loss
  is checked against its own meshless forward of the same parameters and
  draws first. Tolerances as ``tests/test_torch_parallel_trainer.py``: the
  loss rtol 1e-5, the parameters after AdamW by
  ``torch_trainer_parity.assert_adamw_close``.
- A 2-step ``sample`` from the stepped states, the JAX noise fed: atol /
  rtol 1e-4 (``tests/test_torch_mmdit_trainer.py``).
- The model on one mesh: ``apply_tp`` after ``MMDiT(mesh=)`` keeps the
  blocks' ``mesh`` and sets their ``tp``; each head shard's ring gets
  (B, H/model, L, D) and the seq axis's collectives; ring and Ulysses on a
  head shard with the ``seq`` comm of a 3-axis mesh against plain
  attention.
- ``SD3Inferencer(mesh={"model": 2})`` over a ring MMDiT, on its own
  {"seq": 2} mesh and on one {"seq": 2, "model": 2} mesh, the reduced
  bundle of ``tests/test_torch_sd3_serving.py`` at 64^2, 4 steps: uint8
  within one level of the JAX image of the same layout.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh as jmesh
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    mmdit_trainer as jtrainer)
from from_ddpm_to_stable_diffusion_tpu.pipelines import sd3 as jpipe3
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import (
    ring_attention as tring)
from from_ddpm_to_stable_diffusion_tpu_torch.parallel.sharding import (
    apply_tp)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd3 as tpipe3
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
    MMDiTTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from torch_trainer_parity import (assert_adamw_close, lr_bound, mmdit_draws,
                                  port_flat, port_flat_jax)

MODEL = dict(patch_size=2, in_channels=4, adm_in_channels=8, context_dim=16,
             pos_embed_max_size=8, depth=4)       # 4 heads of 64
TRAIN = dict(epoch=1, img_size=8, context_len=4, lr=1e-4, max_lr=1e-3,
             warmup_epochs=1, train_rand=0.1, sample_steps=3, w=2.0,
             dtype="fp32", seed=0, batch_size=2)
CUBE = {"data": 2, "seq": 2, "model": 2}
SEQ4 = {"data": 1, "seq": 4, "model": 2}
CASES = {"ring": (CUBE, "ring", False), "ring_fsdp": (CUBE, "ring", True),
         "ulysses": (CUBE, "ulysses", False),
         "ulysses_fsdp": (CUBE, "ulysses", True),
         "ulysses_seq4": (SEQ4, "ulysses", False)}


def _batch():
    r = np.random.default_rng(0)
    return (r.normal(size=(2, 8, 8, 4)).astype(np.float32),
            r.normal(size=(2, 4, 16)).astype(np.float32),
            r.normal(size=(2, 8)).astype(np.float32))


def cpu_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return build_mesh(shape, ["cpu"] * n)


def _jax_own_loss(params, draws, cfg, batch):
    """The JAX flow loss of ``params`` under ``draws``, from the meshless
    flash MMDiT: what the trainer's step should report."""
    latents, ctx, y = batch
    s = cfg.shift
    sigma = s * draws["t_lin"] / (1.0 + (s - 1.0) * draws["t_lin"])
    sig = sigma[:, None, None, None]
    x = sig * draws["noise"] + (1.0 - sig) * latents
    keep = ~draws["drop"]
    out = jmm.MMDiT(jmm.MMDiTConfig(**MODEL)).apply(
        {"params": params}, x, sigma * cfg.num_timesteps, y * keep[:, None],
        ctx * keep[:, None, None])
    return float(jnp.mean(jnp.square(out - (draws["noise"] - latents))))


_RUNS = {}


def _run(name, devices8):
    """The JAX and the port's step of one case (cached for the module)."""
    if name in _RUNS:
        return _RUNS[name]
    shape, impl, fsdp = CASES[name]
    batch = _batch()
    latents, ctx, y = batch
    jcfg = jconfig.FlowTrainConfig(**TRAIN)
    mesh = jmesh(shape, devices8[:int(np.prod(list(shape.values())))])
    jt = jtrainer.MMDiTTrainer(jmm.MMDiTConfig(**MODEL, attention_impl=impl),
                               jcfg, mesh=mesh, fsdp=fsdp)
    params = jax_random_params(jmm.MMDiT(jmm.MMDiTConfig(**MODEL)),
                               latents[:1], np.zeros((1,), np.float32),
                               y[:1], ctx[:1], seed=7)
    state = jt.create_state(steps_per_epoch=2)
    # placed as the trainer lays out its own state (TP, FSDP x TP)
    state = state.replace(params=jax.tree_util.tree_map(
        lambda p, like: jax.device_put(jnp.asarray(p), like.sharding),
        params, state.params))
    draws = mmdit_draws(jcfg, 0, latents.shape)
    own = _jax_own_loss(params, draws, jcfg, batch)
    state, jloss = jt.train_step(state, latents, ctx, y,
                                 jax.random.key(jcfg.seed + 1))
    trainer = MMDiTTrainer(tmm.MMDiTConfig(**MODEL, attention_impl=impl),
                           tconfig.FlowTrainConfig(**TRAIN), device="cpu",
                           mesh=cpu_mesh(shape), fsdp=fsdp)
    tstate = trainer.create_state(steps_per_epoch=2, params=params)
    tstate, loss = trainer.train_step(tstate, latents, ctx, y, **draws)
    _RUNS[name] = dict(jt=jt, jstate=state, jloss=float(jloss), own=own,
                       trainer=trainer, state=tstate, loss=loss.item())
    return _RUNS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_tp_sp_train_step_matches_jax(devices8, name):
    run = _run(name, devices8)
    shape, impl, fsdp = CASES[name]
    # the reference first: its step reports its own forward's loss
    np.testing.assert_allclose(run["jloss"], run["own"], rtol=1e-5)
    blk = run["state"].model.joint_block0
    assert blk.seq_impl == impl and blk.mesh.shape == shape
    assert blk.x_block.tp.n == 2 and blk.context_block.tp.n == 2
    assert run["state"].layout.model.n == 2
    assert any(d is not None for d in
               run["state"].layout.fsdp_dims.values()) == fsdp
    np.testing.assert_allclose(run["loss"], run["jloss"], rtol=1e-5)
    assert_adamw_close(port_flat(run["state"].params),
                       port_flat_jax(run["jstate"].params),
                       lr_bound(run["state"].schedule, 1), f"{name} params")


@pytest.mark.parametrize("name", ["ring", "ulysses_seq4"])
def test_tp_sp_sample_matches_jax(devices8, name):
    """Two CFG flow-Euler steps from the stepped states through the composed
    model of each package, the same initial noise."""
    run = _run(name, devices8)
    _, ctx, y = _batch()
    rng = jax.random.key(5)
    want = np.asarray(run["jt"].sample(run["jstate"], jnp.asarray(ctx),
                                       jnp.asarray(y), rng=rng, steps=2))
    noise = np.array(jax.random.normal(rng, (2, 8, 8, 4)))
    got = run["trainer"].sample(run["state"], ctx, y, steps=2, noise=noise)
    assert got.shape == (2, 8, 8, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_one_mesh_carries_both_axes(monkeypatch):
    """``MMDiT(mesh=)`` then ``apply_tp`` on the same {"seq": 2, "model": 2}
    mesh: each block keeps its mesh and gets its ``tp``; the ring runs once
    per held head shard, on (B, H/model, L, D) over the seq axis's
    collectives; Ulysses with heads that do not divide by seq gets every
    head; both forwards equal the meshless one within 1e-5 of its largest
    output."""
    cfg = tmm.MMDiTConfig(**MODEL, attention_impl="ring")
    torch.manual_seed(0)
    whole = tmm.MMDiT(dataclasses.replace(cfg, attention_impl="flash"))
    with torch.no_grad():     # fan-in scaled, as jax_random_params draws
        for p in whole.parameters():
            p.normal_(0.0, p.shape[-1] ** -0.5 if p.dim() > 1 else 0.1)
    x, ctx, y = (torch.from_numpy(a) for a in _batch())
    t = torch.tensor([100.0, 700.0])
    want = whole(x, t, y, ctx)
    seen = []

    def spy(fn):
        def wrapped(q, k, v, mesh, axis, **kw):
            seen.append((fn.__name__, tuple(q.shape), mesh.comm(axis).n))
            return fn(q, k, v, mesh, axis, **kw)
        return wrapped

    monkeypatch.setattr(tmm, "ring_attention", spy(tring.ring_attention))
    monkeypatch.setattr(tmm, "ulysses_attention",
                        spy(tring.ulysses_attention))
    for impl, shape, heads in (("ring", {"seq": 2, "model": 2}, 2),
                               ("ulysses", {"seq": 4, "model": 2}, 4)):
        mesh = cpu_mesh(shape)
        model = tmm.MMDiT(dataclasses.replace(cfg, attention_impl=impl),
                          mesh=mesh)
        model.load_state_dict(whole.state_dict())
        apply_tp(model, mesh)
        blk = model.joint_block3
        assert blk.mesh is mesh and blk.x_block.tp.n == 2
        assert model.tp.n == 2 and model.mesh is mesh
        seen.clear()
        got = model(x, t, y, ctx)
        # joint sequence 4 + 16 = 20 tokens, a multiple of 2 and of 4
        calls = 2 if impl == "ring" else 1     # per block
        assert seen == [(f"{impl}_attention", (2, heads, 20, 64),
                         shape["seq"])] * (calls * MODEL["depth"])
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(),
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("impl", ["flash", "xla", "ulysses"])
def test_head_shard_attention_over_the_seq_axis_of_three(impl):
    """A head shard's (B, H/model, L, D) through the ``seq`` comm of a
    {"data": 2, "seq": 2, "model": 2} mesh, ``kv_valid_len`` masking the
    padded keys: the ring (impl "flash": the plain K5 / K6 / K7 under the
    hop offsets; "xla") and Ulysses against plain attention over the valid
    keys, forward and gradients."""
    mesh = cpu_mesh(CUBE)
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn(2, 2, 22, 64, generator=gen) for _ in range(4))
    valid = 21
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    if impl == "ulysses":
        out = tring.ulysses_attention(*leaves, mesh, "seq",
                                      kv_valid_len=valid)
    else:
        out = tring.ring_attention(*leaves, mesh, "seq", kv_valid_len=valid,
                                   impl=impl)
    grads = torch.autograd.grad(out, leaves, g)
    ref = [a.clone().requires_grad_() for a in (q, k, v)]
    p = torch.softmax(ref[0] @ ref[1][:, :, :valid].transpose(-1, -2)
                      / 8.0, -1)
    want = p @ ref[2][:, :, :valid]
    ref_g = torch.autograd.grad(want, ref, g)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    for a, b in zip(grads, ref_g):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert mesh.comm("seq").n == 2


@pytest.fixture(scope="module")
def sd3_pair():
    """The JAX reduced SD3 bundle and the port's from its parameters."""
    from tests.test_torch_sd3_serving import _jax_models, _port_models

    jmodels = _jax_models()
    return jmodels, _port_models(jmodels.params)


@pytest.mark.parametrize("layout", ["own_seq_mesh", "one_mesh"])
def test_sd3_inferencer_tp_over_a_ring_mmdit_matches_jax(sd3_pair, layout):
    from tests.test_torch_sd3_serving import (CLIP_TOKENS, KW, LATENT,
                                              _jax_noise)

    jmodels, tmodels = sd3_pair
    devs = jax.devices()
    if layout == "one_mesh":
        jtp = jseq = jmesh({"seq": 2, "model": 2}, devs[:4])
        ttp = tseq = cpu_mesh({"seq": 2, "model": 2})
    else:
        jseq, jtp = jmesh({"seq": 2}, devs[:2]), jmesh({"model": 2},
                                                       devs[:2])
        tseq, ttp = cpu_mesh({"seq": 2}), cpu_mesh({"model": 2})
    # as the JAX CLI builds its --sp MMDiT (cli/sd3.py)
    jring = dataclasses.replace(jmodels)
    jring.mmdit = jmm.MMDiT(dataclasses.replace(
        jmodels.mmdit.config, attention_impl="ring"),
        dtype=jmodels.mmdit.dtype, mesh=jseq)
    want = jpipe3.SD3Inferencer(jring, shift=3.0, decode_mode="whole",
                                mesh=jtp).gen_image(CLIP_TOKENS, seed=2,
                                                    **KW)
    tring_models = dataclasses.replace(tmodels)
    for f in dataclasses.fields(tmodels):     # TP switches modules in place
        m = getattr(tmodels, f.name)
        if isinstance(m, torch.nn.Module):
            setattr(tring_models, f.name, copy.deepcopy(m))
    tring_models.mmdit.set_attention("ring", tseq)
    inf = tpipe3.SD3Inferencer(tring_models, shift=3.0, mesh=ttp)
    blk = tring_models.mmdit.joint_block1
    assert blk.x_block.tp.n == 2 and blk.mesh is tseq
    got = inf.gen_image(CLIP_TOKENS, noise=_jax_noise(2, (1, *LATENT)), **KW)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
