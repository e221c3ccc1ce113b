"""FSDP of the port (``parallel/fsdp.py``, the trainers' ``StateLayout``)
against the JAX package's, on the CPU. The JAX trainers run their own FSDP
on the virtual CPU devices of ``tests/conftest.py``; the port runs mesh form
(a), the host device repeated, where a sharded leaf is the whole tensor and
its shards are views of it (form (b), one slice a rank, is held against
form (a) in ``tests/test_torch_parallel_dist.py``).

- The spec rules: the cases of ``tests/test_fsdp.py``, and ``fsdp_dims``
  (the torch dim each port parameter is stored sharded on) against the JAX
  ``fsdp_shardings`` of the same tree, leaf by leaf.
- Three ``DDPMTrainer(mesh={"data": 2}, fsdp=True)`` steps against the JAX
  FSDP trainer fed its own draws: losses within rtol 1e-6, parameters and
  EMA within the JAX FSDP test's own bounds (``tests/test_fsdp.py``: the
  99th percentile of the differences below 1e-6, the largest below 3e-3);
  against the meshless port: bit for bit (form (a) computes what one device
  does).
- FSDP with ``grad_accum=2``: the window's first micro-step leaves the
  parameters as they were, the second moves them, both against the JAX
  FSDP trainer under ``MultiSteps`` (losses rtol 1e-6, parameters by
  ``torch_trainer_parity.assert_adamw_close``).
- The hybrid {"data": 2, "model": 2} ``MMDiTTrainer(fsdp=True)``: three
  steps against the JAX data-parallel trainer fed its draws, within the
  JAX test's own bounds (``tests/test_mmdit_trainer.py``: losses rtol
  2e-5; parameters: the 99th percentile of the differences below 1e-5, the
  largest below 3e-3).
- Checkpoints hold the whole state: one written by an FSDP trainer's
  ``fit`` restores into a meshless trainer, and the other way round, bit
  for bit, and the next step from each is the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh as jmesh
from from_ddpm_to_stable_diffusion_tpu.parallel import fsdp as jfsdp
from from_ddpm_to_stable_diffusion_tpu.parallel.sharding import _path_str
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    ddpm_trainer as jddpm)
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    mmdit_trainer as jmmdit)
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import fsdp as tfsdp
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
    DDPMTrainer, checkpoint_tree, restore_tree)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
    MMDiTTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from from_ddpm_to_stable_diffusion_tpu_torch.utils.checkpoint import (
    CheckpointManager)
from test_torch_mmdit_trainer import MODEL, TRAIN, _batch, _params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from torch_trainer_parity import (assert_adamw_close, ddpm_draws, lr_bound,
                                  mmdit_draws, port_flat, port_flat_jax)

CFG = dict(epoch=2, batch_size=8, img_size=16, img_channel=3, num_class=3,
           T=10, channel=32, channel_multy=[1, 2, 2, 2], dropout=0.0,
           lr=1e-4, max_lr=1e-3, warmup_epochs=1, train_rand=0.1, w=1.8,
           dtype="fp32", seed=0, ema_decay=0.9)
IMGS = np.random.default_rng(0).uniform(-1, 1, (8, 16, 16, 3)).astype(
    np.float32)
LABELS = (np.arange(8) % 3).astype(np.int32)
STEPS = 3


def cpu_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return build_mesh(shape, ["cpu"] * n)


# ------------------------------------------------------------ the rules
def test_fsdp_spec_rules():
    """``tests/test_fsdp.py::test_fsdp_spec_rules``, both packages."""
    cases = [(((3, 3, 128, 512), 8, 1), (None, None, None, "data")),
             (((1 << 20,), 8, 1), ("data",)),
             (((128,), 8, tfsdp.MIN_SHARD_SIZE), ()),
             (((7, 13), 8, 1), ()),
             (((256, 256), 8, 1), ("data", None))]
    for (shape, size, min_size), want in cases:
        assert tfsdp.fsdp_spec(shape, size, min_size=min_size) == want
        assert tuple(jfsdp.fsdp_spec(shape, size, min_size=min_size)) \
            == want
    assert tfsdp.MIN_SHARD_SIZE == jfsdp.MIN_SHARD_SIZE == 2 ** 15


def test_fsdp_tp_composition(devices8):
    """``tests/test_fsdp.py::test_fsdp_tp_composition``, both packages, and
    ``drop_data_axis``."""
    params = {
        "blocks_0": {"attn": {"qkv": {"kernel": np.zeros((256, 768))},
                              "proj": {"kernel": np.zeros((256, 256))}}},
        "norm": {"scale": np.zeros((256,))},
    }
    shape = {"data": 4, "model": 2}
    got = tfsdp.fsdp_tp_shardings(params, shape, min_size=1)
    jmesh8 = jmesh(shape, devices8)
    want = jfsdp.fsdp_tp_shardings(params, jmesh8, min_size=1)
    assert got["blocks_0"]["attn"]["qkv"]["kernel"] == ("data", "model")
    assert got["blocks_0"]["attn"]["proj"]["kernel"] == ("model", "data")
    for k, s in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for part in _path_str(k).split("/"):
            node = node[part]
        assert node == tuple(s.spec), _path_str(k)
    assert tfsdp.fsdp_tp_shardings(params, shape)["norm"]["scale"] == ()
    dropped = tfsdp.drop_data_axis(got)
    assert dropped["blocks_0"]["attn"]["qkv"]["kernel"] == (None, "model")
    assert dropped["blocks_0"]["attn"]["proj"]["kernel"] == ("model", None)
    jdropped = jfsdp.drop_data_axis(want)
    assert tuple(jdropped["blocks_0"]["attn"]["proj"]["kernel"].spec) == \
        ("model", None)


def _torch_dim(name, jdim, model):
    """The torch dim of a Flax dim of the leaf ``name`` of ``model``."""
    owner, _, leaf = name.rpartition(".")
    shape, to_torch = tfsdp._flax_shape(model.get_submodule(owner), leaf,
                                        dict(model.named_parameters())[name])
    return to_torch[jdim]


@pytest.mark.parametrize("kind", ["ddpm", "hybrid"])
def test_fsdp_dims_are_the_jax_specs(kind, devices8):
    """Each port parameter is stored sharded on the torch dim of the Flax
    dim the JAX spec shards over data: the TinyUNet on {"data": 2} under
    ``fsdp_shardings``, the MMDiT on {"data": 2, "model": 2} under
    ``fsdp_tp_shardings``; and a form-(a) shard is a view of its tensor."""
    if kind == "ddpm":
        jt = jddpm.DDPMTrainer(jconfig.TinySDConfig(**CFG))
        shapes = jax.eval_shape(jt.model.init, jax.random.key(0),
                                jnp.zeros((1, 16, 16, 3)),
                                jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1,), jnp.int32))["params"]
        shape = {"data": 2}
        jspecs = jfsdp.fsdp_shardings(shapes, jmesh(shape, devices8[:2]))
        trainer = DDPMTrainer(tconfig.TinySDConfig(**CFG), device="cpu",
                              mesh=cpu_mesh(shape), fsdp=True)
    else:
        x, ctx, y = _batch(1)
        shapes = jax.eval_shape(jmm.MMDiT(jmm.MMDiTConfig(**MODEL)).init,
                                jax.random.key(0), x,
                                np.zeros((1,), np.float32), y, ctx)["params"]
        shape = {"data": 2, "model": 2}
        jspecs = jfsdp.fsdp_tp_shardings(shapes, jmesh(shape, devices8[:4]))
        trainer = MMDiTTrainer(tmm.MMDiTConfig(**MODEL),
                               tconfig.FlowTrainConfig(**TRAIN),
                               device="cpu", mesh=cpu_mesh(shape),
                               fsdp=True)
    state = trainer.create_state(4)
    dims = state.layout.fsdp_dims
    flat = {}
    for k, s in jax.tree_util.tree_flatten_with_path(jspecs)[0]:
        path = _path_str(k)
        *parent, leaf = path.split("/")
        leaf = {"kernel": "weight", "scale": "weight",
                "embedding": "weight"}.get(leaf, leaf)
        flat[".".join(parent + [leaf])] = tuple(s.spec)
    assert set(flat) == set(dims)
    for name, spec in flat.items():
        want = (_torch_dim(name, spec.index("data"), state.model)
                if "data" in spec else None)
        assert dims[name] == want, (name, spec)
    assert sum(d is not None for d in dims.values()) >= 4
    comm = trainer.mesh.comm("data")
    name = next(n for n, d in dims.items() if d is not None)
    p = dict(state.model.named_parameters())[name]
    shards = tfsdp.apply_fsdp(p, dims[name], comm)
    assert len(shards) == 2 and all(
        s.untyped_storage().data_ptr() == p.untyped_storage().data_ptr()
        for s in shards)
    stored = tfsdp.constrain({name: p}, dims, comm)
    assert [s.shape for s in stored] == [s.shape for s in shards]


# ------------------------------------------------------------ DDPM
def _jax_ddpm_run(devices, **over):
    jcfg = jconfig.TinySDConfig(**{**CFG, **over})
    jt = jddpm.DDPMTrainer(jcfg, mesh=jmesh({"data": 2}, devices[:2]),
                           fsdp=True)
    jstate = jt.create_state(steps_per_epoch=4)
    params0 = jax.tree_util.tree_map(np.array, jax.device_get(
        jstate.params))
    rng = jax.random.key(jcfg.seed + 1)
    steps = []
    for i in range(STEPS):
        draws = ddpm_draws(jcfg, i, LABELS.shape, IMGS.shape)
        jstate, loss = jt.train_step(jstate, IMGS, LABELS, rng)
        steps.append(dict(draws, loss=float(loss),
                          params=port_flat_jax(jax.device_get(
                              jstate.params)),
                          ema=port_flat_jax(jax.device_get(
                              jstate.ema_params))))
    return params0, steps


def _port_ddpm_run(params0, jax_steps, mesh, fsdp, **over):
    trainer = DDPMTrainer(tconfig.TinySDConfig(**{**CFG, **over}),
                          device="cpu", mesh=mesh, fsdp=fsdp)
    state = trainer.create_state(4, params=params0)
    steps = []
    for js in jax_steps:
        state, loss = trainer.train_step(state, IMGS, LABELS,
                                         drop=js["drop"], t=js["t"],
                                         noise=js["noise"])
        steps.append(dict(loss=loss.item(), params=port_flat(state.params),
                          ema=port_flat(state.ema_params),
                          updates=state.updates))
    return trainer, state, steps


@pytest.fixture(scope="module")
def ddpm(devices8):
    params0, jax_steps = _jax_ddpm_run(devices8)
    fsdp = _port_ddpm_run(params0, jax_steps, cpu_mesh({"data": 2}), True)
    plain = _port_ddpm_run(params0, jax_steps, None, False)
    return dict(jax=jax_steps, fsdp=fsdp, plain=plain)


def assert_distribution_close(got, want, p99, top):
    """The JAX FSDP tests' comparison: Adam turns noise-level gradient
    differences (sums associated differently) into +-lr flips, so almost
    every element agrees (the 99th percentile of the differences below
    ``p99``) and the tail is bounded by ``top``."""
    d = np.concatenate([np.abs(got[n] - w).ravel().astype(np.float64)
                        for n, w in want.items()])
    assert np.percentile(d, 99) < p99
    assert d.max() < top


@pytest.mark.parametrize("i", range(STEPS))
def test_fsdp_ddpm_steps_match_jax_fsdp(ddpm, i):
    _, state, steps = ddpm["fsdp"]
    got, want = steps[i], ddpm["jax"][i]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    for key in ("params", "ema"):
        assert set(got[key]) == set(want[key])
        assert_distribution_close(got[key], want[key], 1e-6, 3e-3)


def test_fsdp_ddpm_equals_the_meshless_port(ddpm):
    (trainer, state, steps), (_, plain, plain_steps) = (ddpm["fsdp"],
                                                        ddpm["plain"])
    assert trainer.mesh.shape == {"data": 2} and trainer.fsdp
    for a, b in zip(steps, plain_steps):
        assert a["loss"] == b["loss"]
        for key in ("params", "ema"):
            for n in a[key]:
                np.testing.assert_array_equal(a[key][n], b[key][n])


def test_fsdp_ddpm_with_grad_accumulation(devices8):
    """``tests/test_fsdp.py::test_fsdp_composes_with_grad_accumulation``
    against the port: the window holds the parameters on its first
    micro-step and moves them on its second, as the JAX FSDP trainer under
    MultiSteps does, with the same losses and parameters."""
    params0, jax_steps = _jax_ddpm_run(devices8, grad_accum=2)
    trainer, state, steps = _port_ddpm_run(
        params0, jax_steps, cpu_mesh({"data": 2}), True, grad_accum=2)
    start = port_flat_jax(params0)
    assert all(np.array_equal(steps[0]["params"][n], start[n])
               for n in start)
    assert not all(np.array_equal(steps[1]["params"][n], start[n])
                   for n in start)
    assert [s["updates"] for s in steps] == [0, 1, 1]
    assert len(state.acc_grads) == len(state.trainable())
    for got, want in zip(steps, jax_steps):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        assert_adamw_close(got["params"], want["params"],
                           lr_bound(state.schedule, got["updates"]),
                           "params")


# ------------------------------------------------------------ hybrid MMDiT
def test_hybrid_fsdp_tp_mmdit_matches_jax_data_parallel(devices8):
    """``tests/test_mmdit_trainer.py::test_fsdp_tp_hybrid_matches_dp`` for
    the port: {"data": 2, "model": 2} with fsdp=True (every joint block on
    its head shards, the state stored over both axes) against the JAX
    trainer on a {"data": 2} data-parallel mesh, three steps from the same
    parameters and draws."""
    latents, ctx, y = _batch()
    params = _params()
    jcfg = jconfig.FlowTrainConfig(**TRAIN, dtype="fp32")
    jt = jmmdit.MMDiTTrainer(jmm.MMDiTConfig(**MODEL), jcfg,
                             mesh=jmesh({"data": 2}, devices8[:2]))
    jstate = jt.create_state(steps_per_epoch=2)
    as_jax = lambda: jax.tree_util.tree_map(jnp.array, params)
    jstate = jstate.replace(params=as_jax(), ema_params=as_jax())
    rng = jax.random.key(jcfg.seed + 1)
    trainer = MMDiTTrainer(tmm.MMDiTConfig(**MODEL),
                           tconfig.FlowTrainConfig(**TRAIN, dtype="fp32"),
                           device="cpu",
                           mesh=cpu_mesh({"data": 2, "model": 2}), fsdp=True)
    state = trainer.create_state(steps_per_epoch=2, params=params)
    assert state.model.joint_block0.x_block.tp.n == 2
    assert any(d is not None for d in state.layout.fsdp_dims.values())
    assert state.layout.tp_sharded
    for i in range(STEPS):
        draws = mmdit_draws(jcfg, i, latents.shape)
        jstate, jloss = jt.train_step(jstate, latents, ctx, y, rng)
        state, loss = trainer.train_step(state, latents, ctx, y, **draws)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    assert_distribution_close(port_flat(state.params), port_flat_jax(
        jax.device_get(jstate.params)), 1e-5, 3e-3)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("direction", ["fsdp_to_plain", "plain_to_fsdp"])
def test_checkpoints_cross_between_fsdp_and_no_mesh(direction, tmp_path):
    fsdp = dict(mesh=cpu_mesh({"data": 2}), fsdp=True)
    first, second = (fsdp, {}) if direction == "fsdp_to_plain" else (
        {}, fsdp)
    cfg = tconfig.TinySDConfig(**CFG)
    writer = DDPMTrainer(cfg, device="cpu", **first)
    batches = [(IMGS, LABELS)] * 2
    state = writer.fit(batches, epochs=1, checkpoint_dir=str(tmp_path))
    saved, at = CheckpointManager(str(tmp_path)).restore()
    assert at == 0
    reader = DDPMTrainer(cfg, device="cpu", **second)
    other = reader.create_state(2)
    restore_tree(other, reader.generator, saved)
    mine, theirs = port_flat(state.params), port_flat(other.params)
    for n in mine:
        np.testing.assert_array_equal(mine[n], theirs[n])
    assert other.updates == state.updates == 2
    draws = dict(drop=np.zeros(8, bool), t=np.arange(8) % 10,
                 noise=np.random.default_rng(5).standard_normal(
                     IMGS.shape).astype(np.float32))
    state, a = writer.train_step(state, IMGS, LABELS, **draws)
    other, b = reader.train_step(other, IMGS, LABELS, **draws)
    assert a.item() == b.item()
    mine, theirs = port_flat(state.params), port_flat(other.params)
    for n in mine:
        np.testing.assert_array_equal(mine[n], theirs[n])
    assert checkpoint_tree(other, None)["step"] == 3


def test_prefetch_to_device_places_batches_by_shard_batch():
    """``prefetch_to_device(iterator, mesh=)`` (the JAX signature's mesh):
    each batch through ``shard_batch``, on the mesh's device; on a
    one-process mesh the whole batch, in order."""
    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        prefetch_to_device)

    batches = [(IMGS[i:i + 2], LABELS[i:i + 2]) for i in range(0, 8, 2)]
    got = list(prefetch_to_device(iter(batches), mesh=cpu_mesh({"data": 2})))
    assert len(got) == len(batches)
    for (x, y), (gx, gy) in zip(batches, got):
        assert torch.is_tensor(gx) and gx.device.type == "cpu"
        np.testing.assert_array_equal(gx.numpy(), x)
        np.testing.assert_array_equal(gy.numpy(), y)
    with pytest.raises(ValueError, match="does not divide"):
        list(prefetch_to_device(iter([(IMGS[:3], LABELS[:3])]),
                                mesh=cpu_mesh({"data": 2})))
