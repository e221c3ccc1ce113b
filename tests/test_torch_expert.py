"""Parity of the port's meshes (``parallel/mesh.py``) and expert
parallelism (``parallel/expert.py``, the MoE MMDiT) with the JAX package,
on the CPU.

JAX runs on its 8 virtual CPU devices (``devices8``); the port on
one-process meshes of the host device repeated. Parameters are numpy draws
carried into both packages by ``io/from_jax.py`` (the router's kernel
transposed, ``wi`` / ``wg`` / ``wo`` in the JAX layout), fp32.

Tolerances are those of ``tests/test_expert.py``: SwitchFFN outputs rtol
and atol 1e-5 (aux the same), its gradients 1e-5; the MoE MMDiT 2e-5 with
rtol 1e-5, its per-block balance losses 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.parallel import expert as jexpert
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    jax_params_from_module, load_jax_params, state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import (
    build_mesh, expert as texpert, mesh as tmesh)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
    flax_default_init_)
from test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _cpu_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return build_mesh(shape, [torch.device("cpu")] * n)


# ------------------------------------------------------------------ meshes
def test_build_mesh_shapes_and_errors():
    mesh = _cpu_mesh({"data": 2, "seq": 4})
    assert mesh.shape == {"data": 2, "seq": 4} and mesh.size == 8
    assert build_mesh(None, ["cpu"] * 3).shape == {"data": 3}
    assert build_mesh({"data": -1, "expert": 2}, ["cpu"] * 8).shape == {
        "data": 4, "expert": 2}
    # the JAX message for a shape the devices do not give
    with pytest.raises(ValueError, match=r"mesh shape \{'seq': 4\} != 1 "
                                         "devices"):
        build_mesh({"seq": 4}, ["cpu"])
    with pytest.raises(ValueError, match="no axis"):
        mesh.comm("model")
    seq = mesh.comm("seq")
    assert seq.n == 4 and seq.index == [0, 1, 2, 3] and not seq.distributed
    # a one-device mesh over no visible card: jax.devices() has none either
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="!= 0 devices"):
            build_mesh({"seq": 2})


def test_axis_collectives_in_one_process():
    comm = _cpu_mesh({"seq": 4}).comm("seq")
    xs = [torch.full((2, 3), float(i)) for i in range(4)]
    assert [int(x[0, 0]) for x in comm.shift(xs)] == [3, 0, 1, 2]
    up = comm.ppermute(xs, [(0, 1), (1, 2), (2, 3)])
    assert [int(x[0, 0]) for x in up] == [0, 0, 1, 2]
    assert float(up[0].abs().sum()) == 0.0   # no sender: zeros
    assert all(float(s[0, 0]) == 6.0 for s in comm.psum(xs))
    # tiled all_to_all, as jax.lax.all_to_all(tiled=True)
    x = torch.arange(4 * 8.0).reshape(4, 8)
    a2a = comm.all_to_all(comm.shards(x, 1), split_dim=0, concat_dim=1)
    for j, got in enumerate(a2a):
        np.testing.assert_array_equal(got.numpy(), x[j:j + 1].numpy())
    assert comm.shards(x, 1)[2].data_ptr() == x[:, 4:6].data_ptr()


def test_shard_batch_and_replicate(devices8):
    mesh = _cpu_mesh({"data": 2, "seq": 4})
    a = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    got = tmesh.shard_batch(mesh, {"x": a, "y": (None, a[:, 0])})
    # one process, one device under the data axis: the batch stays whole
    np.testing.assert_array_equal(got["x"].numpy(), a)
    assert got["y"][0] is None
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_batch(mesh, a[:3])
    np.testing.assert_array_equal(tmesh.replicate(mesh, a).numpy(), a)


# ---------------------------------------------------------------- SwitchFFN
def _switch(e=4, c=16, b=2, l=12, capacity_factor=8.0, seed=0):
    jmod = jexpert.SwitchFFN(num_experts=e, hidden_mult=2,
                             capacity_factor=capacity_factor)
    x = np.random.default_rng(seed).standard_normal((b, l, c)).astype(
        np.float32)
    params = jax_random_params(jmod, x, seed=seed + 1)
    tmod = load_jax_params(texpert.SwitchFFN(c, e, hidden_mult=2,
                                             capacity_factor=capacity_factor),
                           params)
    return jmod, tmod, params, x


SWITCH_CASES = {
    "no_mesh": (dict(), None),
    "expert_mesh": (dict(e=8, b=2, l=16), {"expert": 4}),
    "data_expert_mesh": (dict(e=4, b=4, l=16), {"data": 2, "expert": 4}),
    # capacity int(0.125 * 16 / 2 + 1) = 2 slots per expert: most drop
    "capacity_drop": (dict(e=2, b=1, l=16, capacity_factor=0.125),
                      {"expert": 2}),
}


@pytest.mark.parametrize("case", list(SWITCH_CASES))
def test_switch_ffn_matches_jax(case):
    kw, shape = SWITCH_CASES[case]
    jmod, tmod, params, x = _switch(**kw)

    def jloss(p):
        out, aux = jmod.apply({"params": p}, x)
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

    (_, (want, want_aux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    mesh = _cpu_mesh(shape) if shape else None
    got, aux = tmod(torch.from_numpy(x), mesh=mesh)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    ((got ** 2).sum() + 0.01 * aux).backward()
    want_g = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    if case == "capacity_drop":
        zero_rows = np.all(got.detach().numpy()[0] == 0.0, axis=-1)
        assert zero_rows.sum() >= 16 - 2 * 2 and (~zero_rows).sum() >= 1


def test_switch_ffn_tree_both_ways_and_init():
    _, tmod, params, _ = _switch()
    back = jax_params_from_module(tmod)
    assert set(back) == {"router", "wi", "wg", "wo"}
    for k in ("wi", "wg", "wo"):
        np.testing.assert_array_equal(back[k], params[k])
    np.testing.assert_array_equal(back["router"]["kernel"],
                                  params["router"]["kernel"])
    # Flax's lecun_normal on the expert weights (fan-in: C, then H)
    flax_default_init_(tmod, torch.Generator().manual_seed(0))
    assert abs(tmod.wi.std().item() - 16 ** -0.5) < 0.05
    assert abs(tmod.wo.std().item() - 32 ** -0.5) < 0.05
    with pytest.raises(ValueError, match="experts 4 must divide"):
        tmod(torch.zeros(1, 4, 16), mesh=_cpu_mesh({"expert": 8}))


# -------------------------------------------------------------- MoE MMDiT
MOE = dict(depth=2, in_channels=4, adm_in_channels=8, context_dim=16,
           pos_embed_max_size=8)


def _moe_inputs():
    r = np.random.default_rng(11)
    return (r.standard_normal((2, 8, 8, 4)).astype(np.float32),
            np.asarray([100.0, 500.0], np.float32),
            r.standard_normal((2, 8)).astype(np.float32),
            r.standard_normal((2, 6, 16)).astype(np.float32))


@pytest.mark.parametrize("experts, shape", [(4, None), (8, {"expert": 8}),
                                            (4, {"data": 2, "expert": 4})])
def test_moe_mmdit_matches_jax_with_aux_losses(experts, shape):
    x, t, y, ctx = _moe_inputs()
    jmod = jmm.MMDiT(jmm.MMDiTConfig(**MOE, moe_experts=experts))
    params = jax_random_params(jmod, x, t, y, ctx, seed=4)
    want, mut = jax.jit(lambda p: jmod.apply(
        {"params": p}, x, t, y, ctx, mutable=["losses"]))(params)
    cfg = tmm.MMDiTConfig(**MOE, moe_experts=experts)
    tmod = load_jax_params(
        tmm.MMDiT(cfg, mesh=_cpu_mesh(shape) if shape else None), params)
    xb = tmod.joint_block0.x_block
    assert xb.moe.wi.shape[0] == experts and not hasattr(xb, "mlp_fc1")
    assert hasattr(tmod.joint_block0.context_block, "mlp_fc1")
    inputs = list(map(torch.from_numpy, (x, t, y, ctx)))
    with torch.no_grad(), tmm.collect_losses(tmod) as sown:
        got = tmod(*inputs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    assert sorted(sown) == ["joint_block0.x_block", "joint_block1.x_block"]
    for i in range(2):
        (jaux,) = mut["losses"][f"joint_block{i}"]["x_block"]["moe_aux"]
        np.testing.assert_allclose(sown[f"joint_block{i}.x_block"].item(),
                                   float(jaux), atol=1e-6)
    # outside collect_losses the balance losses go nowhere (inference)
    with torch.no_grad():
        np.testing.assert_array_equal(tmod(*inputs).numpy(), got.numpy())
    assert xb.sown is None


def test_mmdit_options():
    """The options that raised before the parallel package was ported now
    build; an unknown attention raises; ring without a mesh is the flash
    model, as in JAX."""
    with pytest.raises(ValueError, match="flash\\|ring\\|ulysses"):
        tmm.MMDiT(tmm.MMDiTConfig(depth=1, pos_embed_max_size=4,
                                  attention_impl="tp"))
    ring = tmm.MMDiT(tmm.MMDiTConfig(depth=1, pos_embed_max_size=4,
                                     attention_impl="ring"))
    assert ring.joint_block0.mesh is None
    flash = tmm.MMDiT(tmm.MMDiTConfig(depth=1, pos_embed_max_size=4))
    with pytest.raises(ValueError, match="needs a mesh"):
        flash.set_attention("ulysses")
    mesh = _cpu_mesh({"seq": 2})
    flash.set_attention("ulysses", mesh)
    assert (flash.config.attention_impl, flash.joint_block0.seq_impl,
            flash.joint_block0.mesh) == ("ulysses", "ulysses", mesh)
    flash.set_attention("flash")
    assert flash.joint_block0.mesh is None
    assert dataclasses.asdict(tmm.MMDiTConfig()) == dataclasses.asdict(
        jmm.MMDiTConfig())
