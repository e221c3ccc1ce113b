"""Parity of the port's pipeline parallelism (``parallel/pipeline.py`` and
the MMDiT's four pipeline functions) with the JAX package, on the CPU.

JAX runs on its 8 virtual CPU devices; the port on a one-process ``stage``
mesh of the host device repeated. Weights and inputs are numpy draws from a
seed, fp32. Tolerances are ``tests/test_pipeline.py``'s: ``pipeline_apply``
1e-5; ``pipeline_value_and_grad`` loss rtol 1e-6 and gradients 1e-5; the
pipelined joint blocks 2e-4; the whole pipelined MMDiT forward 3e-4 and its
gradients 3e-4 (here against the port's own autograd of ``MMDiT.forward``);
1F1B through two real joint-block stages 1e-5 on the loss and 2e-4 on the
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh as jmesh
from from_ddpm_to_stable_diffusion_tpu.parallel import pipeline as jpipe
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params)
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import (
    pipeline as tpipe)
from test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _stage_mesh(n):
    return build_mesh({"stage": n}, [torch.device("cpu")] * n)


def _jax_stage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _port_stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def _make(n_stages, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32),
            (rng.standard_normal((n_stages, d)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("n_stages, n_micro", [(4, 4), (4, 8), (8, 8),
                                               (2, 6)])
def test_1f1b_schedule_matches_jax(n_stages, n_micro):
    got = tpipe.make_1f1b_schedule(n_stages, n_micro)
    want = jpipe.make_1f1b_schedule(n_stages, n_micro)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_stages, n_micro", [(4, 8), (2, 6)])
def test_pipeline_apply_matches_jax(devices8, n_stages, n_micro):
    params = _make(n_stages)
    x = np.random.default_rng(1).standard_normal(
        (n_micro * 2, 16)).astype(np.float32)
    mesh = jmesh({"stage": n_stages}, devices8[:n_stages])
    want = jpipe.pipeline_apply(_jax_stage, params, x, mesh,
                                n_microbatches=n_micro)
    got = tpipe.pipeline_apply(_port_stage,
                               tuple(map(torch.from_numpy, params)),
                               torch.from_numpy(x), _stage_mesh(n_stages),
                               n_microbatches=n_micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n_stages, n_micro", [(4, 8), (2, 6)])
def test_pipeline_value_and_grad_matches_jax(devices8, n_stages, n_micro):
    params = _make(n_stages)
    rng = np.random.default_rng(2)
    x, tgt = (rng.standard_normal((n_micro * 2, 16)).astype(np.float32)
              for _ in range(2))
    mesh = jmesh({"stage": n_stages}, devices8[:n_stages])
    want_loss, want = jpipe.pipeline_value_and_grad(
        _jax_stage, params, x, tgt, lambda y, t: jnp.mean((y - t) ** 2),
        mesh, n_microbatches=n_micro)
    loss, grads = tpipe.pipeline_value_and_grad(
        _port_stage, tuple(map(torch.from_numpy, params)),
        torch.from_numpy(x), torch.from_numpy(tgt),
        lambda y, t: torch.mean((y - t) ** 2), _stage_mesh(n_stages),
        n_microbatches=n_micro)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    assert isinstance(grads, tuple)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_pipeline_rejects_bad_microbatching():
    params = tuple(map(torch.from_numpy, _make(4, d=8)))
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipeline_apply(_port_stage, params, torch.zeros(6, 8),
                             _stage_mesh(4), n_microbatches=4)
    with pytest.raises(ValueError, match="do not divide"):
        tmm.stack_joint_block_params({}, 23, 4)


# ------------------------------------------------- the MMDiT's joint blocks
def _mmdit_setup(depth=5, seed=0, b=8):
    """A small MMDiT (JAX params loaded into the port's) and embedded
    (context, x, c) inputs of the block stack."""
    cfg = dict(depth=depth, pos_embed_max_size=8)
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    x, y, ctx = r(b, 8, 8, 16), r(b, 2048), r(b, 20, 4096)
    t = rng.uniform(0, 1000, (b,)).astype(np.float32)
    jmod = jmm.MMDiT(jmm.MMDiTConfig(**cfg))
    params = jax_random_params(jmod, x, t, y, ctx, seed=seed)
    tmod = load_jax_params(tmm.MMDiT(tmm.MMDiTConfig(**cfg)), params)
    hs = 64 * depth
    embedded = (r(b, 20, hs), r(b, 16, hs), r(b, hs))
    return cfg, jmod, params, tmod, (x, t, y, ctx), embedded


def _jax_blocks(cfg, params, context, x, c, n_blocks):
    blk = jmm.JointBlock(64 * cfg["depth"], cfg["depth"])
    for i in range(n_blocks):
        context, x = blk.apply({"params": params[f"joint_block{i}"]},
                               context, x, c)
    return context, x


@pytest.mark.parametrize("n_stages", [4, 2])
def test_pipelined_joint_blocks_match_jax(n_stages):
    cfg, _, params, tmod, _, (context, xe, c) = _mmdit_setup(seed=n_stages)
    want = jax.jit(lambda p: _jax_blocks(cfg, p, context, xe, c, 4))(params)
    got = tmm.pipelined_joint_blocks(
        tmm.MMDiTConfig(**cfg), dict(tmod.named_parameters()),
        *map(torch.from_numpy, (context, xe, c)), _stage_mesh(n_stages),
        n_microbatches=4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=2e-4)


def test_mmdit_forward_pp_matches_jax_and_its_gradients():
    cfg, jmod, params, tmod, inputs, _ = _mmdit_setup(seed=9)
    want = jax.jit(lambda p: jmod.apply({"params": p}, *inputs))(params)
    tgt = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 8, 8, 16)).astype(np.float32) * 0.3)
    args = list(map(torch.from_numpy, inputs))
    named = dict(tmod.named_parameters())
    got = tmm.mmdit_forward_pp(tmm.MMDiTConfig(**cfg), named, *args,
                               _stage_mesh(4), n_microbatches=4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=3e-4)
    pp = torch.autograd.grad(torch.mean((got - tgt) ** 2),
                             list(named.values()))
    ref = torch.autograd.grad(torch.mean((tmod(*args) - tgt) ** 2),
                              list(named.values()))
    for name, a, b in zip(named, pp, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-4,
                                   err_msg=name)


def test_1f1b_through_joint_block_stages_matches_jax():
    cfg, _, params, tmod, _, (context, xe, c) = _mmdit_setup(depth=3,
                                                             seed=5)
    lc, n_blocks, n_stages = 20, 2, 2
    z = np.concatenate([context, xe, c[:, None]], axis=1)
    tgt = (np.random.default_rng(6).standard_normal(z.shape) * 0.3).astype(
        np.float32)
    jcfg = jmm.MMDiTConfig(**cfg)
    jstage = jmm.make_joint_block_stage_fn(jcfg, lc, k=1)
    jsp = jmm.stack_joint_block_params(params, n_blocks, n_stages)

    def seq_loss(sp):
        out = z
        for s in range(n_stages):
            out = jstage(jax.tree_util.tree_map(lambda p: p[s], sp), out)
        return jnp.mean((out - tgt) ** 2)

    want_loss, want = jax.jit(jax.value_and_grad(seq_loss))(jsp)
    tcfg = tmm.MMDiTConfig(**cfg)
    sp = tmm.stack_joint_block_params(dict(tmod.named_parameters()),
                                      n_blocks, n_stages)
    loss, grads = tpipe.pipeline_value_and_grad(
        tmm.make_joint_block_stage_fn(tcfg, lc, k=1),
        {k: v.detach() for k, v in sp.items()}, torch.from_numpy(z),
        torch.from_numpy(tgt), lambda y, t: torch.mean((y - t) ** 2),
        _stage_mesh(n_stages), n_microbatches=4)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    want = _port_names_of_stacked(want)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], atol=2e-4,
                                   err_msg=name)


def _port_names_of_stacked(tree):
    """A JAX tree of stacked (n_stages, k, ...) block leaves by the port's
    names: a linear's kernel (.., I, O) as its weight (.., O, I), a norm's
    scale as its weight."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        *pre, name = [str(getattr(k, "key", k)) for k in path]
        a = np.asarray(leaf)
        if name == "kernel":
            name, a = "weight", np.swapaxes(a, -1, -2)
        elif name == "scale":
            name = "weight"
        out[".".join(pre + [name])] = a
    return out
