"""Parity of the port's stage-03 VAE family with the JAX package's, on the
CPU in fp32: Flax's transposed and strided 'SAME' convs, ``_ConvBNAct``
in training and eval mode with its running statistics, ``VanillaVAE``
(encode / decode / sample / generate / loss with JAX's own noise),
``VectorQuantizer`` (indices, straight-through gradients), ``VQVAE``, the
SD3 ``SDVAE`` with JAX's noise, ``VAETrainConfig``, and three
``VAETrainer.train_step``s of each model against the JAX trainer fed its
own draws; then the ``vae`` CLI.

Tolerances, fp32: forwards within 1e-5 relative (rtol 1e-5, atol 1e-5 of
the output's largest magnitude), BatchNorm running statistics the same;
VQ indices identical; gradients within 1e-4 of their largest magnitude;
the SD3 pair (ch 128, 21 res blocks) atol = rtol = 1e-4; parameters after
AdamW as ``torch_trainer_parity.assert_adamw_close``, the tolerance of
``test_slice_adamw_step_and_ema_match_jax``. The biases of the convs in
front of a BatchNorm in training mode have an analytically zero gradient,
which both frameworks return as rounding noise and AdamW turns into ±lr
moves: they are held to that bound alone (2·lr a step), and their
gradients checked to be noise.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from from_ddpm_to_stable_diffusion_tpu.models import sd3_vae as jsd3vae
from from_ddpm_to_stable_diffusion_tpu.models import vae as jvae
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    vae_trainer as jvae_trainer)
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    jax_params_from_module, load_jax_params, state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import layers as tl
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd3_vae as tsd3vae
from from_ddpm_to_stable_diffusion_tpu_torch.models import vae as tvae
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vae_trainer import (
    VAETrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from test_torch_models import jax_random_params
from torch_trainer_parity import (assert_adamw_close, lr_bound,
                                  one_device_mesh, port_flat, port_flat_jax)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

HIDDEN = (8, 16, 16, 32, 32)   # a 5-stage VanillaVAE ladder, narrowed


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _batch_stats(module, x, seed):
    """Random running statistics in the shape of ``module``'s Flax
    ``batch_stats``."""
    return _fill_stats(jax.eval_shape(module.init, jax.random.key(0),
                                      x)["batch_stats"], seed)


def _stats_close(tmod, jax_stats, rel=1e-5):
    """The module's running statistics (its buffers) against Flax's."""
    got = dict(tmod.named_buffers())
    want = state_dict_from_jax(jax.tree_util.tree_map(np.array, jax_stats))
    assert set(got) == set(want)
    for name, w in want.items():
        _close(got[name], w.numpy(), rel)


# ------------------------------------------------------- Flax's convs
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("hw", [(5, 7), (4, 6)])
def test_conv_transpose_matches_flax(k, hw):
    """Flax's stride-2 'SAME' ConvTranspose on an asymmetric input (random,
    H != W, odd and even): no pixel shift. At k = 3 torch's usual
    ``ConvTranspose2d(padding=1, output_padding=1)`` lands one pixel off,
    at k = 4 its ``padding=1`` is Flax's padding."""
    x = _rand((2, *hw, 4), k)
    jmod = nn.ConvTranspose(6, (k, k), strides=(2, 2), padding="SAME")
    params = jax_random_params(jmod, x, seed=k)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = load_jax_params(tvae.ConvTranspose2d(4, 6, k, stride=2), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 6) == want.shape
    _close(got, want)
    usual = torch.nn.ConvTranspose2d(4, 6, k, stride=2, padding=1,
                                     output_padding=1 if k == 3 else 0)
    with torch.no_grad():
        usual.weight.copy_(tmod.weight.flip(2, 3).transpose(0, 1))
        usual.bias.copy_(tmod.bias)
        off = usual(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
    assert off.shape == got.shape
    shifted = (off - got).abs().max().item() > 1e-2
    assert shifted == (k == 3)
    if k == 3:   # the usual form is Flax's a row and a column up-left
        _close(off[:, :-1, :-1], got[:, 1:, 1:].numpy())
    assert jax_params_from_module(tmod)["kernel"].shape == (k, k, 4, 6)


@pytest.mark.parametrize("k,size", [(4, 16), (4, 15), (3, 16)])
def test_strided_same_conv_matches_flax(k, size):
    """Flax pads a stride-2 'SAME' conv (1, 1) at k = 4 and (0, 1) at k = 3
    on an even size: ``Conv2d(same=True)``."""
    x = _rand((2, size, size + 2, 3), 10 + k)
    jmod = nn.Conv(5, (k, k), strides=(2, 2), padding="SAME")
    params = jax_random_params(jmod, x, seed=k)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = load_jax_params(tl.Conv2d(3, 5, k, stride=2, same=True), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got, want)


# ---------------------------------------------------- BatchNorm block
@pytest.mark.parametrize("transpose", [False, True])
def test_conv_bn_act_train_and_eval_match_flax(transpose):
    """Three forwards in training mode (batch statistics, running ones
    updated as 0.99 · ra + 0.01 · biased batch variance), each output and
    the running statistics after it against Flax; then eval mode on the
    running statistics."""
    xs = [_rand((3, 6, 5, 4), 20 + i, scale=1.0 + i) for i in range(3)]
    jmod = jvae._ConvBNAct(8, transpose=transpose)
    params = jax_random_params(jmod, xs[0], seed=1)
    stats = _batch_stats(jmod, xs[0], seed=2)
    tmod = load_jax_params(tvae._ConvBNAct(4, 8, transpose=transpose),
                           params, stats)
    apply = jax.jit(lambda p, s, x, train: jmod.apply(
        {"params": p, "batch_stats": s}, x, train=train,
        mutable=["batch_stats"]), static_argnums=3)
    tmod.train()
    for x in xs:
        want, upd = apply(params, stats, jnp.asarray(x), True)
        stats = upd["batch_stats"]
        got = tmod(torch.from_numpy(x))
        assert got.dtype == torch.float32
        _close(got, want)
        _stats_close(tmod, stats)
    want, _ = apply(params, stats, jnp.asarray(xs[0]), False)
    tmod.eval()
    with torch.no_grad():
        _close(tmod(torch.from_numpy(xs[0])), want)
    # torch's own BatchNorm2d (momentum 0.1, unbiased variance) would not
    torch_bn = torch.nn.BatchNorm2d(8)
    assert torch_bn.momentum == 0.1


# ---------------------------------------------------------- VanillaVAE
@pytest.fixture(scope="module")
def vanilla():
    x = _rand((3, 32, 32, 3), 30)
    jmod = jvae.VanillaVAE(image_size=32, latent_dim=16, hidden_dims=HIDDEN)
    rngs = {"params": jax.random.key(0), "latent": jax.random.key(1)}
    shapes = jax.eval_shape(jmod.init, rngs, x)
    params = _fill(shapes["params"], 31)
    stats = _fill_stats(shapes["batch_stats"], 32)
    tmod = load_jax_params(tvae.VanillaVAE(image_size=32, latent_dim=16,
                                           hidden_dims=HIDDEN), params, stats)
    return dict(x=x, jmod=jmod, params=params, stats=stats, tmod=tmod)


def _fill(shapes, seed):
    """``jax_random_params``'s fill on a shape tree already made."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _fill_stats(shapes, seed):
    """Running statistics: mean normal(0, 0.1), var in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if str(getattr(path[-1], "key", path[-1])) == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_vanilla_vae_encode_decode_generate_match_jax(vanilla):
    v, x = vanilla, vanilla["x"]
    variables = {"params": v["params"], "batch_stats": v["stats"]}
    key = jax.random.key(5)
    eps = np.array(jax.random.normal(key, (3, 16)))
    jz, jmu, jlv = v["jmod"].apply(variables, jnp.asarray(x), key,
                                   method=jvae.VanillaVAE.encode)
    tmod = v["tmod"].eval()
    with torch.no_grad():
        z, mu, log_var = tmod.encode(torch.from_numpy(x), eps=eps)
        for got, want in ((z, jz), (mu, jmu), (log_var, jlv)):
            _close(got, want)
        want = v["jmod"].apply(variables, jz, method=jvae.VanillaVAE.decode)
        got = tmod.decode(torch.from_numpy(np.array(jz)))
        assert got.shape == x.shape and got.dtype == torch.float32
        _close(got, want)
        want = v["jmod"].apply(variables, jnp.asarray(x), key,
                               method=jvae.VanillaVAE.generate)
        _close(tmod.generate(torch.from_numpy(x), eps=eps), want)
        # forward: (recon, mu, log_var), the JAX __call__
        recon, mu2, _ = tmod(torch.from_numpy(x), eps=eps)
        _close(recon, want)
        _close(mu2, jmu)


def test_vanilla_vae_sample_and_loss_match_jax(vanilla):
    v = vanilla
    variables = {"params": v["params"], "batch_stats": v["stats"]}
    key = jax.random.key(9)
    want = v["jmod"].apply(variables, key, 4, method=jvae.VanillaVAE.sample)
    noise = np.array(jax.random.normal(key, (4, 16)))
    tmod = v["tmod"].eval()
    with torch.no_grad():
        got = tmod.sample(4, noise=noise)
        _close(got, want)
        drawn = tmod.sample(2, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (2, 32, 32, 3) and drawn.abs().max() <= 1.0
    recon, x = _rand((3, 32, 32, 3), 40), _rand((3, 32, 32, 3), 41)
    mu, log_var = _rand((3, 16), 42, 0.5), _rand((3, 16), 43, 0.5)
    jl = jvae.VanillaVAE.loss(*map(jnp.asarray, (recon, x, mu, log_var)),
                              0.00025)
    tl_ = tvae.VanillaVAE.loss(*map(torch.from_numpy, (recon, x, mu,
                                                        log_var)), 0.00025)
    assert set(tl_) == set(jl) == {"loss", "recon_loss", "kld"}
    for k in jl:
        _close(tl_[k], jl[k])


def test_vanilla_vae_train_mode_updates_running_stats(vanilla):
    """One forward in training mode: recon, mu and the running statistics
    against Flax's ``mutable=["batch_stats"]``."""
    v, x = vanilla, vanilla["x"]
    key = jax.random.key(3)
    (jrecon, jmu, _), upd = v["jmod"].apply(
        {"params": v["params"], "batch_stats": v["stats"]}, jnp.asarray(x),
        key, train=True, mutable=["batch_stats"])
    tmod = tvae.VanillaVAE(image_size=32, latent_dim=16, hidden_dims=HIDDEN)
    load_jax_params(tmod, v["params"], v["stats"]).train()
    with torch.no_grad():
        recon, mu, _ = tmod(torch.from_numpy(x),
                            eps=np.array(jax.random.normal(key, (3, 16))))
    _close(recon, jrecon)
    _close(mu, jmu)
    _stats_close(tmod, upd["batch_stats"])


# ------------------------------------------------------ VectorQuantizer
def test_vector_quantizer_indices_and_straight_through_gradient():
    """Identical indices (ties to the first, as argmin), the quantized
    latents, the loss, and the gradients of loss + <quantized, g> with
    respect to the latents (straight through) and the codebook."""
    lat = _rand((2, 5, 6, 4), 50, scale=0.05)
    g = _rand((2, 5, 6, 4), 51)
    jmod = jvae.VectorQuantizer(16, 4)
    params = {"codebook": jax.random.uniform(
        jax.random.key(2), (16, 4), minval=-1 / 16, maxval=1 / 16)}

    def f(p, z):
        q, loss, idx = jmod.apply({"params": p}, z)
        return loss + jnp.sum(q * g), (q, loss, idx)

    (_, (jq, jloss, jidx)), (gp, gz) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(lat))
    tmod = load_jax_params(tvae.VectorQuantizer(16, 4),
                           jax.tree_util.tree_map(np.array, params))
    z = torch.from_numpy(lat).requires_grad_(True)
    q, loss, idx = tmod(z)
    (loss + (q * torch.from_numpy(g)).sum()).backward()
    assert idx.shape == (2, 5, 6) and idx.dtype == torch.long
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert len(np.unique(np.asarray(jidx))) > 4
    _close(q, jq)
    _close(loss, jloss)
    for got, want in ((z.grad, gz), (tmod.codebook.grad, gp["codebook"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    # straight through: d(quantized)/d(latents) is the identity
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(gz), atol=1e-5)


def test_vqvae_forward_matches_jax():
    x = _rand((2, 32, 32, 3), 60)
    hidden = (8, 16, 32)
    jmod = jvae.VQVAE(num_embeddings=16, hidden_dims=hidden)
    params = _fill(jax.eval_shape(jmod.init, jax.random.key(0), x)["params"],
                   61)
    # a codebook near the encoder's latents, so many codes are used
    params["vq"]["codebook"] = _rand((16, 4), 62, scale=0.05)
    jrecon, jloss, jidx = jax.jit(jmod.apply)({"params": params},
                                              jnp.asarray(x))
    tmod = load_jax_params(tvae.VQVAE(num_embeddings=16, hidden_dims=hidden),
                           params).eval()
    with torch.no_grad():
        recon, loss, idx = tmod(torch.from_numpy(x))
        gen = tmod.generate(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.shape == (2, 4, 4)
    _close(recon, jrecon)
    _close(gen, jrecon)
    _close(loss, jloss)
    with pytest.raises(NotImplementedError):
        tmod.sample(2)
    jl = jvae.VQVAE.loss(jrecon, jnp.asarray(x), jloss)
    tl_ = tvae.VQVAE.loss(recon, torch.from_numpy(x), loss)
    for k in jl:
        _close(tl_[k], jl[k])


# -------------------------------------------------------------- SDVAE
def test_sdvae_matches_jax_with_its_noise():
    """The SD3 pair at its published width on a 16² image: encode with
    JAX's noise (log-variance clamped to [-30, 20]), decode, and the whole
    round trip; atol = rtol = 1e-4."""
    x = _rand((1, 16, 16, 3), 70)
    jmod = jsd3vae.SDVAE()
    key = jax.random.key(4)
    params = jax_random_params(jmod, x, key, seed=71)
    jz = jax.jit(lambda p, a: jmod.apply({"params": p}, a, key,
                                         method=jsd3vae.SDVAE.encode))(
        params, jnp.asarray(x))
    want = jax.jit(lambda p, a: jmod.apply({"params": p}, a, key))(
        params, jnp.asarray(x))
    h = jax.jit(lambda p, a: jmod.apply(
        {"params": p}, a, method=lambda m, a: m.encoder(a)))(params,
                                                             jnp.asarray(x))
    noise = np.array(jax.random.normal(key, (1, 2, 2, 16)))
    tmod = load_jax_params(tsd3vae.SDVAE(), params).eval()
    with torch.no_grad():
        z = tmod.encode(torch.from_numpy(x), noise=noise)
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-4,
                                   rtol=1e-4)
        got = tmod(torch.from_numpy(x), noise=noise)
        drawn = tmod.encode(torch.from_numpy(x),
                            generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert got.shape == (1, 16, 16, 3) and drawn.shape == (1, 2, 2, 16)
    assert np.asarray(h).shape == (1, 2, 2, 32)


# ------------------------------------------------ config and trainer
def test_vae_train_config_matches_jax(tmp_path):
    jf = [f.name for f in dataclasses.fields(jconfig.VAETrainConfig)]
    assert [f.name for f in dataclasses.fields(tconfig.VAETrainConfig)] == jf
    assert (dataclasses.asdict(tconfig.VAETrainConfig())
            == dataclasses.asdict(jconfig.VAETrainConfig()))
    path = tmp_path / "vae.yml"
    path.write_text("epoch: 3\nmodel: vanilla\nlatent_dim: 64\n")
    assert (dataclasses.asdict(tconfig.VAETrainConfig.from_yaml(str(path)))
            == dataclasses.asdict(jconfig.VAETrainConfig.from_yaml(
                str(path))))


STEPS = 3
TRAIN = dict(epoch=1, batch_size=4, img_size=32, latent_dim=16,
             num_embeddings=16, dtype="fp32", lr=1e-4, seed=0)


def _latent_eps(jt, step, shape, seed):
    """The VanillaVAE's noise in the JAX step ``step``: the first
    ``make_rng("latent")`` under ``fold_in(key(seed + 2), step)``."""
    rng = jax.random.fold_in(jax.random.key(seed + 2), step)
    key = jt.model.apply({}, method=lambda m: m.make_rng("latent"),
                         rngs={"latent": rng})
    return np.array(jax.random.normal(key, shape, jnp.float32))


def _anchored_state(trainer, jstate):
    """A port state holding a JAX state's parameters, running statistics,
    AdamW moments and counts."""
    numpy = lambda tree: (None if tree is None else
                          jax.tree_util.tree_map(np.array, tree))
    state = trainer.create_state(params=numpy(jstate.params),
                                 batch_stats=numpy(jstate.batch_stats))
    adam = jstate.opt_state[0]
    mu, nu = port_flat_jax(adam.mu), port_flat_jax(adam.nu)
    count = int(adam.count)
    for name, p in state.model.named_parameters():
        if count:
            state.optimizer.state[p] = dict(
                step=torch.tensor(float(count)),
                exp_avg=torch.from_numpy(mu[name]),
                exp_avg_sq=torch.from_numpy(nu[name]))
    state.step = state.updates = count
    return state


@pytest.fixture(scope="module", params=["vanilla", "vqvae"])
def vae_run(request):
    """Three steps of the JAX VAETrainer from its own init; the port's
    trainer fed the same noise, chained from the same initial parameters
    (and running statistics), and step by step from each JAX state.

    Chained, the VanillaVAE's steps drift apart: its first AdamW step moves
    each parameter by ±lr, and where a gradient is rounding noise (the
    biases above, a few weights) the two frameworks pick opposite signs;
    BatchNorm over a batch of 4 at 1² and 2² amplifies that into gradients
    ~1e-3 apart (lr 1e-3: ~1e-2) at the next step. So each step is held
    from the same state, its moments included, and the chained run to the
    loss and the bound alone."""
    model = request.param
    jcfg = jconfig.VAETrainConfig(model=model, **TRAIN)
    jt = jvae_trainer.VAETrainer(jcfg, mesh=one_device_mesh())
    jstate = jt.create_state()
    images = [_rand((4, 32, 32, 3), 80 + i) for i in range(STEPS)]
    rng = jax.random.key(jcfg.seed + 2)
    jax_states, jax_steps = [jax.tree_util.tree_map(np.array, jstate)], []
    for i, x in enumerate(images):
        eps = _latent_eps(jt, i, (4, 16), jcfg.seed)
        jstate, metrics = jt.train_step(jstate, x, rng)
        jax_states.append(jax.tree_util.tree_map(np.array, jstate))
        jax_steps.append(dict(
            eps=eps, loss=float(metrics["loss"]),
            params=port_flat_jax(jstate.params),
            stats=(None if jstate.batch_stats is None
                   else port_flat_jax(jstate.batch_stats))))
    trainer = VAETrainer(tconfig.VAETrainConfig(model=model, **TRAIN),
                         device="cpu")
    anchored, grads = [], []
    for i, (x, js) in enumerate(zip(images, jax_steps)):
        state, metrics = trainer.train_step(
            _anchored_state(trainer, jax_states[i]), x, eps=js["eps"])
        grads.append({n: p.grad.numpy().copy()
                      for n, p in state.model.named_parameters()})
        anchored.append(dict(
            metrics={k: v.item() for k, v in metrics.items()},
            params=port_flat(state.params),
            stats={n: b.numpy().copy()
                   for n, b in state.model.named_buffers()}))
    state = _anchored_state(trainer, jax_states[0])
    chained = []
    for x, js in zip(images, jax_steps):
        state, metrics = trainer.train_step(state, x, eps=js["eps"])
        chained.append(dict(loss=metrics["loss"].item(),
                            params=port_flat(state.params)))
    return dict(model=model, jax=jax_steps, port=anchored, chained=chained,
                grads=grads, trainer=trainer, state=state, images=images)


def _bn_fed_biases(names):
    """The conv biases a BatchNorm in training mode normalises away."""
    return {n for n in names
            if re.fullmatch(r"(enc\d+|dec\d+|final_up)\.conv\.bias", n)}


@pytest.mark.parametrize("i", range(STEPS))
def test_vae_train_steps_match_jax(vae_run, i):
    """Step i from the JAX state before it: loss, parameters (AdamW
    tolerance, one update), running statistics."""
    js, ps = vae_run["jax"][i], vae_run["port"][i]
    np.testing.assert_allclose(ps["metrics"]["loss"], js["loss"], rtol=1e-5)
    bound = lr_bound(lambda count: TRAIN["lr"], 1)
    dead = _bn_fed_biases(ps["params"])
    # 5 encoder and 4 decoder stages and final_up; the VQ-VAE has no BN
    assert len(dead) == (10 if vae_run["model"] == "vanilla" else 0)
    live = lambda d: {n: a for n, a in d.items() if n not in dead}
    assert_adamw_close(live(ps["params"]), live(js["params"]), bound,
                       "params")
    for name in dead:
        assert np.abs(ps["params"][name] - js["params"][name]).max() <= bound
        grad, w = vae_run["grads"][i][name], vae_run["grads"][i][
            name.replace("bias", "weight")]
        assert np.abs(grad).max() <= 1e-5 * np.abs(w).max()
    if vae_run["model"] == "vanilla":
        assert set(ps["stats"]) == set(js["stats"])
        for name, w in js["stats"].items():
            _close(ps["stats"][name], w)
    else:
        assert js["stats"] is None and ps["stats"] == {}


@pytest.mark.parametrize("i", range(STEPS))
def test_vae_chained_train_steps_match_jax(vae_run, i):
    """Three chained steps from the same init: the loss within 1e-5, every
    parameter within the sum of 2·lr over the updates; the VQ-VAE (no
    BatchNorm) also within the AdamW tolerance."""
    js, ps = vae_run["jax"][i], vae_run["chained"][i]
    np.testing.assert_allclose(ps["loss"], js["loss"], rtol=1e-5)
    bound = lr_bound(lambda count: TRAIN["lr"], i + 1)
    for name, w in js["params"].items():
        assert np.abs(ps["params"][name] - w).max() <= bound, name
    if vae_run["model"] == "vqvae":
        assert_adamw_close(ps["params"], js["params"], bound, "params")


def test_vae_trainer_reconstruct_fit_and_checkpoint(vae_run, tmp_path):
    """``reconstruct`` in eval mode, then ``fit`` for one epoch with a
    checkpoint (the running statistics in it) and a preview PNG."""
    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        DataLoader, SyntheticImageDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    trainer, state = vae_run["trainer"], vae_run["state"]
    x = vae_run["images"][0]
    recon = trainer.reconstruct(state, x)
    assert recon.shape == x.shape and bool(torch.isfinite(recon).all())
    assert not state.model.training
    loader = DataLoader(SyntheticImageDataset(8, 32), 4)
    state = trainer.fit(loader, state, epochs=1,
                        checkpoint_dir=str(tmp_path / "ckpt"),
                        preview_batch=x[:2], preview_dir=str(tmp_path / "pv"))
    assert state.updates == STEPS + 2 and len(trainer.history) == 1
    png = (tmp_path / "pv" / "recon_epoch000.png").read_bytes()
    assert png.startswith(b"\x89PNG")
    saved, step = CheckpointManager(str(tmp_path / "ckpt")).restore()
    assert step == 0
    assert set(saved["buffers"]) == {n for n, _ in
                                     state.model.named_buffers()}
    fresh = trainer.create_state()
    fresh.load_state_dict(saved)
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), n


def test_vae_trainer_refuses_a_mesh_and_an_unknown_model():
    # a data mesh is taken (tests/test_torch_data_mesh.py holds its steps)
    meshed = VAETrainer(tconfig.VAETrainConfig(), device="cuda",
                        mesh=build_mesh({"data": 2},
                                        [torch.device("cpu")] * 2))
    assert meshed.device == torch.device("cpu") and meshed.data.n == 2
    with pytest.raises(ValueError, match="unknown VAE model"):
        VAETrainer(tconfig.VAETrainConfig(model="beta"), device="cpu")


def test_vae_trainer_random_init():
    """Flax's default initializers: BatchNorm statistics (0, 1), the VQ
    codebook uniform(-1/K, 1/K), seeded."""
    for model in ("vanilla", "vqvae"):
        cfg = tconfig.VAETrainConfig(model=model, **TRAIN)
        a = VAETrainer(cfg, device="cpu").create_state()
        b = VAETrainer(cfg, device="cpu").create_state()
        for (n, p), (_, q) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
            assert torch.equal(p, q), n
        for name, buf in a.model.named_buffers():
            want = 0.0 if name.endswith("mean") else 1.0
            assert bool((buf == want).all()), name
        if model == "vqvae":
            cb = a.model.vq.codebook
            assert cb.abs().max() <= 1 / 16 and cb.std() > 0


@pytest.mark.parametrize("model", ["vanilla", "vqvae"])
def test_vae_cli_trains_on_synthetic_images(model, tmp_path):
    """``vae train --synthetic`` at 32², batch 2, one epoch on the CPU: the
    checkpoint and the preview PNG (4 images over their reconstructions)."""
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import vae

    assert vae.main(["train", "--model", model, "--synthetic", "--img-size",
                     "32", "--batch-size", "2", "--epochs", "1",
                     "--model-dir", str(tmp_path / "ckpt"), "--preview-dir",
                     str(tmp_path / "pv"), "--device", "cpu"]) == 0
    assert (tmp_path / "ckpt" / "0" / "state.pt").is_file()
    from PIL import Image

    with Image.open(tmp_path / "pv" / "recon_epoch000.png") as im:
        assert np.asarray(im).shape == (2 * 32, 4 * 32, 3)
