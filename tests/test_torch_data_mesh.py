"""The VAE, ViT, CLIP and VLM trainers on a data mesh of 2, the port's
one-process form (a) (the host device repeated) against the JAX trainers on
XLA's virtual host devices (conftest's 8), one step from the same
parameters with the same noise; and form (a) bit for bit against the
meshless port step, since it is the identity. Form (b), over gloo ranks, is
held against form (a) in ``tests/test_torch_parallel_dist.py``.

Tolerances are those of each trainer's own JAX-parity test
(``tests/test_torch_{vae,vit,clip,vlm}.py``): the loss within rtol 1e-5,
the parameters within the AdamW tolerance of
``torch_trainer_parity.assert_adamw_close`` (the VLM's test: at most 1 in
10^3 elements past 1e-5 rather than 1 in 10^4; the gradients that are
rounding noise, the key biases and the conv biases a BatchNorm normalises
away, within the bound alone), the running statistics within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import test_torch_clip as tc
import test_torch_vae as tv
import test_torch_vit as tvi
import test_torch_vlm as tvl
from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    clip_trainer as jclip_trainer, vae_trainer as jvae_trainer,
    vit_trainer as jvit_trainer, vlm_trainer as jvlm_trainer)
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu_torch.models import clip as tclip
from from_ddpm_to_stable_diffusion_tpu_torch.models import siglip as tsig
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import (
    build_mesh as tbuild_mesh)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.clip_trainer import (
    MAX_LOGIT_SCALE, CLIPTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vae_trainer import (
    VAETrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vit_trainer import (
    ViTTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vlm_trainer import (
    VLMTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from torch_trainer_parity import (assert_adamw_close, lr_bound, port_flat,
                                  port_flat_jax)

N = 2


def _jax_mesh():
    return build_mesh({"data": N}, jax.devices()[:N])


def _port_mesh():
    return tbuild_mesh({"data": N}, [torch.device("cpu")] * N)


def _split(params, dead_of):
    """(live, dead) parameters: ``dead_of(name, array)`` -> the elements
    whose gradient is rounding noise (None: none)."""
    live, dead = {}, {}
    for n, a in params.items():
        cut = dead_of(n, a)
        if cut is None:
            live[n] = a
        else:
            if cut[0].size:
                live[n] = cut[0]
            dead[n] = cut[1]
    return live, dead


def _key_bias(n, a):
    if not n.endswith("qkv.bias"):
        return None
    c = a.shape[0] // 3
    return np.concatenate([a[:c], a[2 * c:]]), a[c:2 * c]


def _bn_bias(n, a):
    return (np.zeros(0, a.dtype), a) if n in tv._bn_fed_biases([n]) else None


def _vae():
    jcfg = jconfig.VAETrainConfig(model="vanilla", **tv.TRAIN)
    jt = jvae_trainer.VAETrainer(jcfg, mesh=_jax_mesh())
    jstate = jax.tree_util.tree_map(np.array, jt.create_state())
    x = tv._rand((4, 32, 32, 3), 80)
    eps = tv._latent_eps(jt, 0, (4, tv.TRAIN["latent_dim"]), jcfg.seed)
    jnext, metrics = jt.train_step(jstate, x, jax.random.key(jcfg.seed + 2))
    want = dict(loss=float(metrics["loss"]),
                params=port_flat_jax(jnext.params),
                stats=port_flat_jax(jnext.batch_stats))

    def port(mesh):
        trainer = VAETrainer(tconfig.VAETrainConfig(model="vanilla",
                                                    **tv.TRAIN),
                             device="cpu", mesh=mesh)
        state, m = trainer.train_step(tv._anchored_state(trainer, jstate), x,
                                      eps=eps)
        return dict(loss=m["loss"].item(), params=port_flat(state.params),
                    stats={n: b.numpy().copy()
                           for n, b in state.model.named_buffers()})

    return want, port, lambda c: tv.TRAIN["lr"], _bn_bias


def _vit():
    jcfg = jconfig.ViTTrainConfig(**tvi.TRAIN)
    jt = jvit_trainer.ViTTrainer(jcfg, mesh=_jax_mesh())
    params0 = jax.tree_util.tree_map(np.array, jt.create_state().params)
    images = tv._rand((4, 32, 32, 3), 81)
    labels = np.array([0, 1, 2, 0])
    jstate, loss, _ = jt.train_step(jt.create_state(), images, labels,
                                    jax.random.key(jcfg.seed + 1))
    want = dict(loss=float(loss), params=port_flat_jax(jstate.params))

    def port(mesh):
        trainer = ViTTrainer(tconfig.ViTTrainConfig(**tvi.TRAIN),
                             device="cpu", mesh=mesh)
        state, loss, _ = trainer.train_step(
            trainer.create_state(params=params0), images, labels)
        return dict(loss=loss.item(), params=port_flat(state.params))

    return want, port, lambda c: tvi.TRAIN["lr"], _key_bias


def _clip():
    import jax.numpy as jnp

    from from_ddpm_to_stable_diffusion_tpu.models import clip as jclip
    from test_torch_models import jax_random_params

    jt = jclip_trainer.CLIPTrainer(jclip.CLIP(**tc.SMALL), lr=tc.LR,
                                   weight_decay=tc.WD, mesh=_jax_mesh())
    params = jax_random_params(jclip.CLIP(**tc.SMALL),
                               jnp.zeros((1, 28, 28, 3)),
                               jnp.zeros((1, 10), jnp.int32), seed=7)
    params["logit_scale"] = np.float32(MAX_LOGIT_SCALE + 0.01)
    jstate = jt.create_state((28, 28, 3), 10)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                            opt_state=jstate.tx.init(params))
    images, tokens = tc._rand((4, 28, 28, 3), 10), tc._tokens(4, 20)
    jstate, loss = jt.train_step(jstate, images, tokens)
    want = dict(loss=float(loss), params=port_flat_jax(jstate.params))

    def port(mesh):
        trainer = CLIPTrainer(tclip.CLIP(**tc.SMALL), lr=tc.LR,
                              weight_decay=tc.WD, device="cpu", mesh=mesh)
        state, loss = trainer.train_step(
            trainer.create_state((28, 28, 3), 10, params=params), images,
            tokens)
        return dict(loss=loss.item(), params=port_flat(state.params))

    return want, port, lambda c: tc.LR, _key_bias


def _vlm():
    import jax.numpy as jnp

    jmod, _ = tvl._models()
    params = tvl._params()
    images, tokens = tvl._batch(4, seed=1)
    tokens[2:, 4:] = 0          # the halves hold different target counts
    jt = jvlm_trainer.VLMTrainer(jmod, **tvl.OPT, mesh=_jax_mesh())
    jstate = jt.create_state(32)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.array, params))
    # two updates: the first one's rate is 0 (warmup from 0)
    for _ in range(2):
        jstate, loss = jt.train_step(jstate, images, tokens)
    want = dict(loss=float(loss), params=port_flat_jax(jstate.params))

    def port(mesh):
        trainer = VLMTrainer(tvl.VOCAB, **tvl.MODEL, **tvl.OPT, device="cpu",
                             vision_cfg=tsig.SiglipVisionConfig(**tvl.VISION),
                             mesh=mesh)
        state = trainer.create_state(32, params=params)
        for _ in range(2):
            state, loss = trainer.train_step(state, images, tokens)
        return dict(loss=loss.item(), params=port_flat(state.params))

    return want, port, tvl._schedule(), lambda n, a: None


CASES = {"vae": _vae, "vit": _vit, "clip": _clip, "vlm": _vlm}


@pytest.mark.parametrize("name", CASES)
def test_trainer_on_a_data_mesh_matches_jax(name):
    want, port, schedule, dead_of = CASES[name]()
    got = port(_port_mesh())
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    bound = lr_bound(schedule, 2 if name == "vlm" else 1)
    (live, dead), (want_live, want_dead) = (
        _split(got["params"], dead_of), _split(want["params"], dead_of))
    if name == "vlm":        # tests/test_torch_vlm.py's own tolerance
        off = sum(int((np.abs(live[n] - w) > 1e-5 + 1e-5 * np.abs(w)).sum())
                  for n, w in want_live.items())
        assert all(np.abs(live[n] - w).max() <= bound
                   for n, w in want_live.items())
        assert off <= 1e-3 * sum(w.size for w in want_live.values()), off
    else:
        assert_adamw_close(live, want_live, bound, name)
    for n, w in want_dead.items():
        assert np.abs(dead[n] - w).max() <= bound, n
    for n, w in want.get("stats", {}).items():
        np.testing.assert_allclose(got["stats"][n], w, rtol=1e-5, atol=1e-6)
    # form (a) is the identity: the meshless step, bit for bit
    alone = port(None)
    assert alone["loss"] == got["loss"]
    for n, w in alone["params"].items():
        np.testing.assert_array_equal(got["params"][n], w, err_msg=n)
