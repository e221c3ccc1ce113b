"""Parity of the port's TinyVLM slice with the JAX package, on the CPU: the
SigLIP vision tower, the TinyVLM forward, ``vlm_loss``, ``greedy_decode``,
three ``VLMTrainer.train_step``s, the parameter tree both ways and the
copied captioned-shapes datasets.

The model is small (tower and decoder of 2 layers, width 64, 2 heads of 32,
32x32 images in 8x8 patches: 16 patch tokens + 8 text tokens). Parameters
are numpy draws loaded into both packages; images and tokens come from a
numpy seed or from the dataset.

Tolerances. fp32: outputs of order 1 to 2e-5 absolute; the loss rtol 1e-5;
parameters after AdamW within 1e-5 but for at most 1 element in 10^3, none
further than 2*lr per update (Adam turns a gradient within rounding noise
of 0 into a step of up to lr either way). bf16 compute over fp32 parameters:
the forward to 3e-2 of the output's largest magnitude (every linear rounds
its output to bf16, 8 significant bits, through four layers); the loss rtol
2e-2; parameters: the summed absolute difference below a tenth of the summed
absolute movement.
"""

import ast
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.io import shapes_dataset as jds
from from_ddpm_to_stable_diffusion_tpu.models import siglip as jsig
from from_ddpm_to_stable_diffusion_tpu.models import tiny_vlm as jvlm
from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu.pipelines import vlm_trainer as jtrainer
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh as tbuild_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.io import shapes_dataset as tds
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    jax_params_from_module, load_jax_params, state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import siglip as tsig
from from_ddpm_to_stable_diffusion_tpu_torch.models import tiny_vlm as tvlm
from from_ddpm_to_stable_diffusion_tpu_torch.ops import schedules as tsched
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vlm_trainer import (
    VLMTrainer)
from test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

VISION = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=2, image_size=32, patch_size=8)
MODEL = dict(dim=64, depth=2, num_heads=2, max_text_len=8)
VOCAB = len(tds.VLM_VOCAB)
OPT = dict(lr=1e-3, weight_decay=0.01, warmup_steps=2, total_steps=6)
STEPS = 3     # update 0 at lr 0, update 1 in the warmup, update 2 at the peak
DTYPES = {"fp32": (None, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _models(dtype="fp32"):
    tdt, jdt = DTYPES[dtype]
    jmod = jvlm.TinyVLM(VOCAB, **MODEL, dtype=jdt,
                        vision_cfg=jsig.SiglipVisionConfig(**VISION))
    tmod = tvlm.TinyVLM(VOCAB, **MODEL, compute_dtype=tdt,
                        vision_cfg=tsig.SiglipVisionConfig(**VISION))
    return jmod, tmod


def _batch(b=4, seed=0):
    ds = tds.CaptionedShapesDataset(64, img_size=32, seed=seed)
    images, tokens = zip(*(ds.load(i) for i in range(b)))
    return np.stack(images), np.stack(tokens)


def _params(seed=3):
    images, tokens = _batch(1)
    return jax_random_params(_models()[0], images, tokens, seed=seed)


# ------------------------------------------------------------- the dataset
@pytest.mark.parametrize("name,kw", [
    ("ShapesDataset", dict(img_size=32, seed=3)),
    ("CaptionedShapesDataset", dict(img_size=48, seed=5)),
    ("VQAShapesDataset", dict(img_size=32, seed=7))])
def test_copied_dataset_is_byte_identical(name, kw):
    want, got = getattr(jds, name)(12, **kw), getattr(tds, name)(12, **kw)
    assert len(got) == len(want) == 12
    for i in range(12):
        (wi, wt), (gi, gt) = want.load(i), got.load(i)
        assert gi.dtype == wi.dtype and gi.tobytes() == wi.tobytes()
        assert np.asarray(gt).tobytes() == np.asarray(wt).tobytes()
    if name != "ShapesDataset":
        assert got.vocab == want.vocab and got.decode(gt) == want.decode(wt)
    for const in ("VLM_VOCAB", "VLM_PAD", "VLM_BOS", "VLM_EOS",
                  "VQA_ANSWER_START"):
        assert getattr(tds, const) == getattr(jds, const)
    assert list(tds.VQA_QUESTIONS) == list(jds.VQA_QUESTIONS)


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_siglip_vision_model_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    jmod = jsig.SiglipVisionModel(jsig.SiglipVisionConfig(**VISION), dtype=jdt)
    params = jax_random_params(jmod, x, seed=2)
    want = np.asarray(jmod.apply({"params": params}, x), np.float32)
    tmod = load_jax_params(tsig.SiglipVisionModel(
        tsig.SiglipVisionConfig(**VISION), compute_dtype=tdt), params)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 16, 64)
    assert str(got.dtype).split(".")[-1] == jnp.dtype(jdt).name
    atol = 2e-5 if dtype == "fp32" else 3e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_siglip_position_table_follows_the_image_size():
    cfg = tsig.SiglipVisionConfig(**VISION)
    big = tsig.SiglipVisionModel(cfg, image_size=48)
    assert big.position_embedding.shape == (36, 64)
    with torch.no_grad():
        assert big(torch.zeros(1, 48, 48, 3)).shape == (1, 36, 64)
    with pytest.raises(ValueError, match="patches"):
        big(torch.zeros(1, 32, 32, 3))
    assert (tsig.SiglipVisionConfig() == tsig.SiglipVisionConfig(
        **{f: getattr(jsig.SiglipVisionConfig(), f)
           for f in jsig.SiglipVisionConfig.__dataclass_fields__}))
    assert tvlm.TINY_VISION.__dict__ == jvlm.TINY_VISION.__dict__


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_tiny_vlm_forward_matches_jax(dtype):
    jmod, tmod = _models(dtype)
    images, tokens = _batch()
    params = _params()
    want = np.asarray(jmod.apply({"params": params}, images, tokens))
    load_jax_params(tmod, params)
    assert {p.dtype for p in tmod.parameters()} == {torch.float32}
    with torch.no_grad():
        got = tmod(torch.from_numpy(images), torch.from_numpy(tokens))
    assert got.shape == (4, 8, VOCAB) and got.dtype == torch.float32
    atol = 2e-5 if dtype == "fp32" else 3e-2 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    if dtype == "bf16":     # and it is the bf16 computation, not the fp32 one
        exact = load_jax_params(_models()[1], params)
        with torch.no_grad():
            diff = got - exact(torch.from_numpy(images),
                               torch.from_numpy(tokens))
        assert diff.abs().max() > 1e-4


@pytest.mark.parametrize("answer_start", [0, 1, 4])
def test_vlm_loss_matches_jax(answer_start):
    r = np.random.default_rng(5)
    logits = r.standard_normal((3, 8, VOCAB)).astype(np.float32)
    tokens = r.integers(0, VOCAB, (3, 8)).astype(np.int32)
    tokens[0, 5:] = 0
    tokens[1] = 0                           # a row of padding only
    want = float(jvlm.vlm_loss(jnp.asarray(logits), jnp.asarray(tokens),
                               answer_start=answer_start))
    got = tvlm.vlm_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                        answer_start=answer_start)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    empty = tvlm.vlm_loss(torch.from_numpy(logits),
                          torch.zeros((3, 8), dtype=torch.int32))
    assert empty.item() == 0.0


@pytest.mark.parametrize("prompt", [None, "1d", "2d"])
def test_greedy_decode_matches_jax(prompt):
    jmod, tmod = _models()
    images, _ = _batch(3)
    params = _params(seed=11)
    load_jax_params(tmod, params).train()
    q = tds.VQAShapesDataset(4, 32).encode_question("what color ?")
    prompt_ids = {None: None, "1d": q, "2d": np.stack([q, q, q])}[prompt]
    want = np.asarray(jvlm.greedy_decode(jmod, params, jnp.asarray(images),
                                         prompt_ids=prompt_ids))
    got = tvlm.greedy_decode(tmod, images, prompt_ids=prompt_ids)
    assert got.dtype == torch.int32 and tmod.training
    np.testing.assert_array_equal(got.numpy(), want)
    if prompt is not None:
        np.testing.assert_array_equal(got.numpy()[:, :4], np.stack([q] * 3))
    assert (got.numpy()[:, 0] == tds.VLM_BOS).all()


# --------------------------------------------------- the slice as a whole
def _run(dtype):
    """STEPS updates of the JAX trainer from seeded parameters, and the
    port's trainer from the same tree on the same batches."""
    jmod, _ = _models(dtype)
    params = _params()
    batches = [_batch(4, seed=s) for s in range(STEPS)]
    jt = jtrainer.VLMTrainer(jmod, **OPT, mesh=build_mesh(
        {"data": 1}, jax.devices()[:1]))
    state = jt.create_state(32)
    state = state.replace(params=jax.tree_util.tree_map(jnp.array, params))
    jax_steps = []
    for images, tokens in batches:
        state, loss = jt.train_step(state, images, tokens)
        jax_steps.append(dict(loss=float(loss), params=jax.tree_util.tree_map(
            np.array, state.params)))
    trainer = VLMTrainer(VOCAB, **MODEL, **OPT, dtype=dtype, device="cpu",
                         vision_cfg=tsig.SiglipVisionConfig(**VISION))
    tstate = trainer.create_state(32, params=params)
    port_steps = []
    for images, tokens in batches:
        tstate, loss = trainer.train_step(tstate, images, tokens)
        port_steps.append(dict(loss=loss.item(), params={
            n: p.detach().numpy().copy() for n, p in tstate.params.items()}))
    return dict(params=params, jax=jax_steps, port=port_steps, jax_model=jmod,
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


def _schedule():
    return tsched.warmup_cosine_decay_lr(0.0, OPT["lr"], OPT["warmup_steps"],
                                         OPT["total_steps"],
                                         end_lr=0.1 * OPT["lr"])


def test_schedule_is_optax_warmup_cosine_decay():
    import optax

    for lr, warm, total in ((3e-4, 100, 2000), (1e-3, 2, 6), (1e-3, 5, 3)):
        total = max(total, warm + 1)
        want = optax.warmup_cosine_decay_schedule(0.0, lr, warm, total,
                                                  end_value=0.1 * lr)
        got = tsched.warmup_cosine_decay_lr(0.0, lr, warm, total,
                                            end_lr=0.1 * lr)
        for count in (0, 1, warm - 1, warm, warm + 1, total - 1, total,
                      total + 7):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-5, atol=1e-12)
    assert _schedule()(0) == 0.0           # the first update moves nothing


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_loss_matches_jax(run_fp32, i):
    np.testing.assert_allclose(run_fp32["port"][i]["loss"],
                               run_fp32["jax"][i]["loss"], rtol=1e-5)


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_params_match_jax(run_fp32, i):
    start = _flat(run_fp32["params"])
    want, got = _flat(run_fp32["jax"][i]["params"]), run_fp32["port"][i][
        "params"]
    assert set(got) == set(want)
    bound = sum(2 * _schedule()(c) for c in range(i + 1)) + 1e-6
    off = total = 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= bound, f"{name}: {diff.max()}"
        off += int((diff > 1e-5 + 1e-5 * np.abs(w)).sum())
        total += diff.size
    assert off <= 1e-3 * total, f"{off} of {total} elements off"
    moved = max(np.abs(got[n] - start[n]).max() for n in start)
    if i == 0:      # lr 0 at update 0: nothing moves, in either package
        assert moved == 0.0
        assert all(np.array_equal(want[n], start[n]) for n in start)
    else:
        assert moved > 1e-4


@pytest.mark.parametrize("i", range(STEPS))
def test_train_step_bf16_compute_matches_jax(run_bf16, i):
    js, ps = run_bf16["jax"][i], run_bf16["port"][i]
    np.testing.assert_allclose(ps["loss"], js["loss"], rtol=2e-2)
    start, want = _flat(run_bf16["params"]), _flat(js["params"])
    bound = sum(2 * _schedule()(c) for c in range(i + 1)) + 1e-6
    diff = moved = 0.0
    for name, w in want.items():
        assert ps["params"][name].dtype == np.float32
        d = np.abs(ps["params"][name] - w)
        assert d.max() <= bound, f"{name}: {d.max()}"
        diff += d.sum()
        moved += np.abs(w - start[name]).sum()
    assert diff <= 0.1 * moved + 1e-12, f"{diff} vs {moved}"
    if i:
        assert moved > 0
    assert run_bf16["state"].model.compute_dtype == torch.bfloat16


def test_accuracies_match_jax(run_fp32):
    """Greedy captions and answers of the trained states on held-out
    examples: the same exact-match counts in both packages."""
    jt, tt = run_fp32["jax_trainer"], run_fp32["trainer"]
    for name, (jset, tset) in dict(
            caption_accuracy=(jds.CaptionedShapesDataset(6, 32, seed=9),
                              tds.CaptionedShapesDataset(6, 32, seed=9)),
            qa_accuracy=(jds.VQAShapesDataset(6, 32, seed=9, max_len=8),
                         tds.VQAShapesDataset(6, 32, seed=9, max_len=8)),
    ).items():
        want = getattr(jt, name)(run_fp32["jax_state"], jset, n=6,
                                 batch_size=4)
        got = getattr(tt, name)(run_fp32["state"], tset, n=6, batch_size=4)
        assert got == want and 0.0 <= got <= 1.0


def test_param_tree_round_trip_and_jax_runs_the_ported_weights(run_fp32):
    model, params = run_fp32["state"].model, run_fp32["params"]
    fresh = load_jax_params(_models()[1], params)
    back = jax_params_from_module(fresh)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, w) in zip(got, want):
        np.testing.assert_array_equal(a, w)
    sd = state_dict_from_jax(params)
    assert sd["vision.patch_embedding.weight"].shape == (64, 3, 8, 8)
    assert sd["vision.position_embedding"].shape == (16, 64)
    assert sd["tok.weight"].shape == (VOCAB, 64) and sd["text_pos"].shape == (
        8, 64)
    images, tokens = _batch(2, seed=4)
    want_out = run_fp32["jax_model"].apply(
        {"params": jax_params_from_module(model)}, images, tokens)
    with torch.no_grad():
        got_out = model.eval()(torch.from_numpy(images),
                               torch.from_numpy(tokens))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=2e-5, rtol=1e-5)


# -------------------------------------------------------- entry points
def test_trainer_defaults_to_the_card_and_seeds_its_state():
    default = inspect.signature(VLMTrainer.__init__).parameters["device"]
    assert str(default.default) == "cuda"
    for name in ("lr", "weight_decay", "warmup_steps", "total_steps", "seed",
                 "answer_start"):
        assert (inspect.signature(VLMTrainer.__init__).parameters[name].default
                == inspect.signature(
                    jtrainer.VLMTrainer.__init__).parameters[name].default)
    make = lambda: VLMTrainer(
        VOCAB, **MODEL, device="cpu",
        vision_cfg=tsig.SiglipVisionConfig(**VISION)).create_state(32)
    a, b = make(), make()
    assert a.step == 0 and a.ema_params is None
    for (n, p), (_, q) in zip(a.params.items(), b.params.items()):
        assert p.device.type == "cpu" and p.dtype == torch.float32
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    # Flax's defaults: zero biases, unit scales, lecun-normal kernels, a
    # fan-in normal Embed table and the two normal(0.02) position tables
    assert not a.params["block0.attn.qkv.bias"].any()
    assert bool((a.params["ln_f.weight"] == 1).all())
    np.testing.assert_allclose(a.params["block0.fc1.weight"].std().item(),
                               64 ** -0.5, rtol=0.05)
    np.testing.assert_allclose(a.params["tok.weight"].std().item(),
                               64 ** -0.5, rtol=0.1)
    for name in ("text_pos", "vision.position_embedding"):
        np.testing.assert_allclose(a.params[name].std().item(), 0.02,
                                   rtol=0.15)
    shapes = jax.eval_shape(_models()[0].init, jax.random.key(0),
                            *_batch(1))["params"]
    assert VLMTrainer(VOCAB, **MODEL, device="cpu",
                      vision_cfg=tsig.SiglipVisionConfig(
                          **VISION)).num_params(a) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


def test_fit_learns_the_captions_of_a_fixed_batch():
    trainer = VLMTrainer(VOCAB, **MODEL, lr=3e-3, warmup_steps=2,
                         total_steps=40, device="cpu",
                         vision_cfg=tsig.SiglipVisionConfig(**VISION))
    state = trainer.fit([_batch(8)] * 10, epochs=4, image_size=32)
    assert state.step == 40 and len(trainer.history) == 4
    losses = [rec["loss"] for rec in trainer.history]
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0]


def test_trainer_refuses_unported_options():
    """Nothing is refused any more: a data mesh is taken
    (tests/test_torch_data_mesh.py holds its steps) and
    ``fit(checkpoint_dir=)`` is ported (tests/test_torch_checkpoint.py)."""
    meshed = VLMTrainer(VOCAB, device="cuda", mesh=tbuild_mesh(
        {"data": 2}, [torch.device("cpu")] * 2))
    assert meshed.device == torch.device("cpu") and meshed.data.n == 2


def test_chip_smoke_and_the_port_import_nothing_of_jax():
    """Every import statement of ``chip_smoke.py`` and of every module of
    the port, wherever it stands in the file: no jax, flax or optax, and
    nothing of the JAX package."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    port = "from_ddpm_to_stable_diffusion_tpu_torch"
    files = [repo / "chip_smoke.py", *sorted((repo / port).rglob("*.py"))]
    assert len(files) > 30
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "optax",
                                    "from_ddpm_to_stable_diffusion_tpu"), (
                    f"{path.name} imports {name}")
