"""The port's CLIs and ``python -m`` entry against the JAX package's, on the
CPU.

For each ported CLI and subcommand the option strings of ``--help`` equal
the JAX CLI's plus ``--device``. Each runs at a tiny size with ``--device
cpu``: ``sd1 generate`` against the reduced bundle of
``tests/test_torch_sd1.py`` (the random-weight constructor monkeypatched)
writes the PNG of ``generate``'s pixels for the same seed, exactly; ``sd3
generate`` against a depth-1 bundle with 2-layer CLIPs, with placeholder ids
(compared with the ids the CLI passed: ``hash`` is salted per process) and
with a synthetic tokenizer trio, img2img and the trajectory grid, each PNG
equal to the inferencer's pixels; ``sd3 train --lora-rank 2 --grad-accum 2``
at its defaults; ``tiny_sd train --synthetic`` then ``sample`` on a tiny
YAML (the grid has the JAX grid's shape); ``multimodal train``, ``eval`` and
``chat``. The tensor-parallel flags build the JAX CLI's mesh over the
visible devices of --device's kind, so on the one host device ``--tp 2``
raises the JAX mesh-shape ``ValueError``; ``sd1 generate --tp 2`` with the
host device seen twice writes ``generate``'s pixels within one level; ``sd3
train --fsdp`` runs (``sd3 --sp`` / ``--moe-experts``:
``tests/test_torch_sp_mmdit.py``), and the
``__main__`` dispatch reaches every stage, ``checks`` and ``demos`` too;
``python -m`` of the ``vae``, ``vit`` and ``video`` stages prints their
help (their runs at tiny sizes are in ``tests/test_torch_{vae,vit,video}.py``,
those of ``checks`` and ``demos`` in ``tests/test_torch_checks.py``).
"""

import argparse
import importlib
import json
import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu import __main__ as jmain
from from_ddpm_to_stable_diffusion_tpu.ops import image as jimage
from from_ddpm_to_stable_diffusion_tpu_torch import __main__ as tmain
from from_ddpm_to_stable_diffusion_tpu_torch.ops import image as timage
from test_torch_serving import quick_init_, tiny_sd1_models
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)
# imported while pytest's session capture is sys.stderr: the trainers'
# MetricsLogger binds its default stream when the module is imported, and a
# test's own capture is closed after it
import from_ddpm_to_stable_diffusion_tpu_torch.utils.logging  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT = ("from_ddpm_to_stable_diffusion_tpu",
                 "from_ddpm_to_stable_diffusion_tpu_torch")
PORTED_SUBCOMMANDS = [("sd1", "generate"), ("sd3", "generate"),
                      ("sd3", "train"), ("tiny_sd", "train"),
                      ("tiny_sd", "sample"), ("multimodal", "train"),
                      ("multimodal", "eval"), ("multimodal", "chat"),
                      ("serve", None), ("vae", "train"), ("vit", "train"),
                      ("video", "train"), ("checks", None)]
REQUIRED = {("sd1", "generate"): ["--prompt", "x"],
            ("sd3", "generate"): ["--prompt", "x"],
            ("tiny_sd", "train"): ["--config", "c.yml"],
            ("tiny_sd", "sample"): ["--config", "c.yml", "--ckpt", "d"],
            ("multimodal", "chat"): ["--image", "i.png"],
            ("checks", None): ["all"]}


def _argv(stage, sub):
    return ([sub] if sub else []) + REQUIRED.get((stage, sub), [])


class _Parsed(Exception):
    pass


def parsed_args(stage, sub):
    """The namespace the port's ``stage`` CLI parses from ``sub`` and its
    required flags alone (nothing runs)."""
    parse = argparse.ArgumentParser.parse_args

    def capture(self, *args, **kw):
        raise _Parsed(parse(self, *args, **kw))

    mod = importlib.import_module(f"{PORT}.cli.{stage}")
    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        try:
            mod.main(_argv(stage, sub))
        except _Parsed as e:
            return e.args[0]
    raise AssertionError(f"{stage} {sub} parsed no arguments")


def _options(pkg, stage, sub, capsys):
    """The option strings that ``--help`` of one CLI prints."""
    mod = importlib.import_module(f"{pkg}.cli.{stage}")
    with pytest.raises(SystemExit) as e:
        mod.main(([sub] if sub else []) + ["--help"])
    assert e.value.code == 0
    return set(re.findall(r"(?<![\w-])(--?[A-Za-z][\w-]*)",
                          capsys.readouterr().out))


@pytest.mark.parametrize("stage, sub", PORTED_SUBCOMMANDS)
def test_help_options_are_the_jax_ones_and_device(stage, sub, capsys):
    want = _options(JAX_PKG, stage, sub, capsys)
    got = _options(PORT, stage, sub, capsys)
    assert "--help" in want and got == want | {"--device"}
    assert parsed_args(stage, sub).device == "cuda"


MESH_FLAGS = [
    ("sd1", ["generate", "--prompt", "x", "--tp", "2"]),
    ("serve", ["--tp", "2"]),
    ("sd3", ["generate", "--prompt", "x", "--tp", "2"]),
    ("sd3", ["train", "--tp", "2"]),
    ("sd3", ["train", "--fsdp"]),
]


@pytest.mark.parametrize("stage, argv", MESH_FLAGS, ids=[
    "sd1-tp", "serve-tp", "sd3-tp", "train-tp", "train-fsdp"])
def test_mesh_flags_exit_naming_a8(stage, argv, capsys):
    """The mesh flags run: --tp builds the JAX CLI's mesh over the visible
    devices, which on the one host device raises the JAX ``build_mesh``
    error, word for word; --fsdp trains."""
    import jax

    from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh

    mod = importlib.import_module(f"{PORT}.cli.{stage}")
    if "--fsdp" in argv:
        assert mod.main(argv + ["--steps", "2", "--device", "cpu"]) == 0
        assert "fsdp=True" in capsys.readouterr().err
        return
    shape = ({"data": 1, "model": 2} if "train" in argv
             else {"model": 2})
    with pytest.raises(ValueError) as want:
        build_mesh(shape, jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        mod.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_sd1_generate_over_a_tp_mesh(tmp_path, monkeypatch):
    """``sd1 generate --tp 2`` with the host device seen twice: the bundle
    switched to TP, the PNGs within one level of ``generate``'s pixels on
    the meshless bundle."""
    import copy

    from from_ddpm_to_stable_diffusion_tpu_torch import parallel
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import sd1
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd1 as tpipe

    models = tiny_sd1_models()
    tp_models = copy.deepcopy(models)
    monkeypatch.setattr(tpipe.SD1Models, "initialize", classmethod(
        lambda cls, generator, device, dtype="bf16": tp_models))
    monkeypatch.setattr(parallel, "visible_devices",
                        lambda kind="cuda": [torch.device(kind)] * 2)
    out = str(tmp_path / "sd1_{i}.png")
    assert sd1.main(["generate", "--prompt", "a cat", "--height", "64",
                     "--width", "64", "--steps", "2", "--seed", "3",
                     "--tp", "2", "--device", "cpu", "--out", out]) == 0
    assert tp_models.unet.enc1_att.attn1.tp.n == 2
    want = tpipe.generate(["a cat"], models, height=64, width=64,
                          n_inference_steps=2, seed=3)
    got = _png(out.format(i=0))
    assert np.abs(got.astype(int) - want[0].astype(int)).max() <= 1


def _png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


# ------------------------------------------------------------------- sd1
def test_sd1_generate_writes_the_generated_pixels(tmp_path, monkeypatch,
                                                  capsys):
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import sd1
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd1 as tpipe

    models = tiny_sd1_models()
    monkeypatch.setattr(tpipe.SD1Models, "initialize", classmethod(
        lambda cls, generator, device, dtype="bf16": models))
    out = str(tmp_path / "sd1_{i}.png")
    assert sd1.main(["generate", "--prompt", "a cat", "--prompt", "a dog",
                     "--height", "64", "--width", "64", "--steps", "2",
                     "--seed", "3", "--device", "cpu", "--out", out]) == 0
    want = tpipe.generate(["a cat", "a dog"], models, height=64, width=64,
                          n_inference_steps=2, seed=3)
    for i in range(2):
        np.testing.assert_array_equal(_png(out.format(i=i)), want[i])
    assert "wrote" in capsys.readouterr().out


# ------------------------------------------------------------------- sd3
CLIP_L = dict(vocab_size=1024, hidden_size=768, num_layers=2, num_heads=4)
CLIP_G = dict(vocab_size=1024, hidden_size=1280, num_layers=2, num_heads=4,
              hidden_act="gelu")


@pytest.fixture(scope="module")
def sd3_models():
    from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
    from from_ddpm_to_stable_diffusion_tpu_torch.models import (
        text_encoders as tte)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd3 as tpipe

    def fill(name, make):
        with torch.device("meta"):
            module = make()
        return quick_init_(module.to_empty(device="cpu"), len(name))

    return tpipe.SD3Models._build(
        fill, "cpu", "fp32", tmm.MMDiTConfig(depth=1, pos_embed_max_size=8),
        tte.CLIPTextConfig(**CLIP_L), tte.CLIPTextConfig(**CLIP_G), None)


def test_sd3_generate_against_a_tiny_bundle(sd3_models, tmp_path,
                                            monkeypatch):
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import sd3
    from from_ddpm_to_stable_diffusion_tpu_torch.io import tokenizer as ttok
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd3 as tpipe

    monkeypatch.setattr(tpipe.SD3Models, "initialize", classmethod(
        lambda cls, *a, **kw: sd3_models))
    base = ["generate", "--width", "32", "--height", "32", "--steps", "2",
            "--seed", "5", "--device", "cpu"]
    inf = tpipe.SD3Inferencer(sd3_models)
    kw = dict(width=32, height=32, steps=2, cfg_scale=5.0, seed=5)

    # placeholder ids from hash(prompt) (salted per process: compared with
    # the ids passed in), folded into the tiny CLIP vocabulary
    seen = []
    gen_image = tpipe.SD3Inferencer.gen_image

    def recorded(self, clip_tokens, *a, **k):
        seen.append(np.asarray(clip_tokens))
        return gen_image(self, np.asarray(clip_tokens) % 1024, *a, **k)

    monkeypatch.setattr(tpipe.SD3Inferencer, "gen_image", recorded)
    out = tmp_path / "placeholder.png"
    assert sd3.main(base + ["--prompt", "a cat", "--out", str(out)]) == 0
    rng = np.random.default_rng(abs(hash("a cat")) % 2**32)
    np.testing.assert_array_equal(
        seen[0], rng.integers(0, 49408, (1, 77)).astype(np.int32))
    want = gen_image(inf, seen[0] % 1024,
                     neg_clip_tokens=np.zeros((1, 77), np.int32), **kw)
    np.testing.assert_array_equal(_png(out), want[0])
    monkeypatch.setattr(tpipe.SD3Inferencer, "gen_image", gen_image)

    # prompt strings through a synthetic CLIP vocabulary (T5: the empty
    # trio slot), img2img from a PNG, and the trajectory grid
    vocab, merges = ttok.build_simple_vocab(["a", "red", "cat"])
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    init = np.random.default_rng(1).integers(0, 256, (32, 32, 3), np.uint8)
    timage.write_png(str(tmp_path / "init.png"), init)
    out = tmp_path / "text.png"
    assert sd3.main(base + [
        "--prompt", "a red cat", "--vocab", str(tmp_path / "vocab.json"),
        "--merges", str(tmp_path / "merges.txt"), "--init-image",
        str(tmp_path / "init.png"), "--strength", "0.5",
        "--save-trajectory", "--out", str(out)]) == 0
    from from_ddpm_to_stable_diffusion_tpu_torch.io import spm_tokenizer

    tok = ttok.CLIPTokenizer.from_files(str(tmp_path / "vocab.json"),
                                        str(tmp_path / "merges.txt"))
    t5 = spm_tokenizer.T5XXLTokenizer(spm_tokenizer.SentencePieceUnigram(
        [("<pad>", 0.0, spm_tokenizer.CONTROL),
         ("</s>", 0.0, spm_tokenizer.CONTROL),
         ("<unk>", 0.0, spm_tokenizer.UNKNOWN)]))
    inf.tokenizer = spm_tokenizer.SD3Tokenizer(tok, t5)
    img, previews = inf.gen_image_text(
        "a red cat", "", init_image=(init.astype(np.float32) / 255.0 * 2.0
                                     - 1.0)[None],
        denoise_strength=0.5, keep_trajectory=True, **kw)
    np.testing.assert_array_equal(_png(out), img[0])
    np.testing.assert_array_equal(
        _png(tmp_path / "text_trajectory.png"),
        timage.image_grid(previews, min(len(previews), 10)))


def test_sd3_train_lora_grad_accum_at_its_defaults(capsys):
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import sd3

    assert sd3.main(["train", "--lora-rank", "2", "--grad-accum", "2",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "sampled latents (2, 16, 16, 16)" in out.out
    assert "LoRA r=2 adapters" in out.err


# --------------------------------------------------------------- tiny_sd
def test_tiny_sd_train_then_sample(tmp_path, capsys):
    import yaml

    from from_ddpm_to_stable_diffusion_tpu_torch.cli import tiny_sd

    cfg = {
        "epoch": 1, "batch_size": 8, "img_channel": 3, "img_size": 16,
        "num_class": 3, "T": 5, "channel": 32, "channel_multy": [1, 2, 2, 2],
        "dropout": 0.0, "lr": 1.0e-4, "max_lr": 1.0e-3, "nrow": 3,
        "model_dir": str(tmp_path / "ckpt"), "dtype": "fp32",
        "warmup_epochs": 1,
    }
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    assert tiny_sd.main(["train", "--config", str(path), "--synthetic",
                         "--epochs", "1", "--device", "cpu"]) == 0
    out = tmp_path / "grid.png"
    assert tiny_sd.main(["sample", "--config", str(path), "--ckpt",
                         cfg["model_dir"], "--out", str(out), "--labels",
                         "1,2,3,1", "--device", "cpu"]) == 0
    grid = _png(out)
    want = jimage.image_grid(np.zeros((4, 16, 16, 3), np.uint8), nrow=3)
    assert grid.shape == want.shape == (32, 48, 3) and grid.std() > 0
    assert "(from epoch 0)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no checkpoint"):
        tiny_sd.main(["sample", "--config", str(path), "--ckpt",
                      str(tmp_path / "empty"), "--device", "cpu"])


# ------------------------------------------------------------ multimodal
def test_multimodal_train_eval_and_chat(tmp_path, capsys):
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import multimodal

    size = ["--img-size", "32", "--dim", "32", "--depth", "1", "--dtype",
            "fp32", "--ckpt-dir", str(tmp_path / "vlm"), "--device", "cpu"]
    grid = tmp_path / "demo.png"
    assert multimodal.main(["train", "--examples", "64", "--batch-size",
                            "32", "--epochs", "1", "--out", str(grid)]
                           + size) == 0
    out = capsys.readouterr().out
    assert "held-out caption exact-match accuracy" in out
    assert _png(grid).shape == (96, 96, 3) and out.count("got: ") == 9
    assert multimodal.main(["eval"] + size) == 0
    assert "accuracy" in capsys.readouterr().out
    image = tmp_path / "photo.png"
    timage.write_png(str(image), np.full((40, 40, 3), 200, np.uint8))
    assert multimodal.main(["chat", "--image", str(image)] + size) == 0
    words = capsys.readouterr().out.split()
    assert words and all(w in multimodal_vocab() for w in words)
    with pytest.raises(SystemExit):
        multimodal.main(["eval", "--device", "cpu"])   # needs --ckpt-dir


def multimodal_vocab():
    from from_ddpm_to_stable_diffusion_tpu_torch.io.shapes_dataset import (
        VLM_VOCAB)

    return set(VLM_VOCAB)


# -------------------------------------------------------------- __main__
def test_main_dispatch(capsys):
    assert tmain.STAGES == jmain.STAGES
    assert tmain.main([]) == 2 and tmain.main(["nope"]) == 2
    assert tmain.main(["-h"]) == 0
    # checks and demos dispatch like every other stage
    for stage in ("checks", "demos"):
        with pytest.raises(SystemExit) as e:
            tmain.main([stage, "--help"])
        assert e.value.code == 0
        assert "not ported" not in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        tmain.main(["demos", "train"])   # no such subcommand: argparse
    assert e.value.code == 2
    for stage, sub in PORTED_SUBCOMMANDS:
        with pytest.raises(SystemExit) as e:
            tmain.main([stage] + ([sub] if sub else []) + ["--help"])
        assert e.value.code == 0
    proc = subprocess.run(
        [sys.executable, "-m", PORT, "serve", "--help"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--max-wait-ms" in proc.stdout


@pytest.mark.parametrize("stage", ["vae", "vit", "video"])
def test_python_m_zoo_stage_help(stage):
    proc = subprocess.run(
        [sys.executable, "-m", PORT, stage, "train", "--help"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout
