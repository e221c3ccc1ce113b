"""Parity of the port's sequence-parallel MMDiT (ring and Ulysses joint
attention, ``models/mmdit.py``) with the JAX package's, and the SD3 CLI's
``--sp`` / ``--sp-impl`` / ``--moe-experts``, on the CPU.

The MMDiT is JAX's own test shape (``tests/test_ring_attention.py``):
depth 2, an 8×8 latent (16 tokens) and 154 context tokens, so the joint
sequence of 170 pads to 176 over 8 ring shards (Ulysses: 2 shards, the 2
heads). Parameters are numpy draws loaded into both packages, fp32; the
tolerance is the JAX test's 3e-4. The CLI runs a tiny random bundle; its
ring and Ulysses images are held within 2 levels of the flash bundle's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh as jmesh
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params)
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _inputs(b=1, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, 8, 8, 16)).astype(np.float32),
            np.asarray([300.0] * b, np.float32),
            r.standard_normal((b, 2048)).astype(np.float32),
            r.standard_normal((b, 154, 4096)).astype(np.float32))


@pytest.mark.parametrize("impl, n", [("ring", 8), ("ulysses", 2)])
def test_sp_mmdit_matches_jax(devices8, impl, n):
    cfg = dict(depth=2, pos_embed_max_size=8)
    inputs = _inputs()
    params = jax_random_params(jmm.MMDiT(jmm.MMDiTConfig(**cfg)), *inputs,
                               seed=3)
    jsp = jmm.MMDiT(jmm.MMDiTConfig(**cfg, attention_impl=impl),
                    mesh=jmesh({"seq": n}, devices8[:n]))
    want = jax.jit(lambda p: jsp.apply({"params": p}, *inputs))(params)
    mesh = build_mesh({"seq": n}, [torch.device("cpu")] * n)
    tsp = load_jax_params(tmm.MMDiT(tmm.MMDiTConfig(**cfg,
                                                    attention_impl=impl),
                                    mesh=mesh), params)
    assert tsp.joint_block1.mesh is mesh
    with torch.no_grad():
        got = tsp(*map(torch.from_numpy, inputs))
        flash = load_jax_params(tmm.MMDiT(tmm.MMDiTConfig(**cfg)), params)(
            *map(torch.from_numpy, inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4)
    # concatenated joint sequence vs split K/V streams: a tolerance, not
    # bit for bit
    np.testing.assert_allclose(got.numpy(), flash.numpy(), atol=3e-4)


# -------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def sd3_models():
    """A tiny random SD3 bundle with a 2-head MMDiT (Ulysses over 2)."""
    from from_ddpm_to_stable_diffusion_tpu_torch.models import (
        text_encoders as tte)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd3 as tpipe
    from test_torch_cli import CLIP_G, CLIP_L, quick_init_

    def fill(name, make):
        with torch.device("meta"):
            module = make()
        return quick_init_(module.to_empty(device="cpu"), len(name))

    return tpipe.SD3Models._build(
        fill, "cpu", "fp32", tmm.MMDiTConfig(depth=2, pos_embed_max_size=8),
        tte.CLIPTextConfig(**CLIP_L), tte.CLIPTextConfig(**CLIP_G), None)


def _png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im).astype(np.int32)


def test_sd3_generate_sp_ring_and_ulysses(sd3_models, tmp_path,
                                          monkeypatch):
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import sd3
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd3 as tpipe

    monkeypatch.setattr(tpipe.SD3Models, "initialize", classmethod(
        lambda cls, *a, **kw: sd3_models))
    gen_image = tpipe.SD3Inferencer.gen_image   # ids into the tiny vocab
    monkeypatch.setattr(tpipe.SD3Inferencer, "gen_image", lambda self, ids,
                        *a, **kw: gen_image(self, np.asarray(ids) % 1024,
                                            *a, **kw))
    # the host device 8 times over, as JAX's 8 virtual CPU devices
    monkeypatch.setattr(sd3, "visible_devices",
                        lambda kind: [torch.device(kind)] * 8)
    base = ["generate", "--prompt", "a cat", "--width", "32", "--height",
            "32", "--steps", "2", "--seed", "5", "--device", "cpu"]
    images = {}
    for name, extra in (("flash", []), ("ring", ["--sp", "4"]),
                        ("ulysses", ["--sp", "2", "--sp-impl", "ulysses"])):
        out = tmp_path / f"{name}.png"
        assert sd3.main(base + extra + ["--out", str(out)]) == 0
        images[name] = _png(out)
        mmdit = sd3_models.mmdit
        assert mmdit.config.attention_impl == name
        if name != "flash":
            assert mmdit.mesh.shape == {"seq": int(extra[1])}
        mmdit.set_attention("flash")
    for name in ("ring", "ulysses"):
        assert np.abs(images[name] - images["flash"]).max() <= 2, name


def test_sd3_generate_sp_needs_the_devices(monkeypatch, capsys):
    """--sp N over fewer visible devices raises the JAX ValueError, before
    any model is made."""
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import sd3

    with pytest.raises(ValueError, match=r"mesh shape \{'seq': 4\} != 1 "
                                         "devices"):
        sd3.main(["generate", "--prompt", "x", "--sp", "4", "--device",
                  "cpu"])
    with pytest.raises(SystemExit):
        sd3.main(["generate", "--prompt", "x", "--sp", "2", "--tp", "2",
                  "--device", "cpu"])
    assert "mutually exclusive" in capsys.readouterr().err


def test_sd3_train_moe_experts(capsys):
    from from_ddpm_to_stable_diffusion_tpu_torch.cli import sd3

    assert sd3.main(["train", "--moe-experts", "2", "--steps", "3",
                     "--batch-size", "2", "--img-size", "8", "--device",
                     "cpu"]) == 0
    out = capsys.readouterr()
    assert "sampled latents (2, 8, 8, 16)" in out.out
    assert "mesh={'data': 1}" in out.err


def test_mmdit_set_attention_keeps_the_parameters(sd3_models):
    mmdit = sd3_models.mmdit
    before = {k: v.data_ptr() for k, v in mmdit.state_dict().items()}
    mmdit.set_attention("ring", build_mesh({"seq": 2}, ["cpu"] * 2))
    assert {k: v.data_ptr() for k, v in mmdit.state_dict().items()} == before
    mmdit.set_attention("flash")
    assert dataclasses.replace(mmdit.config).attention_impl == "flash"
