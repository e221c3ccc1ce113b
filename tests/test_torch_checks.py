"""The port's ``checks`` and ``demos`` CLIs against the JAX package's, on the
CPU.

``checks <stage> --device cpu`` prints the JAX package's lines for every
stage: the JAX check functions run under ``jax.eval_shape`` (Flax's
``init`` and ``apply`` evaluated abstractly, so the same shape trace and
parameter counts without the minutes of CPU compiles), the port's for real.
``checks weights`` on the same .pt file; ``checks clip --ckpt`` on a
synthetic OpenAI-layout checkpoint, vocabulary and PNG (the probabilities
within 1e-5 of the JAX check's); ``--siglip-ckpt`` on a synthetic HF-layout
file (features within 1e-4 of their largest magnitude, the summary line
equal); ``--plot-schedule``. ``demos``: the gated errors (no transformers,
no diffusers, no token), and ``replicate_run`` against a local
standard-library HTTP server through ``base_url``, request and answer equal
to the JAX function's.
"""

import contextlib
import functools
import http.server
import io
import json
import sys
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.cli import checks as jchecks
from from_ddpm_to_stable_diffusion_tpu.cli import demos as jdemos
from from_ddpm_to_stable_diffusion_tpu.models import clip as jclip
from from_ddpm_to_stable_diffusion_tpu_torch.cli import checks as tchecks
from from_ddpm_to_stable_diffusion_tpu_torch.cli import demos as tdemos
from from_ddpm_to_stable_diffusion_tpu_torch.io.tokenizer import (
    build_simple_vocab)
from test_torch_clip import SMALL, openai_state
from test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kw)
    return buf.getvalue(), result


@contextlib.contextmanager
def abstract_flax():
    """Flax's ``Module.init`` / ``apply`` through ``jax.eval_shape``: their
    results carry the shapes and sizes of the real ones."""
    init, apply = fnn.Module.init, fnn.Module.apply
    fnn.Module.init = lambda self, *a, **k: jax.eval_shape(
        functools.partial(init, self, **k), *a)
    fnn.Module.apply = lambda self, *a, **k: jax.eval_shape(
        functools.partial(apply, self, **k), *a)
    try:
        yield
    finally:
        fnn.Module.init, fnn.Module.apply = init, apply


@pytest.mark.parametrize("stage", sorted(jchecks.CHECKS))
def test_checks_print_the_jax_lines(stage):
    with abstract_flax():
        want, rc_jax = _stdout(jchecks.main, [stage])
    got, rc = _stdout(tchecks.main, [stage, "--device", "cpu"])
    assert rc == rc_jax == 0
    assert got.splitlines() == want.splitlines()
    assert got.startswith(f"--- {stage} ---\n")


def test_checks_all_runs_every_stage_in_order(capsys):
    """``all`` is the stages in sorted order, then one closing line."""
    got, rc = _stdout(tchecks.main, ["all", "--device", "cpu"])
    heads = [line for line in got.splitlines() if line.startswith("---")]
    assert rc == 0 and heads == [f"--- {s} ---" for s in sorted(
        tchecks.CHECKS)]
    assert got.splitlines()[-1] == "all checks passed"
    assert list(tchecks.CHECKS) == list(jchecks.CHECKS)


def test_checks_weights_prints_the_jax_lines(tmp_path):
    path = tmp_path / "w.pt"
    torch.save({"b.weight": torch.ones(3, 2), "a": torch.zeros(4),
                "c": torch.zeros(1, 2, 3)}, path)
    want, _ = _stdout(jchecks.main, ["weights", str(path)])
    got, rc = _stdout(tchecks.main, ["weights", str(path)])
    assert rc == 0 and got == want
    assert got.splitlines()[-1] == "3 tensors"
    with pytest.raises(SystemExit):
        tchecks.main(["weights"])


def _vocab_dir(tmp_path):
    vocab, merges = build_simple_vocab(["a", "cat", "dog", "wild",
                                        "animal"])
    (tmp_path / "vocab.json").write_text(json.dumps(vocab,
                                                    ensure_ascii=False))
    lines = ["#version: 0.2"] + [
        f"{a} {b}" for (a, b), _ in sorted(merges.items(),
                                           key=lambda kv: kv[1])]
    (tmp_path / "merges.txt").write_text("\n".join(lines) + "\n")
    return len(vocab)


def _png(path, seed, shape=(40, 40, 3)):
    from PIL import Image

    Image.fromarray((np.random.default_rng(seed).random(shape) * 255)
                    .astype(np.uint8)).save(path)


def test_check_clip_pretrained_matches_jax(tmp_path):
    """``checks clip --ckpt``: a synthetic OpenAI-layout ViT checkpoint (the
    vocabulary's size as the model's, so every id it emits is in range),
    vocabulary and image; the same probabilities as the JAX check."""
    cfg = dict(SMALL, vocab_size=_vocab_dir(tmp_path))
    params = jax_random_params(jclip.CLIP(**cfg), jnp.zeros((1, 28, 28, 3)),
                               jnp.zeros((1, 10), jnp.int32), seed=1)
    torch.save(openai_state(params), tmp_path / "clip.pt")
    _png(tmp_path / "cat.png", 0)
    args = [str(tmp_path / "clip.pt"), str(tmp_path / "cat.png"),
            str(tmp_path)]
    _, want = _stdout(jchecks.check_clip_pretrained, *args)
    out, got = _stdout(tchecks.check_clip_pretrained, *args, device="cpu")
    assert got.shape == (3,) and got.sum() == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert [line.split(":")[0] for line in out.splitlines()] == [
        "  'a cat'", "  'a dog'", "  'a wild animal'"]
    text, rc = _stdout(tchecks.main, [
        "clip", "--ckpt", args[0], "--image", args[1], "--vocab-dir",
        args[2], "--prompt", "a cat", "--prompt", "a dog", "--device",
        "cpu"])
    assert rc == 0 and len(text.splitlines()) == 2
    with pytest.raises(SystemExit):
        tchecks.main(["clip", "--ckpt", args[0]])   # needs --image, vocab


def _siglip_state(hidden=32, inter=64, layers=2, patch=16, seed=7):
    rng = np.random.default_rng(seed)
    state = {
        "vision_model.embeddings.patch_embedding.weight":
            rng.standard_normal((hidden, 3, patch, patch)) * 0.05,
        "vision_model.embeddings.patch_embedding.bias":
            rng.standard_normal(hidden) * 0.05,
        "vision_model.embeddings.position_embedding.weight":
            rng.standard_normal((4, hidden)) * 0.05,
        "vision_model.post_layernorm.weight": 1.0 + 0.1 * rng.standard_normal(
            hidden),
        "vision_model.post_layernorm.bias": 0.1 * rng.standard_normal(hidden),
        "vision_model.head.probe": rng.standard_normal((1, 1, hidden)),
    }
    for i in range(layers):
        p = f"vision_model.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            state[f"{p}.{ln}.weight"] = np.ones(hidden)
            state[f"{p}.{ln}.bias"] = np.zeros(hidden)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            state[f"{p}.self_attn.{proj}.weight"] = \
                rng.standard_normal((hidden, hidden)) * 0.05
            state[f"{p}.self_attn.{proj}.bias"] = \
                rng.standard_normal(hidden) * 0.05
        state[f"{p}.mlp.fc1.weight"] = rng.standard_normal(
            (inter, hidden)) * 0.05
        state[f"{p}.mlp.fc1.bias"] = np.zeros(inter)
        state[f"{p}.mlp.fc2.weight"] = rng.standard_normal(
            (hidden, inter)) * 0.05
        state[f"{p}.mlp.fc2.bias"] = np.zeros(hidden)
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in state.items()}


def test_check_siglip_pretrained_matches_jax(tmp_path):
    torch.save(_siglip_state(), tmp_path / "siglip.pt")
    _png(tmp_path / "img.png", 1, (40, 50, 3))
    args = [str(tmp_path / "siglip.pt"), str(tmp_path / "img.png")]
    want_text, want = _stdout(jchecks.check_siglip_pretrained, *args)
    got_text, got = _stdout(tchecks.check_siglip_pretrained, *args,
                            device="cpu")
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape == (1, 4, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert got_text == want_text
    text, rc = _stdout(tchecks.main, ["clip", "--siglip-ckpt", args[0],
                                      "--image", args[1], "--device", "cpu"])
    assert rc == 0 and text == want_text


def test_checks_plot_schedule(tmp_path):
    """visual_alpha's counterpart (reference 06_…/01_check.py:33-47)."""
    out = tmp_path / "parameters.png"
    text, rc = _stdout(tchecks.main, ["tiny", "--plot-schedule", str(out)])
    assert rc == 0 and out.stat().st_size > 1000
    assert text == f"schedule plot -> {out}\n"


# ----------------------------------------------------------------- demos
def test_demos_gated_errors(monkeypatch, tmp_path):
    """Without transformers, diffusers or a token each adapter stops with
    the JAX package's actionable ``RuntimeError`` (the imports are blocked
    here, so nothing reaches for a download)."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "diffusers", None)
    monkeypatch.delenv("REPLICATE_API_TOKEN", raising=False)
    _png(tmp_path / "img.png", 2)
    cases = [(lambda m: m.multimodal_chat(str(tmp_path / "img.png"), "q"),
              "transformers is required"),
             (lambda m: m.text_to_video("a cat"), "diffusers is required"),
             (lambda m: m.replicate_run("v", {}), "REPLICATE_API_TOKEN")]
    for call, msg in cases:
        for mod in (jdemos, tdemos):
            with pytest.raises(RuntimeError, match=msg):
                call(mod)
    with pytest.raises(RuntimeError, match="REPLICATE_API_TOKEN"):
        tdemos.main(["replicate", "--version", "v", "--input-json", "{}"])
    path = tmp_path / "img.png"
    assert tdemos.encode_image_base64(str(path)) == \
        jdemos.encode_image_base64(str(path))


class _Recorder(http.server.BaseHTTPRequestHandler):
    seen = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.seen.append((self.path, self.headers["Authorization"],
                          self.headers["Content-Type"], json.loads(body)))
        reply = json.dumps({"id": "p1", "status": "starting",
                            "echo": json.loads(body)}).encode()
        self.send_response(201)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(reply)))
        self.end_headers()
        self.wfile.write(reply)

    def log_message(self, *args):
        pass


def test_replicate_run_against_a_local_server(monkeypatch, capsys):
    server = http.server.HTTPServer(("127.0.0.1", 0), _Recorder)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    _Recorder.seen = []
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/v1"
        inputs = {"prompt": "a cat", "steps": 4}
        want = jdemos.replicate_run("ver", inputs, api_token="tok",
                                    base_url=url)
        got = tdemos.replicate_run("ver", inputs, api_token="tok",
                                   base_url=url)
        monkeypatch.setenv("REPLICATE_API_TOKEN", "env")
        monkeypatch.setattr(tdemos.replicate_run, "__defaults__",
                            (None, url))
        assert tdemos.main(["replicate", "--version", "ver",
                            "--input-json", json.dumps(inputs)]) == 0
        printed = json.loads(capsys.readouterr().out)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert got == want == printed == {
        "id": "p1", "status": "starting",
        "echo": {"version": "ver", "input": inputs}}
    assert _Recorder.seen == [
        ("/v1/predictions", f"Token {t}", "application/json",
         {"version": "ver", "input": inputs}) for t in ("tok", "tok", "env")]
