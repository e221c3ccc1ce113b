"""The serving layer, the JAX package's against the port's, on the CPU.

Batcher: the same scripted traffic goes through both ``DynamicBatcher``s
with the ``FakeGen`` of ``tests/test_serving.py`` (pixel = seed mod 256).
Co-riders are made deterministic with a gate: the first request holds the
worker inside the generator while the rest are queued, so both batchers
must make the same ``generate_fn`` calls (bucket sizes, padding with the
first request, explicit seeds), give the same results and the same metrics
(keys, and the counters but the latency percentiles), and fail, reject,
warm up and shut down alike. Each non-slow case of ``tests/test_serving.py``
is one case here.

HTTP: both servers on 127.0.0.1, port 0: the same requests give the same
status codes and JSON bodies (400, 404, 500 and 504 included); the port's
PNG (its stdlib encoder) decodes with Pillow to the image, and to the JAX
server's PNG decoded. Exact equality throughout.

A real tiny port ``SD1Generator`` (the bundle of ``tests/test_torch_sd1.py``:
1-layer CLIP, 32-channel UNet, the full VAE decoder; here drawn from torch
seeds by :func:`quick_init_`) behind the batcher, 2 k-LMS steps at
64²: a seed's image at bucket 1 equals a direct call bit for bit, and at
bucket 2 agrees with it within 1 level (another batch shape reorders the
sums).

The data and image helpers (``image_grid``, ``nchw_to_nhwc``,
``nhwc_to_nchw``, ``denormalize``, ``ImageFolderDataset`` on PNGs written by
the port's encoder) equal the JAX functions on the same arrays, exactly
(``denormalize`` within fp32 rounding, 1e-6).
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu import io as jio
from from_ddpm_to_stable_diffusion_tpu import serving as jserving
from from_ddpm_to_stable_diffusion_tpu.ops import image as jimage
from from_ddpm_to_stable_diffusion_tpu_torch import io as tio
from from_ddpm_to_stable_diffusion_tpu_torch import serving as tserving
from from_ddpm_to_stable_diffusion_tpu_torch.ops import image as timage
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

IMPLS = {"jax": jserving, "port": tserving}
WAIT_S = 10.0


class FakeGen:
    """``tests/test_serving.py``'s stand-in (image pixel = seed mod 256,
    calls recorded), with a gate: while ``hold`` is set, a call waits in
    the generator until ``release()``."""

    def __init__(self, delay_s=0.0, fail=False, hold=False):
        self.calls = []
        self.delay_s = delay_s
        self.fail = fail
        self.lock = threading.Lock()
        self.started = threading.Event()
        self.gate = threading.Event()
        if not hold:
            self.gate.set()

    def release(self):
        self.gate.set()

    def __call__(self, prompts, negs, seeds):
        with self.lock:
            self.calls.append((list(prompts), list(negs), list(seeds)))
        self.started.set()
        assert self.gate.wait(WAIT_S), "the test never released the gate"
        if self.fail:
            raise RuntimeError("boom")
        time.sleep(self.delay_s)
        imgs = np.zeros((len(prompts), 4, 4, 3), np.uint8)
        for i, s in enumerate(seeds):
            imgs[i] = 0 if s is None else (s % 256)
        return imgs


def _metrics(batcher):
    """The metrics without the timing-dependent latency percentiles (their
    presence is kept)."""
    m = batcher.metrics()
    return {k: (k.startswith("latency") or v) for k, v in m.items()}


def _outcome(fut):
    try:
        return ("ok", int(fut.result(timeout=WAIT_S)[0, 0, 0]))
    except RuntimeError as e:
        return ("error", str(e))


def _behind_a_blocker(serving, gen, requests, **kw):
    """A blocker request (seed 0) holds the worker in the generator; then
    ``requests`` (prompt, seed) are queued and the gate is released."""
    b = serving.DynamicBatcher(gen, **kw)
    first = b.submit(serving.GenerateRequest("blocker", seed=0))
    assert gen.started.wait(WAIT_S)
    futs = [b.submit(serving.GenerateRequest(p, seed=s)) for p, s in requests]
    gen.release()
    return b, [first] + futs


def _scenario(name, serving):
    """Runs one scripted scenario; returns its transcript."""
    out = {}
    if name == "single_request_roundtrip":
        gen = FakeGen()
        b = serving.DynamicBatcher(gen, buckets=(1, 2, 4), max_wait_ms=30.0)
        img = b.submit(serving.GenerateRequest("a cat", seed=7)).result(
            timeout=WAIT_S)
        out["image"] = (img.shape, int(img[0, 0, 0]))
    elif name == "coalesce_and_keep_seed_identity":
        gen = FakeGen(hold=True)
        b, futs = _behind_a_blocker(
            serving, gen, [(f"p{i}", i + 10) for i in range(4)],
            buckets=(1, 2, 4), max_wait_ms=80.0)
        out["results"] = [_outcome(f) for f in futs]
    elif name == "bucket_padding_trimmed":
        gen = FakeGen(hold=True)
        b, futs = _behind_a_blocker(
            serving, gen, [(f"p{i}", i + 1) for i in range(3)],
            buckets=(1, 2, 4), max_wait_ms=80.0)
        out["results"] = [_outcome(f) for f in futs]
        out["result_shapes"] = [f.result(timeout=WAIT_S).shape for f in futs]
    elif name == "burst_over_the_largest_bucket":
        gen = FakeGen(hold=True)
        b, futs = _behind_a_blocker(
            serving, gen, [(f"p{i}", 20 + i) for i in range(7)],
            buckets=(1, 2, 4), max_wait_ms=80.0)
        out["results"] = [_outcome(f) for f in futs]
    elif name == "failure_propagates_and_server_keeps_serving":
        gen = FakeGen(fail=True)
        b = serving.DynamicBatcher(gen, buckets=(1, 2, 4), max_wait_ms=30.0)
        out["failed"] = _outcome(b.submit(serving.GenerateRequest("x",
                                                                  seed=1)))
        gen.fail = False
        out["ok"] = _outcome(b.submit(serving.GenerateRequest("y", seed=3)))
    elif name == "queue_full_rejects":
        gen = FakeGen(hold=True)
        b, futs = _behind_a_blocker(
            serving, gen, [(f"p{i}", i + 1) for i in range(3)],
            buckets=(1,), max_wait_ms=1.0, max_queue=1)
        out["results"] = [_outcome(f) for f in futs]
    elif name == "warmup_runs_exact_buckets":
        gen = FakeGen()
        b = serving.DynamicBatcher(gen, buckets=(1, 2, 4), max_wait_ms=0.0)
        b.warmup()
        with pytest.raises(ValueError, match="unknown bucket"):
            b.warmup(buckets=(3,))
    elif name == "none_seed_draws_fresh_random_seed":
        gen = FakeGen()
        b = serving.DynamicBatcher(gen, buckets=(1, 2, 4), max_wait_ms=30.0)
        b.submit(serving.GenerateRequest("x")).result(timeout=WAIT_S)
        b.submit(serving.GenerateRequest("x")).result(timeout=WAIT_S)
        seeds = [s for _, _, ss in gen.calls for s in ss]
        assert all(isinstance(s, int) for s in seeds)
        assert seeds[0] != seeds[1]   # P(collision) = 2^-31
        gen.calls = [(p, n, ["drawn"] * len(ss)) for p, n, ss in gen.calls]
    elif name == "shutdown_fails_what_is_queued_after_it":
        gen = FakeGen(hold=True)
        b = serving.DynamicBatcher(gen, buckets=(1, 2, 4), max_wait_ms=30.0)
        first = b.submit(serving.GenerateRequest("blocker", seed=0))
        assert gen.started.wait(WAIT_S)
        queued = b.submit(serving.GenerateRequest("queued", seed=5))
        b.shutdown(timeout=0.0)
        late = b.submit(serving.GenerateRequest("late", seed=6))
        errors = []
        warm = threading.Thread(target=lambda: _catch(b.warmup, errors))
        warm.start()
        deadline = time.monotonic() + WAIT_S
        while b._q.qsize() < 3 and time.monotonic() < deadline:
            time.sleep(0.005)   # queued, _SHUTDOWN, the warm-up item
        gen.release()
        warm.join(WAIT_S)
        assert not warm.is_alive()
        b._worker.join(WAIT_S)
        assert not b._worker.is_alive()
        out["results"] = [_outcome(f) for f in (first, queued, late)]
        out["warmup"] = errors
    else:
        raise ValueError(name)
    if b._worker.is_alive():
        b.shutdown()
    out["calls"] = gen.calls
    out["metrics"] = _metrics(b)
    return out


def _catch(fn, errors):
    try:
        fn()
    except RuntimeError as e:
        errors.append(str(e))


SCENARIOS = ["single_request_roundtrip", "coalesce_and_keep_seed_identity",
             "bucket_padding_trimmed", "burst_over_the_largest_bucket",
             "failure_propagates_and_server_keeps_serving",
             "queue_full_rejects", "warmup_runs_exact_buckets",
             "none_seed_draws_fresh_random_seed",
             "shutdown_fails_what_is_queued_after_it"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_batcher_matches_jax(name):
    got, want = _scenario(name, tserving), _scenario(name, jserving)
    assert got == want
    calls, m = got["calls"], got["metrics"]
    if name != "shutdown_fails_what_is_queued_after_it":
        # (a failed warm-up counts as failed, and in no request)
        assert m["requests"] == m["served"] + m["failed"]
    if name == "single_request_roundtrip":
        assert got["image"] == ((4, 4, 3), 7)
        assert calls == [(["a cat"], [""], [7])]
        assert (m["served"], m["batches"], m["padded_slots"]) == (1, 1, 0)
    elif name == "coalesce_and_keep_seed_identity":
        assert got["results"] == [("ok", 0)] + [("ok", i + 10)
                                                for i in range(4)]
        assert [len(p) for p, _, _ in calls] == [1, 4]
        assert m["batches"] == 2 and m["mean_batch"] == 2.5
    elif name == "bucket_padding_trimmed":
        # 3 requests ride in one bucket-4 call, padded with the first
        assert calls[1] == (["p0", "p1", "p2", "p0"], [""] * 4, [1, 2, 3, 1])
        assert got["results"] == [("ok", s) for s in (0, 1, 2, 3)]
        assert got["result_shapes"] == [(4, 4, 3)] * 4
        assert m["padded_slots"] == 1
    elif name == "burst_over_the_largest_bucket":
        assert [len(p) for p, _, _ in calls] == [1, 4, 4]
        assert calls[2][2] == [24, 25, 26, 24]
        assert m["padded_slots"] == 1 and m["served"] == 8
    elif name == "failure_propagates_and_server_keeps_serving":
        assert got["failed"] == ("error", "boom") and got["ok"] == ("ok", 3)
        assert (m["failed"], m["served"]) == (1, 1)
    elif name == "queue_full_rejects":
        full = ("error", "server overloaded: request queue full")
        assert got["results"] == [("ok", 0), ("ok", 1), full, full]
        assert m["failed"] == 2
    elif name == "warmup_runs_exact_buckets":
        assert sorted(len(p) for p, _, _ in calls) == [1, 2, 4]
        assert (m["requests"], m["served"], m["batches"]) == (0, 0, 0)
    elif name == "shutdown_fails_what_is_queued_after_it":
        down = ("error", "server shutting down")
        assert got["results"] == [("ok", 0), ("ok", 5), down]
        assert got["warmup"] == ["server shutting down"]


def test_batcher_under_many_client_threads():
    """32 client threads (more than the cores) with a short switch
    interval: every request gets its own seed's image, each call is a
    bucket, and no counter loses an update."""
    import sys

    gen = FakeGen()
    b = tserving.DynamicBatcher(gen, buckets=(1, 2, 4, 8), max_wait_ms=2.0)
    got, saved = {}, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(i):
            for j in range(8):
                seed = 1000 * i + j
                got[seed] = int(b.submit(tserving.GenerateRequest(
                    "p", seed=seed)).result(timeout=WAIT_S)[0, 0, 0])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
        b.shutdown()
    assert got == {s: s % 256 for s in got} and len(got) == 256
    m = b.metrics()
    assert m["requests"] == m["served"] == m["batched_requests"] == 256
    assert all(len(p) in (1, 2, 4, 8) for p, _, _ in gen.calls)
    assert m["batches"] == len(gen.calls)
    assert m["padded_slots"] == sum(len(p) for p, _, _ in gen.calls) - 256


# ------------------------------------------------------------------- HTTP
@pytest.fixture(scope="module")
def servers():
    """{impl: (url, gen, batcher)}, each with a 0.3 s request timeout."""
    out = {}
    for impl, serving in IMPLS.items():
        gen = FakeGen()
        b = serving.DynamicBatcher(gen, buckets=(1, 2, 4), max_wait_ms=5.0)
        server = serving.make_server(b, port=0, request_timeout_s=0.3)
        serving.serve_forever_in_thread(server)
        host, port = server.server_address[:2]
        out[impl] = (f"http://{host}:{port}", gen, b, server)
    yield out
    for _, _, b, server in out.values():
        server.shutdown()
        server.server_close()
        b.shutdown()


def _request(url, path, payload=None):
    """(status, content type, body bytes) of a GET (no payload) or POST."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(req, timeout=WAIT_S)
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()
    return resp.status, resp.headers["Content-Type"], resp.read()


REQUESTS = [
    ("json", "/v1/generate", {"prompt": "a dog", "seed": 42,
                              "format": "json"}),
    ("no prompt", "/v1/generate", {"no_prompt": True}),
    ("seed not an int", "/v1/generate", {"prompt": "x", "seed": "one"}),
    ("a list", "/v1/generate", [1, 2, 3]),
    ("a string", "/v1/generate", "str"),
    ("a number", "/v1/generate", 5),
    ("POST elsewhere", "/v2/generate", {"prompt": "x"}),
    ("GET elsewhere", "/nope", None),
]


@pytest.mark.parametrize("what, path, payload", REQUESTS,
                         ids=[r[0] for r in REQUESTS])
def test_http_status_and_body_match_jax(servers, what, path, payload):
    got = _request(servers["port"][0], path, payload)
    want = _request(servers["jax"][0], path, payload)
    assert got == want
    status, ctype, body = got
    assert ctype == "application/json"
    if what == "json":
        body = json.loads(body)
        assert status == 200 and body["shape"] == [4, 4, 3]
        raw = np.frombuffer(base64.b64decode(body["image_b64"]), np.uint8)
        assert (raw == 42).all()
    else:
        assert status == (404 if "elsewhere" in what else 400)


@pytest.mark.parametrize("fault", ["fails", "times out"])
def test_http_500_and_504_match_jax(servers, fault):
    bodies = {}
    for impl, (url, gen, b, _) in servers.items():
        done = b.metrics()["batches"]
        gen.fail, gen.delay_s = fault == "fails", 1.0 * (fault == "times out")
        try:
            bodies[impl] = _request(url, "/v1/generate",
                                    {"prompt": "x", "seed": 1})
        finally:
            gen.fail, gen.delay_s = False, 0.0
        deadline = time.monotonic() + WAIT_S   # the worker is free again
        while b.metrics()["batches"] == done and time.monotonic() < deadline:
            time.sleep(0.01)
    assert bodies["port"] == bodies["jax"]
    status, _, body = bodies["port"]
    assert (status, json.loads(body)) == (
        (500, {"error": "boom"}) if fault == "fails"
        else (504, {"error": "generation timed out"}))


def test_http_png_health_and_metrics_match_jax(servers):
    from PIL import Image
    import io

    pngs = {}
    for impl, (url, _, _, _) in servers.items():
        status, ctype, body = _request(url, "/v1/generate",
                                       {"prompt": "a dog", "seed": 42})
        assert (status, ctype, body[:8]) == (200, "image/png",
                                             b"\x89PNG\r\n\x1a\n")
        pngs[impl] = np.asarray(Image.open(io.BytesIO(body)))
    np.testing.assert_array_equal(pngs["port"], pngs["jax"])
    np.testing.assert_array_equal(pngs["port"],
                                  np.full((4, 4, 3), 42, np.uint8))
    for path in ("/healthz", "/metrics"):
        got, want = (json.loads(_request(servers[i][0], path)[2])
                     for i in ("port", "jax"))
        assert set(got) == set(want) and "latency_ms_p50" in got
        assert got.get("ok") is want.get("ok")


def test_server_queues_a_whole_burst_of_connections():
    """Before its accept loop runs, the port's server takes 16 connections
    at once (the JAX server's listen backlog of 5 refuses the 7th: its
    client waits for a SYN retry, about 1 s, and misses the batcher's 25 ms
    window)."""
    import socket

    b = tserving.DynamicBatcher(FakeGen(), buckets=(1,), max_wait_ms=1.0)
    server = tserving.make_server(b, port=0)
    conns = []
    try:
        for _ in range(16):
            conns.append(socket.create_connection(server.server_address[:2],
                                                  timeout=0.5))
    finally:
        for c in conns:
            c.close()
        server.server_close()
        b.shutdown()
    assert len(conns) == 16


@pytest.mark.parametrize("shape", [(1, 1, 3), (5, 7, 3), (64, 33, 3)])
def test_png_encoder_decodes_to_the_image(shape):
    from PIL import Image
    import io

    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    got = np.asarray(Image.open(io.BytesIO(timage.encode_png(img))))
    np.testing.assert_array_equal(got, img)
    with pytest.raises(ValueError, match="H, W, 3"):
        timage.encode_png(img[..., 0])


# ------------------------------------------------- a real tiny SD1Generator
@torch.no_grad()
def quick_init_(module, seed: int):
    """Random weights for a test bundle, in place: fan-in normal kernels and
    embeddings, unit norm scales, zero biases (a tenth of the time of
    ``flax_default_init_``'s truncated normals on one CPU thread)."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if p.dim() > 1:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
        else:
            p.fill_(1.0 if name.endswith(("weight", "_scale")) else 0.0)
    return module


def tiny_sd1_models():
    """The reduced SD1 bundle of ``tests/test_torch_sd1.py`` (1-layer CLIP,
    32-channel UNet, the full VAE decoder) on the CPU in fp32."""
    from from_ddpm_to_stable_diffusion_tpu_torch.models import sd1 as tsd1
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd1 as tpipe

    clip, unet, decoder = (
        tpipe._prepare(quick_init_(m, i), "cpu", "fp32")
        for i, m in enumerate((
            tsd1.CLIPText(vocab_size=64, num_layers=1, num_heads=4,
                          embed_dim=768),
            tsd1.SD1UNet(model_channels=32, num_heads=4),
            tsd1.VAEDecoder())))
    return tpipe.SD1Models(clip, unet, None, decoder)


def test_tiny_sd1_generator_behind_the_batcher():
    from from_ddpm_to_stable_diffusion_tpu_torch.cli.serve import (
        sd1_generate_fn)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd1 as tpipe

    gen = tpipe.SD1Generator(tiny_sd1_models(), n_inference_steps=2,
                             height=64, width=64)
    fn = sd1_generate_fn(gen)
    batcher = tserving.DynamicBatcher(fn, buckets=(1, 2), max_wait_ms=0.0)
    try:
        solo = batcher.submit(tserving.GenerateRequest(
            "p", seed=123)).result(timeout=120)
        direct = gen(["p"], uncond_prompts=[""], per_sample_seeds=[123])
        np.testing.assert_array_equal(solo, direct[0])
        pair = fn(["p", "q"], ["", ""], [123, 456])
    finally:
        batcher.shutdown()
    assert solo.shape == (64, 64, 3) and solo.dtype == np.uint8
    np.testing.assert_allclose(pair[0].astype(np.int16),
                               solo.astype(np.int16), atol=1)
    assert not np.array_equal(pair[0], pair[1])


# ------------------------------------------------ data and image helpers
def test_layout_helpers_and_grid_match_jax():
    x = np.random.default_rng(0).normal(size=(5, 3, 4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        timage.nchw_to_nhwc(torch.tensor(x)).numpy(),
        np.asarray(jimage.nchw_to_nhwc(jnp.asarray(x))))
    np.testing.assert_array_equal(
        timage.nhwc_to_nchw(torch.tensor(x)).numpy(),
        np.asarray(jimage.nhwc_to_nchw(jnp.asarray(x))))
    imgs = np.random.default_rng(1).integers(0, 256, (7, 4, 5, 3), np.uint8)
    for nrow in (1, 3, 7, 9):
        got = timage.image_grid(imgs, nrow)
        want = jimage.image_grid(imgs, nrow)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    z = np.random.default_rng(2).normal(size=(2, 3, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(tio.denormalize(z),
                               np.asarray(jio.denormalize(jnp.asarray(z))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tio.IMAGENET_MEANS, jio.IMAGENET_MEANS)
    np.testing.assert_array_equal(tio.IMAGENET_STDS, jio.IMAGENET_STDS)


@pytest.mark.parametrize("mode", [dict(), dict(to_unit_range=True),
                                  dict(normalize=False)])
def test_image_folder_dataset_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(3)
    for cls in ["cat", "dog"]:
        (tmp_path / cls).mkdir()
        for i in range(3):
            timage.write_png(str(tmp_path / cls / f"{i}.png"),
                             rng.integers(0, 256, (10, 8, 3), np.uint8))
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    got = tio.ImageFolderDataset(str(tmp_path), img_size=8, **mode)
    want = jio.ImageFolderDataset(str(tmp_path), img_size=8, **mode)
    assert len(got) == len(want) == 6
    assert got.class_names == want.class_names == ["cat", "dog"]
    for i in range(len(got)):
        (a, la), (b, lb) = got.load(i), want.load(i)
        assert la == lb and a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    got_b = list(tio.DataLoader(got, batch_size=4, seed=0))
    want_b = list(jio.DataLoader(want, batch_size=4, seed=0))
    assert len(got_b) == len(want_b) == 1
    for (a, la), (b, lb) in zip(got_b, want_b):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    with pytest.raises(ValueError, match="no images"):
        tio.ImageFolderDataset(str(tmp_path / "cat"), img_size=8)
