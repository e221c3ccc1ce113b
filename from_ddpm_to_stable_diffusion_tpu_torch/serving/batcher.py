"""Dynamic request batching in front of a generator on the card (port of
``serving/batcher.py``).

Concurrent single-image requests are coalesced into batched generator
calls. Batching is the serving lever on the H100: SD1 at batch 1 leaves the
card idle most of a request while the host issues the step's launches
(``PERF.md`` §5), and a batch of B rides in the same launches. Every batch
is rounded up to a fixed *bucket ladder* (default 1/2/4/8), padded with a
duplicate of the first request whose result is sliced off, so the
generator sees a few shapes only; :meth:`DynamicBatcher.warmup` runs each
bucket once before the port opens (the kernels' launch plans, cuDNN's and
cuBLAS's choices per shape).

Threading model: callers block on a per-request event; one worker thread
owns the generator and is the only thread that drives the card, so the
kernel wrappers' launch counters and per-stream scratch see one launching
thread at a time. Grad mode and the current CUDA device are per thread in
torch: the generator enters ``torch.inference_mode()`` itself, and the
``generate_fn`` that ``cli/serve.py`` builds enters its bundle's device.
The first request of a batch waits up to ``max_wait_ms`` for co-riders,
which turns a burst of N requests into one bucket-N call.

This module imports only the standard library and numpy.
"""

from __future__ import annotations

import dataclasses
import queue
import random
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

# server-picked seeds for seed=None requests: fresh, non-reproducible,
# no collision with any client's explicit small-integer seed in practice
_SEED_PICKER = random.SystemRandom()


@dataclasses.dataclass
class GenerateRequest:
    """One image request. ``seed=None`` lets the server draw a fresh random
    seed for the request (non-reproducible); an explicit seed is honored
    per-sample regardless of batch composition (see SD1Generator
    per-sample seeds)."""

    prompt: str
    negative_prompt: str = ""
    seed: Optional[int] = None


class Future:
    """Minimal completion handle: ``result()`` blocks until the worker
    fulfils or fails the request."""

    def __init__(self):
        self._event = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def _fulfil(self, result: np.ndarray):
        self._result = result
        self._event.set()

    def _fail(self, err: BaseException):
        self._error = err
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result


# generate_fn contract: (prompts, negative_prompts, seeds) -> uint8 images
# (B, H, W, 3); all three lists have the same (bucket) length.
GenerateFn = Callable[[Sequence[str], Sequence[str], Sequence[Optional[int]]],
                      np.ndarray]

_SHUTDOWN = object()


@dataclasses.dataclass
class _WarmupBatch:
    """An indivisible bucket-sized warm-up request: submitted as ONE worker
    item so the coalescing window cannot split it into smaller buckets."""

    bucket: int
    prompt: str


class DynamicBatcher:
    def __init__(self, generate_fn: GenerateFn,
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 max_wait_ms: float = 25.0, max_queue: int = 256):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError("buckets must be sorted, unique, non-empty")
        self.generate_fn = generate_fn
        self.buckets = tuple(int(b) for b in buckets)
        self.max_wait_s = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._closed = False
        self._lock = threading.Lock()
        self._metrics = {
            "requests": 0, "served": 0, "failed": 0, "batches": 0,
            "batched_requests": 0,  # sum of real (unpadded) batch sizes
            "padded_slots": 0,
        }
        self._latencies_ms: list = []  # ring of recent end-to-end latencies
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="fdsd-batcher")
        self._worker.start()

    # ----------------------------------------------------------------- API

    def submit(self, request: GenerateRequest) -> Future:
        fut = Future()
        if self._closed:
            fut._fail(RuntimeError("server shutting down"))
            return fut
        with self._lock:
            self._metrics["requests"] += 1
        try:
            self._q.put_nowait((request, fut, time.monotonic()))
        except queue.Full:
            with self._lock:
                self._metrics["failed"] += 1
            fut._fail(RuntimeError("server overloaded: request queue full"))
        return fut

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               prompt: str = "") -> None:
        """Run each bucket once before serving traffic.
        Each bucket goes through the queue as ONE indivisible
        ``_WarmupBatch`` item (the worker remains the only thread driving
        the generator, and the coalescing window cannot split the batch —
        b single requests could race it and leave the bucket unwarmed)."""
        for b in buckets or self.buckets:
            if b not in self.buckets:
                raise ValueError(f"unknown bucket {b}; have {self.buckets}")
            fut = Future()
            self._q.put((_WarmupBatch(int(b), prompt), fut,
                         time.monotonic()))
            fut.result()

    def metrics(self) -> dict:
        with self._lock:
            m = dict(self._metrics)
            lat = sorted(self._latencies_ms)
        m["queue_depth"] = self._q.qsize()
        m["mean_batch"] = (m["batched_requests"] / m["batches"]
                           if m["batches"] else 0.0)
        if lat:
            m["latency_ms_p50"] = lat[len(lat) // 2]
            m["latency_ms_p95"] = lat[min(len(lat) - 1,
                                          int(len(lat) * 0.95))]
        return m

    def shutdown(self, timeout: float = 10.0) -> None:
        self._closed = True  # reject submits that would never be served
        self._q.put(_SHUTDOWN)
        self._worker.join(timeout)

    # -------------------------------------------------------------- worker

    def _loop(self):
        stash = []  # warmup item dequeued mid-coalesce; handled next round
        while True:
            item = stash.pop() if stash else self._q.get()
            if item is _SHUTDOWN:
                self._drain_and_fail(stash)
                return
            if isinstance(item[0], _WarmupBatch):
                self._run_warmup(item)
                continue
            batch = [item]
            stop = False
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.buckets[-1]:
                remaining = deadline - time.monotonic()
                try:
                    nxt = (self._q.get_nowait() if remaining <= 0
                           else self._q.get(timeout=remaining))
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    stop = True
                    break
                if isinstance(nxt[0], _WarmupBatch):
                    stash.append(nxt)
                    break
                batch.append(nxt)
            self._run(batch)
            if stop:
                self._drain_and_fail(stash)
                return

    def _drain_and_fail(self, stash):
        """On shutdown, fail every future still queued (or stashed
        mid-coalesce) — otherwise callers blocked in Future.result() with
        no timeout (warmup() is one) would hang forever."""
        err = RuntimeError("server shutting down")
        items = list(stash)
        stash.clear()
        while True:
            try:
                items.append(self._q.get_nowait())
            except queue.Empty:
                break
        n = 0
        for item in items:
            if item is _SHUTDOWN:
                continue
            _, fut, _ = item
            fut._fail(err)
            n += 1
        if n:
            with self._lock:
                self._metrics["failed"] += n

    def _run_warmup(self, item):
        wb, fut, _ = item
        try:
            self.generate_fn([wb.prompt] * wb.bucket, [""] * wb.bucket,
                             [0] * wb.bucket)
        except BaseException as e:  # noqa: BLE001
            fut._fail(e)
            return
        fut._fulfil(None)

    def _run(self, batch):
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        reqs = [r for r, _, _ in batch]
        pad = reqs[0]
        padded = reqs + [pad] * (bucket - n)
        try:
            images = self.generate_fn(
                [r.prompt for r in padded],
                [r.negative_prompt for r in padded],
                [r.seed if r.seed is not None
                 else _SEED_PICKER.randrange(1 << 31) for r in padded])
            images = np.asarray(images)
            if images.shape[0] != bucket:
                raise RuntimeError(
                    f"generate_fn returned {images.shape[0]} images "
                    f"for bucket {bucket}")
        except BaseException as e:  # noqa: BLE001 — fail futures, keep serving
            with self._lock:
                self._metrics["failed"] += n
                self._metrics["batches"] += 1
                self._metrics["batched_requests"] += n
                self._metrics["padded_slots"] += bucket - n
            for _, fut, _ in batch:
                fut._fail(e)
            return
        done = time.monotonic()
        with self._lock:
            self._metrics["served"] += n
            self._metrics["batches"] += 1
            self._metrics["batched_requests"] += n
            self._metrics["padded_slots"] += bucket - n
            for _, _, t_enq in batch:
                self._latencies_ms.append(round((done - t_enq) * 1e3, 3))
            del self._latencies_ms[:-1000]
        for i, (_, fut, _) in enumerate(batch):
            fut._fulfil(images[i])
