"""Stdlib HTTP front-end over the DynamicBatcher (port of
``serving/server.py``).

Endpoints:

  POST /v1/generate   {"prompt": str, "negative_prompt"?: str, "seed"?: int,
                       "format"?: "png" | "json"}
                      → image/png bytes (default), or JSON
                        {"shape": [...], "dtype": "uint8",
                         "image_b64": "<base64 raw RGB>"}
  GET  /healthz       → {"ok": true, ...batcher counters}
  GET  /metrics       → batcher counters + latency percentiles + batch stats

Errors: 400 for a body that is not a JSON object with a 'prompt' or a
'seed' that is not an integer, 404 for another path, 500 when generation
raised, 504 when it did not finish within ``request_timeout_s``.

Uses ThreadingHTTPServer: each connection blocks on its request's Future
while the single batcher worker drives the card. The PNG comes from the
port's stdlib encoder (``ops/image.py::encode_png``), so serving needs no
Pillow.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..ops.image import encode_png
from .batcher import DynamicBatcher, GenerateRequest


class _Server(ThreadingHTTPServer):
    # A burst of requests connects at once. With socketserver's listen
    # backlog of 5, a connection past the accept queue waits for the
    # client's SYN retry (about 1 s) and misses the batcher's coalescing
    # window, so a burst of 8 rides in two batches.
    request_queue_size = 128


def make_server(batcher: DynamicBatcher, host: str = "127.0.0.1",
                port: int = 8000,
                request_timeout_s: float = 600.0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server. ``port=0`` binds an ephemeral port
    (tests); read it back from ``server.server_address[1]``."""

    class Handler(BaseHTTPRequestHandler):
        # quieter than the default stderr-per-request logger
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send_json(self, obj, status=200):
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send_json({"ok": True, **batcher.metrics()})
            elif self.path == "/metrics":
                self._send_json(batcher.metrics())
            else:
                self._send_json({"error": "not found"}, status=404)

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/generate":
                self._send_json({"error": "not found"}, status=404)
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                prompt = payload["prompt"]
            except (KeyError, ValueError, json.JSONDecodeError):
                self._send_json(
                    {"error": "body must be JSON with a 'prompt' field"},
                    status=400)
                return
            seed = payload.get("seed")
            if seed is not None and not isinstance(seed, int):
                self._send_json({"error": "'seed' must be an integer"},
                                status=400)
                return
            req = GenerateRequest(prompt=str(prompt),
                                  negative_prompt=str(
                                      payload.get("negative_prompt", "")),
                                  seed=seed)
            try:
                image = batcher.submit(req).result(timeout=request_timeout_s)
            except TimeoutError:
                self._send_json({"error": "generation timed out"}, status=504)
                return
            except Exception as e:  # noqa: BLE001 — surface as 500, keep serving
                self._send_json({"error": str(e)}, status=500)
                return
            if payload.get("format", "png") == "json":
                self._send_json({
                    "shape": list(image.shape),
                    "dtype": "uint8",
                    "image_b64": base64.b64encode(
                        np.ascontiguousarray(image, np.uint8).tobytes()
                    ).decode(),
                })
            else:
                body = encode_png(image)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

    return _Server((host, port), Handler)


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="fdsd-http")
    t.start()
    return t
