"""Serving on the card: dynamic batching + HTTP front-end (port of
``serving/``): a generator (``SD1Generator``, ``SD3Inferencer``) behind a
bucketed dynamic batcher and a stdlib HTTP endpoint."""

from .batcher import DynamicBatcher, Future, GenerateRequest
from .server import make_server, serve_forever_in_thread

__all__ = ["DynamicBatcher", "Future", "GenerateRequest", "make_server",
           "serve_forever_in_thread"]
