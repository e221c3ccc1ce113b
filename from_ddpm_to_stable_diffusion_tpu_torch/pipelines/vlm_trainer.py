"""TinyVLM training and evaluation (port of ``pipelines/vlm_trainer.py``).

One train step: next-token cross entropy of the captions given the image
(:func:`..models.tiny_vlm.vlm_loss`), backward, the global gradient norm
clipped to 1.0, AdamW with optax's defaults and weight decay 0.01 at the
rate of ``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
max(total_steps, warmup_steps + 1), end_value=0.1·lr)``: the rate of the
first update is 0, so it moves no parameter (it does fill the moments).
Parameters are fp32; ``dtype="bf16"`` computes the tower, the decoder's
linears and the residual streams in bf16 (the JAX model's ``dtype=``).
``caption_accuracy`` and ``qa_accuracy`` are the end-to-end metrics:
exact-match greedy decodes against the dataset's ground truth.

``fit(checkpoint_dir=)`` saves the epoch whose loss is the lowest so far
and, under SIGTERM, the epoch it stopped in; as in the JAX trainer it
restores nothing.

``mesh=`` (a data mesh) replicates the state and shards the batch, as the
JAX trainer does, where the loss is the global batch's NLL sum over its
count of unpadded targets. On a process-group mesh (form (b)) each rank
divides its NLL sum by that global count (``vlm_loss(data_axis=)``), so the
loss is right however the ranks' captions are padded; the gradients are
averaged over the ranks, the clip sees their whole norm, and the first rank
writes the checkpoints. On a one-process mesh (form (a)) the step is the
meshless one.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping, Optional

import numpy as np
import torch

from ..io.shapes_dataset import VQA_ANSWER_START
from ..models.siglip import SiglipVisionConfig
from ..models.tiny_vlm import (TINY_VISION, TinyVLM, as_tensor_on,
                               greedy_decode, vlm_loss)
from ..ops.schedules import warmup_cosine_decay_lr
from ..parallel.mesh import mesh_device, shard_batch
from ..utils.dtypes import POLICIES
from ..utils.logging import MetricsLogger
from .ddpm_trainer import (TrainState, apply_update, data_axis, init_params,
                           new_train_state, rank_mean, replicated_layout,
                           train_epochs)


class VLMTrainer:
    """Trains a :class:`TinyVLM` on (images (B, S, S, 3) in [-1, 1], tokens
    (B, L) int) batches. The model is described by its arguments (the JAX
    trainer takes the Flax module) and built by :meth:`create_state` for the
    image size it is given."""

    def __init__(self, vocab_size: int, dim: int = 128, depth: int = 4,
                 num_heads: int = 4, max_text_len: int = 8,
                 vision_cfg: SiglipVisionConfig = TINY_VISION,
                 dtype: str = "fp32", lr: float = 3e-4,
                 weight_decay: float = 0.01, warmup_steps: int = 100,
                 total_steps: int = 2000, device="cuda", mesh=None,
                 logger: Optional[MetricsLogger] = None, seed: int = 0,
                 answer_start: int = 0):
        self.model_args = dict(vocab_size=vocab_size, dim=dim, depth=depth,
                               num_heads=num_heads, max_text_len=max_text_len,
                               vision_cfg=vision_cfg)
        self.max_text_len = max_text_len
        self.answer_start = answer_start   # VQA: mask the question's targets
        self.mesh = mesh
        self.data = data_axis(mesh)
        self.device = torch.device(mesh_device(mesh) if mesh is not None
                                   else device)
        self.policy = POLICIES[dtype]
        self.schedule = warmup_cosine_decay_lr(
            0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1),
            end_lr=lr * 0.1)
        self.weight_decay = weight_decay
        self.seed = seed
        self.logger = logger or MetricsLogger()
        self.history: List[dict] = []

    def make_model(self, image_size: int) -> TinyVLM:
        """The configured model with uninitialised storage on the device."""
        policy = self.policy
        compute = (None if policy.compute_dtype == policy.param_dtype
                   else policy.compute_dtype)
        with torch.device("meta"):
            model = TinyVLM(**self.model_args, image_size=image_size,
                            compute_dtype=compute)
        return model.to_empty(device=self.device).to(policy.param_dtype)

    def create_state(self, image_size: int,
                     params: Optional[Mapping] = None) -> TrainState:
        """Random init with Flax's default initializers, seeded with
        ``seed``, or the JAX parameter tree ``params`` (nested dict of numpy
        arrays, ``TrainState.params`` of the JAX trainer) when given."""
        model = self.make_model(image_size)
        init_params(model, self.seed, params)
        return new_train_state(model.train(), None, schedule=self.schedule,
                               weight_decay=self.weight_decay,
                               layout=replicated_layout(model, self.mesh))

    def num_params(self, state: TrainState) -> int:
        return sum(p.numel() for p in state.model.parameters())

    def _batch(self, images, tokens):
        batch = (as_tensor_on(images, self.device, torch.float32),
                 as_tensor_on(tokens, self.device, torch.long))
        return batch if self.mesh is None else shard_batch(self.mesh, batch)

    def loss(self, state: TrainState, images, tokens) -> torch.Tensor:
        """The caption loss of a batch (the whole batch on a mesh) under
        ``state``'s parameters, differentiable; on a process-group mesh the
        rank's share (``vlm_loss(data_axis=)``)."""
        images, tokens = self._batch(images, tokens)
        return vlm_loss(state.model_fn()(images, tokens), tokens,
                        answer_start=self.answer_start, data_axis=self.data)

    def train_step(self, state: TrainState, images, tokens):
        """One update on a batch; returns (state, loss)."""
        state.model.train()
        loss = self.loss(state, images, tokens)
        apply_update(state, loss, 1.0, None)
        return state, rank_mean(loss, self.data)

    def fit(self, loader: Iterable, state: Optional[TrainState] = None,
            epochs: int = 1, image_size: int = 64,
            checkpoint_dir: Optional[str] = None) -> TrainState:
        """Trains for ``epochs`` passes over ``loader`` of (images, tokens)
        batches, logging each epoch's mean loss and seconds
        (``ddpm_trainer.train_epochs`` without the resume and the device
        prefetch, as the JAX trainer's loop)."""
        if state is None:
            state = self.create_state(image_size)
        return train_epochs(self, loader, state, epochs, checkpoint_dir,
                            resume=False, prefetch=False)

    def _decoded(self, state, dataset, n, batch_size, prompt_len=None):
        """(greedy decode, ground truth) token rows of the first n examples."""
        for s in range(0, n, batch_size):
            imgs, toks = zip(*(dataset.load(i)
                               for i in range(s, min(s + batch_size, n))))
            prompts = (None if prompt_len is None
                       else np.stack(toks)[:, :prompt_len])
            got = greedy_decode(state.model, np.stack(imgs),
                                max_len=self.max_text_len, prompt_ids=prompts)
            yield from zip(got.cpu().numpy(), toks)

    def caption_accuracy(self, state: TrainState, dataset, n: int = 64,
                         batch_size: int = 32) -> float:
        """Exact-match greedy-caption accuracy over the first n examples."""
        return sum(dataset.decode(g) == dataset.decode(want) for g, want in
                   self._decoded(state, dataset, n, batch_size)) / n

    def qa_accuracy(self, state: TrainState, dataset, n: int = 64,
                    batch_size: int = 32) -> float:
        """Exact-match answer accuracy: each example is decoded from its
        [BOS | question] prefix and the answer spans are compared."""
        return sum(dataset.decode_answer(g) == dataset.decode_answer(want)
                   for g, want in self._decoded(state, dataset, n, batch_size,
                                                VQA_ANSWER_START)) / n
