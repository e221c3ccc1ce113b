"""CLIP contrastive training of stage 05 (port of
``pipelines/clip_trainer.py``).

The reference builds CLIP / SigLIP towers but never trains them
(05_clip/01_check.py runs shape checks only). One train step: the symmetric
InfoNCE of the cosine logits (:func:`..models.clip.clip_contrastive_loss`),
backward, then AdamW at a constant ``lr`` with optax's defaults (b1 0.9, b2
0.999, eps 1e-8) and ``weight_decay`` on every parameter, ``logit_scale``
included, with no clipping and no schedule; after the update
``logit_scale`` is clamped to at most ln(100), as in the original CLIP
recipe, with the Adam moments untouched. Parameters are fp32; a
``CLIP(dtype=torch.bfloat16)`` computes its towers in bf16.

The model passed in describes what to train (the JAX trainer takes the Flax
module): :meth:`CLIPTrainer.create_state` builds it on the device from
``model.config``, its vision tower's position table sized by
``image_shape`` as the JAX tower's is by its first input. ``fit`` keeps the
JAX loop: the epoch with the lowest mean loss saved, and under SIGTERM the
epoch it stopped in, then a return; it restores nothing.

``mesh=`` (a data mesh) replicates the state and shards the batch, as the
JAX trainer does, where the logits are global batch x global batch. On a
process-group mesh (form (b)) each rank encodes its shard and gathers the
normalised features of both towers (``AxisComm.gather_batch``, whose
backward sums the ranks' gradients) before the logits, so that every rank
computes the global loss; the gradients are averaged over the ranks, and
the clamp follows the averaged update on every rank alike. On a
one-process mesh (form (a)) the step is the meshless one.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Mapping, Optional

import torch

from ..models.clip import CLIP, clip_contrastive_loss
from ..parallel.mesh import mesh_device, shard_batch
from ..utils.logging import MetricsLogger
from .ddpm_trainer import (TrainState, apply_update, data_axis, init_params,
                           new_train_state, replicated_layout, split_ranks,
                           train_epochs)

MAX_LOGIT_SCALE = math.log(100.0)


class CLIPTrainer:
    def __init__(self, model: CLIP, lr: float = 1e-4,
                 weight_decay: float = 0.1, mesh=None,
                 logger: Optional[MetricsLogger] = None, seed: int = 0,
                 device="cuda"):
        self.model = model
        self.lr = lr
        self.weight_decay = weight_decay
        self.seed = seed
        self.mesh = mesh
        self.data = data_axis(mesh)
        self.device = torch.device(mesh_device(mesh) if mesh is not None
                                   else device)
        self.logger = logger or MetricsLogger()
        self.history: List[dict] = []

    def make_model(self, image_shape, text_len: int) -> CLIP:
        """``model.config`` for (H, W, 3) images and ``text_len`` tokens,
        with uninitialised storage on the device."""
        cfg = self.model.config
        h, w = image_shape[:2]
        if h != w:
            raise ValueError(f"square images only, got {tuple(image_shape)}")
        if text_len != cfg["context_length"]:
            raise ValueError(f"text_len {text_len} != the model's "
                             f"context_length {cfg['context_length']}")
        with torch.device("meta"):
            model = CLIP(**{**cfg, "image_resolution": h})
        return model.to_empty(device=self.device)

    def create_state(self, image_shape, text_len: int,
                     params: Optional[Mapping] = None) -> TrainState:
        """Random init with the JAX module's initializers, seeded with
        ``seed``, or the JAX parameter tree ``params`` (``TrainState.params``
        of the JAX trainer); AdamW with no update made."""
        model = self.make_model(image_shape, text_len)
        init_params(model, self.seed, params)
        lr = self.lr
        return new_train_state(model.train(), None, schedule=lambda count: lr,
                               weight_decay=self.weight_decay,
                               layout=replicated_layout(model, self.mesh))

    def num_params(self, state: TrainState) -> int:
        return sum(p.numel() for p in state.model.parameters())

    def train_step(self, state: TrainState, images, tokens):
        """One update on a batch of (B, H, W, 3) images and (B, L) token
        ids (the whole batch on a mesh); returns (state, loss)."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        gather = None
        if self.mesh is not None:
            images, tokens = shard_batch(self.mesh, (images, tokens))
            if split_ranks(self.data) > 1:
                gather = self.data.gather_batch
        logits_per_image, _ = state.model.train()(images, tokens, gather)
        loss = clip_contrastive_loss(logits_per_image)
        apply_update(state, loss, None, None)
        with torch.no_grad():
            state.model.logit_scale.clamp_(max=MAX_LOGIT_SCALE)
        return state, loss.detach()

    def fit(self, loader: Iterable, state: Optional[TrainState] = None,
            epochs: int = 1, image_shape=(224, 224, 3), text_len: int = 77,
            checkpoint_dir: Optional[str] = None) -> TrainState:
        """``epochs`` passes over ``loader``'s (images, tokens) batches,
        logging each epoch's mean loss and seconds."""
        if state is None:
            state = self.create_state(image_shape, text_len)
        return train_epochs(self, loader, state, epochs, checkpoint_dir,
                            resume=False, prefetch=False)
