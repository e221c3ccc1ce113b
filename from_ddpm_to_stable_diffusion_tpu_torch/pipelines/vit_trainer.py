"""ViT classification training of stage 04 (port of
``pipelines/vit_trainer.py``).

One train step: cross entropy of the logits against integer labels (mean
over the batch) in training mode, so dropout is active, backward, then
AdamW at ``lr`` with optax's defaults (weight decay 1e-4, eps 1e-8), no
clipping and no schedule. Parameters are fp32; ``dtype="bf16"`` computes the
patchify and the blocks in bf16, the head in fp32. Dropout draws from
torch's global generator, so they cannot be the JAX step's; the parity tests
run without dropout. ``evaluate`` is the accuracy over a loader in eval
mode. ``fit`` saves the epoch whose validation accuracy is the best so far
and, under SIGTERM, the epoch it stopped in; as in the JAX trainer it
restores nothing.

``mesh=`` (a data mesh) replicates the state and shards the batch, as the
JAX trainer does: the loss and accuracy are the global batch's means (of
the ranks' equal shards) and, on a process-group mesh (form (b)), each
rank's dropout masks are its slice of the masks drawn for the whole batch
(``models/vit.py::dropout``; the ranks' global generators must be seeded
alike), the gradients averaged over the ranks and the checkpoints written
by the first rank. On a one-process mesh (form (a)) the step is the
meshless one.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Mapping, Optional

import torch
import torch.nn.functional as F

from ..io.from_jax import load_jax_params
from ..models.vit import ViT
from ..parallel.mesh import mesh_device
from ..utils.checkpoint import CheckpointManager, PreemptionGuard
from ..utils.config import ViTTrainConfig
from ..utils.dtypes import POLICIES
from ..utils.logging import MetricsLogger
from .ddpm_trainer import (TrainState, apply_update, data_axis,
                           new_train_state, rank_mean, replicated_layout,
                           save_checkpoint)
from .sd1 import flax_default_init_
from .vae_trainer import _log_epoch, _on, _on_mesh


class ViTTrainer:
    def __init__(self, config: ViTTrainConfig, device="cuda", mesh=None,
                 logger: Optional[MetricsLogger] = None):
        self.cfg = config
        self.mesh = mesh
        self.data = data_axis(mesh)
        self.device = torch.device(mesh_device(mesh) if mesh is not None
                                   else device)
        self.dtype = POLICIES[config.dtype].compute_dtype
        self.logger = logger or MetricsLogger()
        self.history: List[dict] = []

    def make_model(self) -> ViT:
        """The configured model with uninitialised storage on the device."""
        cfg = self.cfg
        with torch.device("meta"):
            model = ViT(image_size=cfg.img_size, patch_size=cfg.patch_size,
                        num_classes=cfg.num_class, dim=cfg.dim,
                        depth=cfg.depth, heads=cfg.heads,
                        mlp_dim=cfg.mlp_dim, dropout=cfg.dropout,
                        emb_dropout=cfg.emb_dropout, dtype=self.dtype)
        return model.to_empty(device=self.device)

    def create_state(self, params: Optional[Mapping] = None) -> TrainState:
        """Flax's default initializers seeded with ``config.seed``, or the
        JAX tree ``params``; AdamW with no update made."""
        model = self.make_model()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.cfg.seed)
            flax_default_init_(model, gen)
        else:
            load_jax_params(model, params)
        model = model.to(memory_format=torch.channels_last).train()
        lr = self.cfg.lr
        return new_train_state(model, None, schedule=lambda count: lr,
                               layout=replicated_layout(model, self.mesh))

    def num_params(self, state: TrainState) -> int:
        return sum(p.numel() for p in state.model.parameters())

    def train_step(self, state: TrainState, images, labels):
        """One update on a batch (the whole batch on a mesh); returns
        (state, loss, accuracy)."""
        x = _on(images, self.device)
        labels = torch.as_tensor(labels, device=self.device).long()
        x, labels = _on_mesh(self, (x, labels))
        logits = state.model.train()(x)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        apply_update(state, loss, None, None)
        return state, rank_mean(loss, self.data), rank_mean(acc, self.data)

    @torch.no_grad()
    def evaluate(self, state: TrainState, loader: Iterable) -> float:
        """Top-1 accuracy over ``loader``'s (images, labels) batches."""
        model = state.model.eval()
        correct = torch.zeros((), dtype=torch.long, device=self.device)
        total = 0
        for images, labels in loader:
            labels = torch.as_tensor(labels, device=self.device).long()
            logits = model(_on(images, self.device))
            correct += (logits.argmax(-1) == labels).sum()
            total += len(labels)
        return int(correct) / max(total, 1)

    def fit(self, train_loader: Iterable,
            val_loader: Optional[Iterable] = None,
            state: Optional[TrainState] = None, epochs: Optional[int] = None,
            checkpoint_dir: Optional[str] = None) -> TrainState:
        """``epochs`` (``config.epoch``) passes over ``train_loader``,
        logging each epoch's mean loss, seconds and, with ``val_loader``,
        the validation accuracy."""
        if state is None:
            state = self.create_state()
        ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        best_acc = -1.0
        with PreemptionGuard() as guard:
            for epoch in range(epochs or self.cfg.epoch):
                t0 = time.perf_counter()
                total, count = torch.zeros((), device=self.device), 0
                for images, labels in train_loader:
                    state, loss, _ = self.train_step(state, images, labels)
                    total += loss
                    count += 1
                    if guard.should_stop:
                        break
                if guard.should_stop:
                    if ckpt:
                        save_checkpoint(ckpt, epoch, state, None, force=True)
                    self.logger.log("preempted", epoch=epoch)
                    break
                extra = {}
                if val_loader is not None:
                    extra["val_acc"] = round(self.evaluate(state, val_loader),
                                             4)
                _log_epoch(self, epoch, float(total) / max(count, 1), t0,
                           **extra)
                if ckpt and extra.get("val_acc", 0.0) > best_acc:
                    best_acc = extra.get("val_acc", 0.0)
                    save_checkpoint(ckpt, epoch, state, None)
        return state
