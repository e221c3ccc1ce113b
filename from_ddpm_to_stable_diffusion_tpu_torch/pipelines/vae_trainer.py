"""VAE / VQ-VAE training of stage 03 (port of ``pipelines/vae_trainer.py``).

One train step: the model's loss on a batch in training mode (VanillaVAE:
MSE + kld_weight · KLD with the reparameterisation noise drawn from the
trainer's generator, the BatchNorm running statistics updated by the
forward; VQ-VAE: MSE + the VQ loss), backward, then AdamW at ``lr`` with
``weight_decay`` and optax's other defaults, no clipping and no schedule.
Parameters are fp32; ``dtype="bf16"`` computes every conv and linear in
bf16. ``fit`` saves the epoch whose mean loss is the lowest so far (the
running statistics with it) and, under SIGTERM, the epoch it stopped in;
as in the JAX trainer it restores nothing. ``preview_dir`` receives a PNG
of the preview images over their reconstructions after each epoch.

``mesh=`` (a :class:`..parallel.Mesh` with a ``data`` axis) replicates the
state and shards the batch, as the JAX trainer does, and every reduction is
over the global batch: the BatchNorm statistics and their running update
(``models/vae.py::BatchNorm``), the losses (the mean of the ranks' equal
shards), the reparameterisation noise (drawn for the whole batch and
sliced). On a one-process mesh (form (a)) that is the meshless step; on a
process-group mesh (form (b)) each rank computes its shard, the gradients
are averaged over the ranks and the first rank writes the checkpoints
(:func:`.ddpm_trainer.save_checkpoint`).
"""

from __future__ import annotations

import os
import time
from typing import Iterable, List, Mapping, Optional

import torch

from ..io.from_jax import load_jax_params
from ..models.vae import VanillaVAE, VQVAE
from ..ops.image import image_grid, to_uint8, write_png
from ..parallel.mesh import mesh_device, shard_batch
from ..utils.checkpoint import CheckpointManager, PreemptionGuard
from ..utils.config import VAETrainConfig
from ..utils.dtypes import POLICIES
from ..utils.logging import MetricsLogger
from .ddpm_trainer import (TrainState, apply_update, data_axis,
                           new_train_state, rank_mean, replicated_layout,
                           save_checkpoint, split_ranks)
from .sd1 import flax_default_init_


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _on_mesh(trainer, tree):
    """A whole batch (a tree of arrays) on the trainer's device, sharded
    over its mesh's ``data`` axis where it has one."""
    if trainer.mesh is None:
        return tree
    return shard_batch(trainer.mesh, tree)


def _log_epoch(trainer, epoch: int, loss: float, t0: float, **extra):
    dt = time.perf_counter() - t0
    trainer.history.append(dict(epoch=epoch, loss=loss, sec=dt, **extra))
    trainer.logger.log("epoch", epoch=epoch, loss=loss, sec=round(dt, 2),
                       **extra)


class VAETrainer:
    """Trains ``config.model`` ("vanilla" or "vqvae") on image batches (B,
    H, W, 3) in [−1, 1]. ``mesh``: a data mesh (module docstring), whose
    device (form (a)) or rank's device (form (b)) the trainer takes."""

    def __init__(self, config: VAETrainConfig, device="cuda", mesh=None,
                 logger: Optional[MetricsLogger] = None):
        if config.model not in ("vanilla", "vqvae"):
            raise ValueError(f"unknown VAE model {config.model!r}")
        self.cfg = config
        self.mesh = mesh
        self.data = data_axis(mesh)
        self.device = torch.device(mesh_device(mesh) if mesh is not None
                                   else device)
        self.dtype = POLICIES[config.dtype].compute_dtype
        self.logger = logger or MetricsLogger()
        # the reparameterisation noise (the JAX fit's key(seed + 2))
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 2)
        self.history: List[dict] = []

    def make_model(self):
        """The configured model with uninitialised storage on the device."""
        cfg = self.cfg
        with torch.device("meta"):
            if cfg.model == "vanilla":
                model = VanillaVAE(image_size=cfg.img_size,
                                   latent_dim=cfg.latent_dim,
                                   dtype=self.dtype)
            else:
                model = VQVAE(embedding_dim=cfg.embedding_dim,
                              num_embeddings=cfg.num_embeddings,
                              dtype=self.dtype)
        return model.to_empty(device=self.device)

    def create_state(self, params: Optional[Mapping] = None,
                     batch_stats: Optional[Mapping] = None) -> TrainState:
        """Flax's default initializers seeded with ``config.seed`` and
        running statistics (0, 1), or the JAX trees ``params`` and (for the
        VanillaVAE) ``batch_stats``; AdamW with no update made."""
        model = self.make_model()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.cfg.seed)
            flax_default_init_(model, gen)
        else:
            load_jax_params(model, params, batch_stats)
        model = model.to(memory_format=torch.channels_last).train()
        lr = self.cfg.lr
        return new_train_state(model, None, schedule=lambda count: lr,
                               weight_decay=self.cfg.weight_decay,
                               layout=replicated_layout(model, self.mesh))

    def num_params(self, state: TrainState) -> int:
        return sum(p.numel() for p in state.model.parameters())

    def train_step(self, state: TrainState, images, *, eps=None):
        """One update on a batch; returns (state, metrics) with the loss and
        its terms. ``eps``: the VanillaVAE's reparameterisation noise (B,
        latent_dim), drawn from the trainer's generator unless given. On a
        mesh ``images`` and ``eps`` are the whole batch's."""
        x = _on(images, self.device)
        model = state.model.train()
        if self.cfg.model == "vanilla":
            if eps is None and split_ranks(self.data) > 1:
                # the whole batch's draw, sliced with the batch
                eps = torch.randn((x.shape[0], self.cfg.latent_dim),
                                  generator=self.generator,
                                  device=self.device)
            if eps is not None:
                eps = _on(eps, self.device)
            x, eps = _on_mesh(self, (x, eps))
            recon, mu, log_var = model(x, eps, self.generator)
            metrics = VanillaVAE.loss(recon, x, mu, log_var,
                                      self.cfg.kld_weight)
        else:
            x = _on_mesh(self, x)
            recon, vq_loss, _ = model(x)
            metrics = VQVAE.loss(recon, x, vq_loss)
        apply_update(state, metrics["loss"], None, None)
        return state, {k: rank_mean(v, self.data) for k, v in metrics.items()}

    @torch.no_grad()
    def reconstruct(self, state: TrainState, images, eps=None):
        """Reconstructions in eval mode (the running statistics); the
        VanillaVAE's noise is ``eps`` or a draw from a generator seeded 0."""
        x = _on(images, self.device)
        model = state.model.eval()
        if self.cfg.model == "vanilla":
            gen = torch.Generator(device=self.device).manual_seed(0)
            return model(x, eps, gen)[0]
        return model(x)[0]

    def fit(self, loader: Iterable, state: Optional[TrainState] = None,
            epochs: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            preview_batch=None, preview_dir: Optional[str] = None
            ) -> TrainState:
        """``epochs`` (``config.epoch``) passes over ``loader`` (batches of
        images, or tuples whose first entry is the images), logging each
        epoch's mean loss and seconds."""
        if state is None:
            state = self.create_state()
        ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        best = float("inf")
        with PreemptionGuard() as guard:
            for epoch in range(epochs or self.cfg.epoch):
                t0 = time.perf_counter()
                total, count = torch.zeros((), device=self.device), 0
                for batch in loader:
                    images = batch[0] if isinstance(batch, tuple) else batch
                    state, metrics = self.train_step(state, images)
                    total += metrics["loss"]
                    count += 1
                    if guard.should_stop:
                        break
                if guard.should_stop:
                    if ckpt:
                        save_checkpoint(ckpt, epoch, state, self.generator,
                                        force=True)
                    self.logger.log("preempted", epoch=epoch)
                    break
                loss = float(total) / max(count, 1)
                _log_epoch(self, epoch, loss, t0)
                if ckpt and loss < best:
                    best = loss
                    save_checkpoint(ckpt, epoch, state, self.generator)
                if preview_batch is not None and preview_dir:
                    self._save_preview(state, preview_batch, preview_dir,
                                       epoch)
        return state

    def _save_preview(self, state, images, out_dir, epoch):
        x = _on(images, self.device)
        pair = torch.cat([x, self.reconstruct(state, x)])
        grid = image_grid(to_uint8(pair).cpu().numpy(), nrow=len(x))
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(out_dir, f"recon_epoch{epoch:03d}.png"), grid)
