"""Tiny-SD (stage 06) DDPM training and sampling on one device (port of
``pipelines/ddpm_trainer.py``).

One train step: labels+1 with a uniform drop to 0 (p = ``train_rand``) for
CFG training, the q-sample loss ``sum()/batch_size²``, backward, the global
gradient norm clipped to ``grad_clip`` as ``optax.clip_by_global_norm``
does (no epsilon), AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
weight decay 1e-4 on every parameter) at the warmup-cosine rate of the
update count before this one, and an optional EMA of the parameters.
Parameters are fp32; ``config.dtype="bf16"`` computes every linear and conv
in bf16 (the JAX ``POLICIES["bf16"]``).

Not ported (ROADMAP.md): the device mesh and FSDP, LoRA, gradient
accumulation, the latent encode/decode hooks, Orbax checkpoint/resume and
the preemption guard.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..io.from_jax import load_jax_params
from ..models.tiny_unet import TinyUNet
from ..ops.schedules import cosine_warmup_lr, ddpm_tables
from ..samplers.ddpm import ddpm_loss, ddpm_sample
from ..utils.config import TinySDConfig
from ..utils.dtypes import POLICIES
from .sd1 import flax_default_init_

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer with its moments, the LR
    schedule, the number of updates made, and the optional EMA."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float):
    """Scales ``grads`` in place by max_norm / ‖grads‖ when the global norm
    is at least ``max_norm`` (``optax.clip_by_global_norm``: no epsilon,
    unlike ``clip_grad_norm_``); returns the norm. Foreach ops, so a few
    launches instead of two per parameter."""
    norm = torch.nn.utils.get_total_norm(grads, 2.0)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


def new_train_state(model: nn.Module, cfg, steps_per_epoch: int = 1, *,
                    schedule: Optional[Callable[[int], float]] = None,
                    weight_decay: float = 1e-4) -> TrainState:
    """The state the trainers start from: AdamW with optax's defaults and
    ``weight_decay`` at ``schedule``, by default the warmup-cosine rate of
    ``cfg`` (lr, max_lr, warmup_epochs, epoch); no update made, and a copy
    of the parameters as the EMA when ``cfg`` has an ``ema_decay``."""
    if schedule is None:
        schedule = cosine_warmup_lr(cfg.lr, cfg.max_lr, cfg.warmup_epochs,
                                    cfg.epoch, max(1, steps_per_epoch))
    optimizer = torch.optim.AdamW(model.parameters(), lr=schedule(0),
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if getattr(cfg, "ema_decay", None) else None)
    return TrainState(model, optimizer, schedule, 0, ema)


def apply_update(state: TrainState, loss: torch.Tensor, grad_clip: float,
                 ema_decay: Optional[float]) -> None:
    """One update of ``state`` in place from a scalar ``loss``: backward,
    the global gradient norm clipped to ``grad_clip``, AdamW at the rate of
    the update count before this one, the EMA, and the count."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = list(state.model.parameters())
    clip_by_global_norm_([p.grad for p in params], grad_clip)
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    if state.ema_params is not None:
        ema = list(state.ema_params.values())
        with torch.no_grad():
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
    state.step += 1


class DDPMTrainer:
    """Pixel-space DDPM training of the class-conditional :class:`TinyUNet`."""

    def __init__(self, config: TinySDConfig, device="cuda"):
        if config.mesh_shape or config.grad_accum != 1:
            raise NotImplementedError(
                "mesh_shape and grad_accum are not ported: one device, one "
                "micro-batch per update")
        self.cfg = config
        self.device = torch.device(device)
        self.dtype = POLICIES[config.dtype].compute_dtype
        self.sample_shape = (config.img_size, config.img_size,
                             config.img_channel)
        self.tables = ddpm_tables(config.beta_1, config.beta_T, config.T)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self.history: List[dict] = []

    def make_model(self) -> TinyUNet:
        """The configured model with uninitialised storage on the device."""
        cfg = self.cfg
        with torch.device("meta"):
            model = TinyUNet(out_channels=cfg.img_channel,
                             base_channels=cfg.channel,
                             channel_mult=tuple(cfg.channel_multy),
                             num_classes=cfg.num_class, dropout=cfg.dropout,
                             dtype=self.dtype)
        return model.to_empty(device=self.device)

    # ---------------- state ----------------
    def create_state(self, steps_per_epoch: int,
                     params: Optional[Mapping] = None) -> TrainState:
        """Random init with Flax's default initializers, seeded with
        ``config.seed``, or the JAX parameter tree ``params`` (nested dict
        of numpy arrays) when given."""
        cfg = self.cfg
        model = self.make_model()
        if params is not None:
            load_jax_params(model, params)
        else:
            flax_default_init_(model, torch.Generator(
                device=self.device).manual_seed(cfg.seed))
        model = model.to(memory_format=torch.channels_last).train()
        return new_train_state(model, cfg, steps_per_epoch)

    def num_params(self, state: TrainState) -> int:
        return sum(p.numel() for p in state.model.parameters())

    # ---------------- train ----------------
    def train_step(self, state: TrainState, images, labels, *, drop=None,
                   t=None, noise=None):
        """One update on a batch of images (B, H, W, C) in [−1, 1] and
        0-based labels (B,); returns (state, loss). ``drop`` (the CFG drop
        mask), ``t`` and ``noise`` are drawn from the trainer's generator
        (seeded with ``config.seed + 1``) unless given."""
        cfg, dev, gen = self.cfg, self.device, self.generator
        x0 = torch.as_tensor(images, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels, device=dev).long() + 1
        if drop is None:
            drop = torch.rand(labels.shape, generator=gen,
                              device=dev) < cfg.train_rand
        labels = torch.where(torch.as_tensor(drop, device=dev),
                             torch.zeros_like(labels), labels)
        model = state.model.train()
        loss = ddpm_loss(model, self.tables, x0, labels, cfg.T, gen, t=t,
                         noise=noise).sum() / (cfg.batch_size ** 2)
        apply_update(state, loss, cfg.grad_clip, cfg.ema_decay)
        return state, loss.detach()

    def fit(self, loader: Iterable, state: Optional[TrainState] = None,
            epochs: Optional[int] = None) -> TrainState:
        """Trains for ``epochs`` (``config.epoch``) passes over ``loader``,
        logging the mean loss and images per second of each epoch."""
        if state is None:
            state = self.create_state(len(loader))
        for epoch in range(epochs or self.cfg.epoch):
            t0 = time.perf_counter()
            total, count = torch.zeros((), device=self.device), 0
            for images, labels in loader:
                state, loss = self.train_step(state, images, labels)
                total += loss
                count += 1
            epoch_loss = float(total) / max(count, 1)
            dt = time.perf_counter() - t0
            rec = dict(epoch=epoch, loss=epoch_loss, sec=dt,
                       imgs_per_sec=count * self.cfg.batch_size / dt)
            self.history.append(rec)
            log.info("epoch %(epoch)d loss %(loss).6f %(sec).2f s "
                     "%(imgs_per_sec).1f img/s", rec)
        return state

    # ---------------- sample ----------------
    @torch.no_grad()
    def sample(self, state: TrainState, labels,
               use_ema: bool = False) -> torch.Tensor:
        """CFG ancestral sampling over ``config.T`` steps, noise seeded with
        ``config.seed + 2``; ``labels`` are 1-based class ids
        (0 = unconditional). Returns (N, H, W, C) in [−1, 1]."""
        cfg, dev = self.cfg, self.device
        generator = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
        labels = torch.as_tensor(np.asarray(labels), device=dev).long()
        model = state.model.eval()
        params = state.ema_params if use_ema else None
        if params is None:
            model_fn = model
        else:
            model_fn = lambda x, t, y: functional_call(model, params,
                                                       (x, t, y))
        x_T = torch.randn((labels.shape[0],) + self.sample_shape,
                          generator=generator, device=dev)
        return ddpm_sample(model_fn, self.tables, x_T, labels, cfg.T,
                           w=cfg.w, generator=generator)
