"""Rectified-flow training and sampling of the SD3 MMDiT on one device (port
of ``pipelines/mmdit_trainer.py``).

One train step: t logit-normal (sigmoid of a standard normal), the
resolution shift σ = shift·t / (1 + (shift − 1)·t), the blend
x_σ = σ·ε + (1 − σ)·x₀, the model called at timestep σ·num_timesteps and
regressed (mean squared error) onto the velocity ε − x₀, which is what the
flow-Euler sampler consumes. For CFG training the context and the pooled
vector of an example are zeroed together with probability ``train_rand``.
Then backward, the global gradient norm clipped to ``grad_clip``, AdamW
with optax's defaults at the warmup-cosine rate, and an optional EMA, as in
:mod:`.ddpm_trainer`. Parameters are fp32; ``config.dtype="bf16"`` computes
every linear and the patchify conv in bf16 (the JAX ``POLICIES["bf16"]``).
With at least 512 latent tokens on the card the joint attention of every
block runs the position-masked flash kernels, forward and backward.

Sampling: CFG flow-Euler over ``sd3_sigma_schedule``; the unconditional
branch is zeroed conditioning (the training drop), batched with the
conditional one as a single 2B forward.

Not ported (ROADMAP.md, queue items A3, trainer features, and A8, the
parallel package): the device mesh with data, tensor and sequence
parallelism, FSDP, the Switch-MoE MLP and its auxiliary loss, LoRA, gradient
accumulation, checkpoint / resume and the preemption guard, device prefetch.
"""

from __future__ import annotations

import logging
import time
from typing import Iterable, List, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..io.from_jax import load_jax_params
from ..models.mmdit import MMDiT, MMDiTConfig
from ..ops.schedules import sd3_sigma_schedule
from ..samplers.flow import flow_euler_sample, noise_scaling
from ..utils.config import FlowTrainConfig
from ..utils.dtypes import POLICIES
from .ddpm_trainer import TrainState, apply_update, new_train_state
from .sd1 import flax_default_init_

log = logging.getLogger(__name__)


class MMDiTTrainer:
    """Trains an MMDiT velocity predictor on (latents, context, y) batches:
    ``latents`` (B, H, W, C) NHWC at ``cfg.img_size``, ``context``
    (B, Lc, context_dim), ``y`` (B, adm) pooled conditioning (None where the
    model config disables either)."""

    def __init__(self, model_cfg: MMDiTConfig, cfg: FlowTrainConfig,
                 device="cuda", mesh=None, fsdp: bool = False,
                 lora_rank: Optional[int] = None, base_params=None):
        unported = {
            "mesh": mesh is not None, "fsdp": fsdp,
            "lora_rank": bool(lora_rank),
            "base_params": base_params is not None,
            "cfg.mesh_shape": bool(cfg.mesh_shape),
            "cfg.grad_accum": cfg.grad_accum != 1,
            "cfg.epoch_awoken": cfg.epoch_awoken is not None,
        }
        asked = [name for name, on in unported.items() if on]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: not ported yet (ROADMAP.md, queue items A3, "
                "trainer features, and A8, the parallel package); one "
                "device, one micro-batch per update, no checkpoints")
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = torch.device(device)
        self.policy = POLICIES[cfg.dtype]
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self.history: List[dict] = []

    def make_model(self) -> MMDiT:
        """The configured model with uninitialised storage on the device
        (``MMDiT`` refuses the attention, int8 and MoE options that are not
        ported)."""
        policy = self.policy
        compute = (None if policy.compute_dtype == policy.param_dtype
                   else policy.compute_dtype)
        with torch.device("meta"):
            model = MMDiT(self.model_cfg, compute_dtype=compute)
        return model.to_empty(device=self.device).to(policy.param_dtype)

    # ---------------- state ----------------
    def create_state(self, steps_per_epoch: int,
                     params: Optional[Mapping] = None) -> TrainState:
        """Random init with Flax's default initializers, seeded with
        ``config.seed``, or the JAX parameter tree ``params`` (nested dict
        of numpy arrays, ``TrainState.params`` of the JAX trainer) when
        given."""
        model = self.make_model()
        if params is not None:
            load_jax_params(model, params)
        else:
            flax_default_init_(model, torch.Generator(
                device=self.device).manual_seed(self.cfg.seed))
        return new_train_state(model.train(), self.cfg, steps_per_epoch)

    def num_params(self, state: TrainState) -> int:
        return sum(p.numel() for p in state.model.parameters())

    # ---------------- train ----------------
    def _sigma_of_t(self, t):
        s = self.cfg.shift
        return s * t / (1.0 + (s - 1.0) * t)

    def _to_device(self, a):
        return (None if a is None else
                torch.as_tensor(a, dtype=torch.float32, device=self.device))

    def loss(self, state: TrainState, latents, context, y, *, t_lin=None,
             noise=None, drop=None) -> torch.Tensor:
        """The velocity loss of a batch under ``state``'s parameters,
        differentiable. ``t_lin`` (B,) in (0, 1), ``noise`` (the latents'
        shape) and ``drop`` (B,) bool are drawn from the trainer's generator
        (seeded with ``config.seed + 1``) unless given."""
        cfg, dev, gen = self.cfg, self.device, self.generator
        x0, context, y = (self._to_device(a) for a in (latents, context, y))
        b = x0.shape[0]
        if t_lin is None:
            t_lin = torch.sigmoid(torch.randn(b, generator=gen, device=dev))
        if noise is None:
            noise = torch.randn(x0.shape, generator=gen, device=dev)
        if drop is None:
            drop = torch.rand(b, generator=gen, device=dev) < cfg.train_rand
        t_lin, noise = self._to_device(t_lin), self._to_device(noise)
        keep = ~torch.as_tensor(drop, device=dev).bool()
        sigma = self._sigma_of_t(t_lin)
        x_sigma = noise_scaling(sigma[:, None, None, None], noise, x0)
        if context is not None:
            context = context * keep[:, None, None]
        if y is not None:
            y = y * keep[:, None]
        out = state.model(x_sigma, sigma * cfg.num_timesteps, y, context)
        return torch.mean(torch.square(out - (noise - x0)))

    def train_step(self, state: TrainState, latents, context, y, **draws):
        """One update on a batch; returns (state, loss). ``draws``: the
        ``t_lin``, ``noise`` and ``drop`` of :meth:`loss`."""
        state.model.train()
        loss = self.loss(state, latents, context, y, **draws)
        apply_update(state, loss, self.cfg.grad_clip, self.cfg.ema_decay)
        return state, loss.detach()

    def fit(self, loader: Iterable, state: Optional[TrainState] = None,
            epochs: Optional[int] = None,
            checkpoint_dir: Optional[str] = None) -> TrainState:
        """Trains for ``epochs`` (``config.epoch``) passes over ``loader``
        of (latents, context, y) batches, logging the mean loss and samples
        per second of each epoch."""
        if checkpoint_dir:
            raise NotImplementedError(
                "checkpoint_dir: checkpoint / resume is not ported yet "
                "(ROADMAP.md, queue item A3: trainer features)")
        if state is None:
            state = self.create_state(len(loader))
        for epoch in range(epochs or self.cfg.epoch):
            t0 = time.perf_counter()
            total, count = torch.zeros((), device=self.device), 0
            for latents, context, y in loader:
                state, loss = self.train_step(state, latents, context, y)
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
    def sample(self, state: TrainState, context, y,
               steps: Optional[int] = None, use_ema: bool = False,
               noise=None) -> torch.Tensor:
        """CFG flow-Euler sampling from a trained state: (B, H, W, C)
        latents. ``noise`` is the initial standard-normal latent; otherwise
        it is drawn from a generator seeded with ``config.seed + 2``."""
        cfg, mc, dev = self.cfg, self.model_cfg, self.device
        context, y = self._to_device(context), self._to_device(y)
        steps = steps or cfg.sample_steps
        b = context.shape[0] if context is not None else y.shape[0]
        shape = (b, cfg.img_size, cfg.img_size, mc.in_channels)
        if noise is None:
            noise = torch.randn(shape, device=dev, generator=torch.Generator(
                device=dev).manual_seed(cfg.seed + 2))
        x = self._to_device(noise)
        if tuple(x.shape) != shape:
            raise ValueError(f"noise must be {shape}")
        ctx2 = (None if context is None else
                torch.cat([context, torch.zeros_like(context)]))
        y2 = None if y is None else torch.cat([y, torch.zeros_like(y)])
        model = state.model.eval()
        params = state.ema_params if use_ema else None

        def denoise(xt, sigma):
            xx = torch.cat([xt, xt])
            tt = torch.full((2 * b,), float(
                np.float32(sigma) * np.float32(cfg.num_timesteps)), device=dev)
            out = (model(xx, tt, y2, ctx2) if params is None else
                   functional_call(model, params, (xx, tt, y2, ctx2)))
            cond, uncond = out.chunk(2)
            return xt - (uncond + cfg.w * (cond - uncond)) * sigma

        return flow_euler_sample(denoise, x, steps=steps, sigmas=(
            sd3_sigma_schedule(steps, cfg.shift, cfg.num_timesteps)))
