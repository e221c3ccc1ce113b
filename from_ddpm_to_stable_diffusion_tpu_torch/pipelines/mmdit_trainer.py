"""Rectified-flow training and sampling of the SD3 MMDiT (port of
``pipelines/mmdit_trainer.py``).

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

The trainer features of ``pipelines/ddpm_trainer.py`` apply here too:
``cfg.grad_accum`` (``optax.MultiSteps`` semantics), LoRA (``lora_rank``,
``base_params``, ``lora_scale``: the frozen base merged with rank-r adapters
inside the loss), ``fit(checkpoint_dir=)`` with the preemption guard and
the resume from the latest step or ``cfg.epoch_awoken`` (on a
process-group mesh the whole state gathered and written by the first rank,
restored into any layout), batches staged on the card, the metrics logger.

The mesh (:mod:`..parallel`; ``mesh=`` or ``cfg.mesh_shape`` over the
visible devices of the trainer's kind) takes ``data``, ``seq`` and
``expert`` axes. The batch is placed by ``shard_batch``: one tensor on a
one-process mesh, each rank's slice on a process-group mesh, whose
gradients are then averaged over the data group. ``attention_impl`` "ring"
or "ulysses" shards each joint attention over ``seq``; ``moe_experts`` adds
``cfg.moe_aux_weight`` times the summed Switch balance losses to the loss
and shards the experts over ``expert``. A ``model`` axis runs the MMDiT
tensor-parallel (``parallel/sharding.py``: the joint attention on each
shard's heads, so its flash kernels forward and backward see H/n heads;
parameters, moments and EMA held by shard), ``fsdp=True`` stores the state
sharded over ``data`` (``parallel/fsdp.py``), and both together the JAX
hybrid layout: sharded over data x model, gathered over data only
(``ddpm_trainer.StateLayout``). A ``model`` axis composes with ring or
Ulysses attention over ``seq`` on the same mesh: each head shard runs its
own sequence-parallel joint attention, and the state is sharded over data
x model and replicated over seq.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Mapping, Optional

import numpy as np
import torch

from ..models.mmdit import MMDiT, MMDiTConfig, collect_losses
from ..ops.schedules import sd3_sigma_schedule
from ..parallel.mesh import (build_mesh, mesh_device, shard_batch,
                             visible_devices)
from ..samplers.flow import flow_euler_sample, noise_scaling
from ..utils.config import FlowTrainConfig
from ..utils.dtypes import POLICIES
from ..utils.logging import MetricsLogger
from .ddpm_trainer import (TrainState, apply_update, data_axis, init_params,
                           lay_out, new_train_state, rank_mean, split_ranks,
                           train_epochs)


class MMDiTTrainer:
    """Trains an MMDiT velocity predictor on (latents, context, y) batches:
    ``latents`` (B, H, W, C) NHWC at ``cfg.img_size``, ``context``
    (B, Lc, context_dim), ``y`` (B, adm) pooled conditioning (None where the
    model config disables either)."""

    def __init__(self, model_cfg: MMDiTConfig, cfg: FlowTrainConfig,
                 device="cuda", mesh=None, fsdp: bool = False,
                 logger: Optional[MetricsLogger] = None,
                 lora_rank: Optional[int] = None, base_params=None,
                 lora_scale: float = 1.0):
        """``lora_rank``: train rank-r adapters only, over ``base_params``
        (a JAX parameter tree of the MMDiT, e.g. an imported checkpoint's)
        or a fresh init. ``mesh``: a :class:`..parallel.Mesh` (form (a)
        over devices of ``device``'s kind, or form (b), whose rank's device
        the trainer takes); without one, ``cfg.mesh_shape`` builds one over
        every visible device of that kind, and with neither the trainer
        runs on ``device`` alone."""
        self.device = torch.device(device)
        if mesh is None and cfg.mesh_shape:
            mesh = build_mesh(cfg.mesh_shape,
                              visible_devices(self.device.type))
        sp = model_cfg.attention_impl in ("ring", "ulysses")
        if mesh is not None:
            self.device = torch.device(mesh_device(mesh))
        self.mesh = mesh
        self.fsdp = fsdp
        self.model_mesh = mesh if (sp or model_cfg.moe_experts) else None
        self.data = data_axis(mesh)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.logger = logger or MetricsLogger()
        self.lora_rank = lora_rank
        self.lora_scale = lora_scale
        self.base_params = base_params
        self.policy = POLICIES[cfg.dtype]
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self.history: List[dict] = []

    def make_model(self) -> MMDiT:
        """The configured model with uninitialised storage on the device,
        on the trainer's mesh where the config runs sequence-parallel
        attention or MoE."""
        policy = self.policy
        compute = (None if policy.compute_dtype == policy.param_dtype
                   else policy.compute_dtype)
        with torch.device("meta"):
            model = MMDiT(self.model_cfg, compute_dtype=compute,
                          mesh=self.model_mesh)
        return model.to_empty(device=self.device).to(policy.param_dtype)

    # ---------------- state ----------------
    def create_state(self, steps_per_epoch: int,
                     params: Optional[Mapping] = None) -> TrainState:
        """The model filled by ``ddpm_trainer.init_params`` from
        ``config.seed`` or ``params`` (``TrainState.params`` of the JAX
        trainer), and ``base_params`` under LoRA."""
        model = self.make_model()
        lora = init_params(model, self.cfg.seed, params,
                           lora_rank=self.lora_rank,
                           base_params=self.base_params)
        layout = lay_out(model, self.mesh, self.fsdp)
        return new_train_state(model.train(), self.cfg, steps_per_epoch,
                               lora=lora, lora_scale=self.lora_scale,
                               layout=layout)

    def num_params(self, state: TrainState) -> int:
        """The parameters that train (the adapters under LoRA)."""
        return sum(p.numel() for p in state.trainable().values())

    # ---------------- train ----------------
    def _sigma_of_t(self, t):
        s = self.cfg.shift
        return s * t / (1.0 + (s - 1.0) * t)

    def _to_device(self, a):
        return (None if a is None else
                torch.as_tensor(a, dtype=torch.float32, device=self.device))

    def _shard(self, a):
        """A global batch array on the mesh (each rank's slice on a
        process-group mesh), fp32."""
        if a is None or self.mesh is None:
            return self._to_device(a)
        return shard_batch(self.mesh, self._to_device(a))

    def loss(self, state: TrainState, latents, context, y, *, t_lin=None,
             noise=None, drop=None) -> torch.Tensor:
        """The velocity loss of a batch under ``state``'s parameters,
        differentiable. ``t_lin`` (B,) in (0, 1), ``noise`` (the latents'
        shape) and ``drop`` (B,) bool are drawn from the trainer's generator
        (seeded with ``config.seed + 1``) unless given. On a mesh the batch
        and the given draws are the whole batch's (``shard_batch`` places
        them); on a process-group mesh the loss is the rank's shard's. With
        ``moe_experts``: + ``cfg.moe_aux_weight`` · Σ balance losses."""
        cfg, dev, gen = self.cfg, self.device, self.generator
        x0, context, y = (self._shard(a) for a in (latents, context, y))
        b = x0.shape[0]
        t_lin = (torch.sigmoid(torch.randn(b, generator=gen, device=dev))
                 if t_lin is None else self._shard(t_lin))
        noise = (torch.randn(x0.shape, generator=gen, device=dev)
                 if noise is None else self._shard(noise))
        drop = (torch.rand(b, generator=gen, device=dev) < cfg.train_rand
                if drop is None else self._shard(drop).bool())
        keep = ~drop
        sigma = self._sigma_of_t(t_lin)
        x_sigma = noise_scaling(sigma[:, None, None, None], noise, x0)
        if context is not None:
            context = context * keep[:, None, None]
        if y is not None:
            y = y * keep[:, None]
        moe = bool(self.model_cfg.moe_experts)
        with (collect_losses(state.model) if moe
              else contextlib.nullcontext()) as sown:
            out = state.model_fn()(x_sigma, sigma * cfg.num_timesteps, y,
                                   context)
        loss = torch.mean(torch.square(out - (noise - x0)))
        if moe:
            loss = loss + cfg.moe_aux_weight * sum(sown.values())
        return loss

    def train_step(self, state: TrainState, latents, context, y, **draws):
        """One micro-step on a batch; returns (state, loss). ``draws``: the
        ``t_lin``, ``noise`` and ``drop`` of :meth:`loss`."""
        state.model.train()
        loss = self.loss(state, latents, context, y, **draws)
        apply_update(state, loss, self.cfg.grad_clip, self.cfg.ema_decay)
        return state, rank_mean(loss, self.data)

    def fit(self, loader: Iterable, state: Optional[TrainState] = None,
            epochs: Optional[int] = None,
            checkpoint_dir: Optional[str] = None) -> TrainState:
        """Trains for ``epochs`` (``config.epoch``) passes over ``loader``
        of (latents, context, y) batches (``ddpm_trainer.train_epochs``:
        checkpoints, the preemption guard, the resume, the epoch log). The
        logged ``epoch`` event carries ``epoch``, ``loss`` and ``sec``, as
        the JAX trainer logs it; ``history`` also keeps ``imgs_per_sec``."""
        if state is None:
            state = self.create_state(len(loader))
        return train_epochs(self, loader, state, epochs or self.cfg.epoch,
                            checkpoint_dir, batch_size=self.cfg.batch_size,
                            epoch_awoken=self.cfg.epoch_awoken,
                            log_rate=False)

    # ---------------- sample ----------------
    @torch.no_grad()
    def sample(self, state: TrainState, context, y,
               steps: Optional[int] = None, use_ema: bool = False,
               noise=None) -> torch.Tensor:
        """CFG flow-Euler sampling from a trained state: (B, H, W, C)
        latents, through the trainer's model (sequence-parallel or MoE
        where configured). ``noise`` is the initial standard-normal latent;
        otherwise it is drawn from a generator seeded with ``config.seed +
        2``. On a process-group mesh with a data axis the batch is sharded
        over it and the latents gathered back."""
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
        split = split_ranks(self.data) > 1
        if split:
            x, context, y = (None if a is None else self.data.scatter(a, 0)
                             for a in (x, context, y))
            b = x.shape[0]
        ctx2 = (None if context is None else
                torch.cat([context, torch.zeros_like(context)]))
        y2 = None if y is None else torch.cat([y, torch.zeros_like(y)])
        state.model.eval()
        model = state.model_fn(state.ema_params if use_ema else None)

        def denoise(xt, sigma):
            xx = torch.cat([xt, xt])
            tt = torch.full((2 * b,), float(
                np.float32(sigma) * np.float32(cfg.num_timesteps)), device=dev)
            out = model(xx, tt, y2, ctx2)
            cond, uncond = out.chunk(2)
            return xt - (uncond + cfg.w * (cond - uncond)) * sigma

        x = flow_euler_sample(denoise, x, steps=steps, sigmas=(
            sd3_sigma_schedule(steps, cfg.shift, cfg.num_timesteps)))
        return self.data.gather(x, 0) if split else x
