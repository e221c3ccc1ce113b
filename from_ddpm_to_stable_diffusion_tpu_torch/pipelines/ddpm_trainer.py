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

The trainer features of the JAX package, on one device:
- ``grad_accum``: ``optax.MultiSteps`` semantics (:func:`apply_update`).
- ``lora_rank`` / ``base_params`` / ``lora_scale``: only rank-r adapters
  train (``utils/lora.py``); the base stays frozen.
- ``latent_encode_fn`` / ``latent_decode_fn``: latent-space training (the
  reference's ``03_train_with_vae``); ``model=`` / ``sample_shape=``.
- ``fit(checkpoint_dir=)``: the best epoch saved, a SIGTERM saving and
  stopping at the next step boundary, a resume from the latest (or
  ``epoch_awoken``) checkpoint, the trainer's generator included, so a
  resumed run draws what an uninterrupted one would. As in the JAX package,
  a resumed ``fit`` starts at the saved epoch's index, so that epoch runs
  again.
- batches staged on the card by ``io/data.py::prefetch_to_device``; the
  ``utils/logging.py::MetricsLogger`` events.

The mesh (:mod:`..parallel`; ``mesh=`` or ``config.mesh_shape`` over the
visible devices of the trainer's kind) takes a ``data`` axis: the batch is
placed by ``shard_batch``, one tensor on a one-process mesh (form (a)), each
rank's slice on a process-group mesh (form (b)), whose gradients are then
averaged over the ranks; the draws are made for the whole batch and sliced,
so both forms draw what one device would. ``fsdp=True`` stores every
parameter of at least ``MIN_SHARD_SIZE`` elements, and with it its AdamW
moments, EMA and accumulator, sharded over ``data`` (:class:`StateLayout`,
``parallel/fsdp.py``): views of the whole tensors in form (a), the rank's
slices in form (b), gathered at the top of the loss. Checkpoints hold the
whole state, so one written under FSDP restores without a mesh and the
other way round. On a process-group mesh the ranks gather their slices
into the whole state, the group's first rank writes it and the others wait
at a barrier (:func:`save_checkpoint`); a restore re-slices it to the
layout it is loaded into, whatever the layout that wrote it.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..io.data import prefetch_to_device
from ..io.from_jax import load_jax_params
from ..models.tiny_unet import TinyUNet
from ..ops.schedules import cosine_warmup_lr, ddpm_tables
from ..parallel.fsdp import (fsdp_dims, gather, global_grad_norm, mean_grads,
                             shard_params)
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, _all_gather, build_mesh,
                             mesh_device, replicate, shard_batch,
                             visible_devices)
from ..parallel.sharding import apply_tp, tp_roles, tp_slice
from ..samplers.ddpm import ddpm_loss, ddpm_sample
from ..utils.checkpoint import CheckpointManager, PreemptionGuard
from ..utils.config import TinySDConfig
from ..utils.dtypes import POLICIES
from ..utils.logging import MetricsLogger
from ..utils.lora import init_lora, lora_from_jax, merge_lora
from .sd1 import flax_default_init_


def _flat(tree: Mapping) -> Dict[str, torch.Tensor]:
    """name -> tensor of a parameter dict, or of a LoRA dict ({path: {"a",
    "b"}} as "path/a", "path/b")."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, Mapping):
            out.update((f"{name}/{k}", t) for k, t in v.items())
        else:
            out[name] = v
    return out


@dataclasses.dataclass
class StateLayout:
    """How a trainer's model lies on its mesh: ``data`` and ``model`` the
    axes' collectives (None where the mesh has no such axis),
    ``fsdp_dims`` the torch dim of each parameter stored sharded over
    ``data`` (None: replicated), ``tp_roles`` the ``parallel/sharding.py::
    tp_roles`` of the entries sharded over ``model``, ``group`` the process
    group of a form-(b) mesh. Only a process-group mesh (form (b)) changes
    what a step does: its ranks hold slices and their gradients are
    combined here."""

    data: Optional[object] = None
    model: Optional[object] = None
    fsdp_dims: Dict[str, Optional[int]] = dataclasses.field(
        default_factory=dict)
    tp_roles: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    group: Optional[object] = None

    @property
    def tp_sharded(self) -> frozenset:
        """The entries sharded over ``model``."""
        return frozenset(self.tp_roles)

    @classmethod
    def for_model(cls, model: nn.Module, mesh, fsdp: bool,
                  tp: bool = True) -> "StateLayout":
        """The layout of ``model`` (whole, not yet laid out) on ``mesh``;
        :meth:`lay_out` then switches it. ``tp``: whether a ``model`` axis
        shards the model (the JAX DDPM trainer replicates over it)."""
        if mesh is None:
            return cls()
        data = mesh.comm(DATA_AXIS) if DATA_AXIS in mesh.shape else None
        tp = (mesh.comm(MODEL_AXIS) if tp and mesh.shape.get(MODEL_AXIS, 1)
              > 1 else None)
        dims = {}
        if fsdp and data is not None and data.n > 1:
            dims = fsdp_dims(model, data.n, tp.n if tp else 1)
        return cls(data, tp, dims, tp_roles(model, tp.n) if tp else {},
                   mesh.group)

    @property
    def distributed(self) -> bool:
        return split_ranks(self.data) > 1 or split_ranks(self.model) > 1

    def lay_out(self, model: nn.Module, mesh) -> None:
        """TP (``apply_tp``), then the FSDP slices, in place."""
        if self.model is not None:
            apply_tp(model, mesh)
        if self.data is not None:
            shard_params(model, self.fsdp_dims, self.data)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of the entry ``name`` (a parameter, buffer,
        moment or EMA leaf) from this rank's slice: all-gathered over
        ``data`` on its FSDP dim, then over ``model`` by its TP role."""
        dim = self.fsdp_dims.get(name)
        if dim is not None and split_ranks(self.data) > 1:
            t = _all_gather(t, dim, self.data)
        role = self.tp_roles.get(name)
        if role is not None and split_ranks(self.model) > 1:
            _, groups, dim = role
            parts = _all_gather(t, dim, self.model).chunk(self.model.n, dim)
            t = torch.cat([torch.cat([p.unflatten(dim, (groups, -1))
                                      .select(dim, g) for p in parts], dim)
                           for g in range(groups)], dim)
        return t

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`whole`: this rank's slice of the whole tensor
        ``t`` of ``name``."""
        role = self.tp_roles.get(name)
        if role is not None and split_ranks(self.model) > 1:
            t = tp_slice(t, role, self.model.index[0], self.model.n)
        dim = self.fsdp_dims.get(name)
        if dim is not None and split_ranks(self.data) > 1:
            t = t.chunk(self.data.n, dim)[self.data.index[0]]
        return t

    def shard_delta(self, name: str, delta: torch.Tensor) -> torch.Tensor:
        """A whole LoRA update of the weight ``name`` as the slice that this
        rank's TP module computes with; the backward sums the slices'
        gradients over ``model`` (each rank saw only its own)."""
        if name not in self.tp_roles or split_ranks(self.model) < 2:
            return delta
        return tp_slice(self.model.copy_to(delta), self.tp_roles[name],
                        self.model.index[0], self.model.n)

    @property
    def writer(self) -> bool:
        """Whether this process writes the checkpoints: the group's first
        rank on a process-group mesh, else the one process."""
        return self.group is None or torch.distributed.get_rank(
            self.group) == 0

    def gather(self, params: Mapping[str, torch.Tensor]) -> dict:
        """The parameters the forward runs on: FSDP's slices gathered over
        ``data`` (form (b); form (a) stores them whole)."""
        if self.data is None:
            return dict(params)
        return gather(params, self.fsdp_dims, self.data)

    def reduce_grads(self, named: Mapping[str, torch.Tensor]) -> None:
        """Form (b), after the backward: the gradient of the mean of the
        data ranks' losses."""
        if split_ranks(self.data) > 1:
            mean_grads(named, self.fsdp_dims, self.data)

    def grad_norm(self, named_grads: Mapping[str, torch.Tensor]):
        """The norm of the whole gradient from this rank's leaves."""
        over = {}
        for name in named_grads:
            axes = ()
            if self.data is not None and self.fsdp_dims.get(name) is not None:
                axes += (DATA_AXIS,)
            if name in self.tp_sharded:
                axes += (MODEL_AXIS,)
            over[name] = axes
        comms = {DATA_AXIS: self.data, MODEL_AXIS: self.model}
        return global_grad_norm(named_grads, over, comms)


@dataclasses.dataclass
class TrainState:
    """The model, the optimizer with its moments, the LR schedule, the
    counters, the optional EMA, the LoRA adapters when only they train, and
    the gradient-accumulation buffer.

    ``step`` counts micro-steps (flax's ``TrainState.step``); ``updates``
    counts optimizer updates (the schedule's and the EMA's count, optax's
    inner count under ``MultiSteps``); ``mini_step`` is the position in the
    accumulation window of ``accum`` micro-steps."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    step: int = 0
    ema_params: Optional[dict] = None
    lora: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
    lora_scale: float = 1.0
    accum: int = 1
    updates: int = 0
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None
    layout: StateLayout = dataclasses.field(default_factory=StateLayout)

    @property
    def params(self) -> dict:
        """What trains: the model's parameters, or the adapters ({path:
        {"a", "b"}}) under LoRA, as the JAX ``TrainState.params``."""
        if self.lora is not None:
            return self.lora
        return dict(self.model.named_parameters())

    def trainable(self) -> Dict[str, torch.Tensor]:
        return _flat(self.params)

    def model_fn(self, params: Optional[dict] = None) -> Callable:
        """The model as a callable under ``params`` (default the state's
        own; e.g. ``ema_params``). Under LoRA the adapters are merged into
        the frozen base here, inside autograd when gradients are on."""
        gather = self.layout.gather if self.layout.distributed else None
        if self.lora is not None:
            base = dict(self.model.named_parameters())
            merged = merge_lora(gather(base) if gather else base,
                                params or self.lora, self.lora_scale,
                                shard=self.layout.shard_delta)
            return lambda *a: functional_call(self.model, merged, a)
        if params is None and gather is None:
            return self.model
        params = dict(self.model.named_parameters()) if params is None \
            else params
        if gather is not None:
            params = gather(params)
        return lambda *a: functional_call(self.model, params, a)

    def _relaid(self, tree: Optional[Mapping], fn) -> Optional[dict]:
        return None if tree is None else {n: fn(n, t) for n, t in
                                          _flat(tree).items()}

    def _optimizer_relaid(self, opt: Mapping, fn) -> dict:
        """The optimizer's state dict with each moment passed through
        ``fn(name, tensor)`` (its parameter's name; the step count as it
        is)."""
        names = list(self.trainable())
        return dict(opt, state={i: {k: (fn(names[i], v) if torch.is_tensor(v)
                                        and v.dim() else v)
                                    for k, v in st.items()}
                                for i, st in opt["state"].items()})

    @torch.no_grad()
    def state_dict(self) -> dict:
        """Everything a resume needs, as a tree of tensors and numbers: the
        state's own tensors, not copies (``torch.save`` copies them); the
        model's buffers (a VAE's BatchNorm running statistics, the JAX
        state's ``batch_stats``) too. On a process-group mesh every rank
        gathers the whole tensors from the slices (collectives)."""
        if self.layout.distributed:
            whole = lambda n, t: self.layout.whole(n, t.detach())
        else:
            whole = lambda n, t: t.detach()
        names = list(self.trainable())
        return dict(
            step=self.step, updates=self.updates, mini_step=self.mini_step,
            params=self._relaid(self.params, whole),
            optimizer=self._optimizer_relaid(self.optimizer.state_dict(),
                                             whole),
            ema=self._relaid(self.ema_params, whole),
            acc_grads=None if self.acc_grads is None else [
                whole(n, t) for n, t in zip(names, self.acc_grads)],
            buffers=self._relaid(dict(self.model.named_buffers()), whole))

    @torch.no_grad()
    def load_state_dict(self, saved: Mapping) -> None:
        """Fills this state, in place, from :meth:`state_dict`'s tree (the
        whole tensors), each re-sliced to this state's layout."""
        local = self.layout.local
        for key, own in (("params", self.params), ("ema", self.ema_params),
                         ("buffers", dict(self.model.named_buffers()))):
            own, got = _flat(own or {}), saved.get(key) or {}
            if set(own) != set(got):
                raise ValueError(f"checkpoint {key}: {sorted(set(own) ^ set(got))}"
                                 " differ from the state's")
            for name, t in own.items():
                t.copy_(local(name, got[name]))
        if (self.acc_grads is None) != (saved["acc_grads"] is None):
            raise ValueError("checkpoint and state differ in accumulation")
        for name, t, got in zip(self.trainable(), self.acc_grads or [],
                                saved["acc_grads"] or []):
            t.copy_(local(name, got))
        self.optimizer.load_state_dict(self._optimizer_relaid(
            saved["optimizer"], local))
        self.step = int(saved["step"])
        self.updates = int(saved["updates"])
        self.mini_step = int(saved["mini_step"])


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None):
    """Scales ``grads`` in place by max_norm / ‖grads‖ when the global norm
    is at least ``max_norm`` (``optax.clip_by_global_norm``: no epsilon,
    unlike ``clip_grad_norm_``); returns the norm. Foreach ops, so a few
    launches instead of two per parameter. ``norm``: the global norm when
    ``grads`` are a rank's slices of it (``StateLayout.grad_norm``)."""
    if norm is None:
        norm = torch.nn.utils.get_total_norm(grads, 2.0)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


def init_params(model: nn.Module, seed: int, params: Optional[Mapping] = None,
                *, lora_rank: Optional[int] = None,
                base_params: Optional[Mapping] = None) -> Optional[dict]:
    """Fills ``model`` in place with Flax's default initializers seeded with
    ``seed``, or with the JAX parameter tree ``params`` (nested dict of
    numpy arrays) when given. With ``lora_rank`` the base is
    ``base_params`` or the random init, and the adapters, returned, are
    ``params`` (then the JAX adapter dict, the JAX ``TrainState.params``)
    or drawn after the base; without, returns None."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    base = base_params if lora_rank else params
    if base is not None:
        load_jax_params(model, base)
    else:
        flax_default_init_(model, gen)
    if not lora_rank:
        return None
    if params is not None:
        return lora_from_jax(params, device)
    return init_lora(model, lora_rank, generator=gen)


def new_train_state(model: nn.Module, cfg, steps_per_epoch: int = 1, *,
                    schedule: Optional[Callable[[int], float]] = None,
                    weight_decay: float = 1e-4,
                    lora: Optional[dict] = None,
                    lora_scale: float = 1.0,
                    layout: Optional[StateLayout] = None) -> TrainState:
    """The state the trainers start from: AdamW with optax's defaults and
    ``weight_decay`` at ``schedule``, by default the warmup-cosine rate of
    ``cfg`` (lr, max_lr, warmup_epochs, epoch) over ``steps_per_epoch //
    cfg.grad_accum`` updates an epoch; no update made; a copy of what
    trains as the EMA when ``cfg`` has an ``ema_decay``; a zero fp32
    accumulator per trained tensor when ``cfg.grad_accum`` > 1. With
    ``lora`` only the adapters train and the model's parameters freeze.
    ``layout``: how the model (already laid out) lies on the trainer's
    mesh; the moments, EMA and accumulators take its parameters' shapes."""
    accum = max(1, getattr(cfg, "grad_accum", 1))
    if schedule is None:
        schedule = cosine_warmup_lr(cfg.lr, cfg.max_lr, cfg.warmup_epochs,
                                    cfg.epoch,
                                    max(1, steps_per_epoch // accum))
    if lora is not None:
        model.requires_grad_(False)
        tree = lora
    else:
        tree = dict(model.named_parameters())
    params = list(_flat(tree).values())
    optimizer = torch.optim.AdamW(params, lr=schedule(0),
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    ema = None
    if getattr(cfg, "ema_decay", None):
        ema = {k: ({n: t.detach().clone() for n, t in v.items()}
                   if isinstance(v, Mapping) else v.detach().clone())
               for k, v in tree.items()}
    acc = ([torch.zeros_like(p, dtype=torch.float32) for p in params]
           if accum > 1 else None)
    return TrainState(model, optimizer, schedule, 0, ema, lora, lora_scale,
                      accum, acc_grads=acc, layout=layout or StateLayout())


def lay_out(model: nn.Module, mesh, fsdp: bool,
            tp: bool = True) -> StateLayout:
    """Lay ``model`` (filled, whole) out on ``mesh`` in place (TP over its
    ``model`` axis when ``tp``, FSDP over ``data`` when ``fsdp``) and return
    its :class:`StateLayout`. A LoRA base, whose adapters were drawn from
    it whole, is laid out as a trained model is: gathered over ``data`` at
    the merge, each adapter's update sliced to its TP shard
    (:meth:`StateLayout.shard_delta`)."""
    layout = StateLayout.for_model(model, mesh, fsdp, tp)
    layout.lay_out(model, mesh)
    return layout


def data_axis(mesh):
    """The ``data`` axis's collectives of ``mesh`` (None without one)."""
    return (mesh.comm(DATA_AXIS) if mesh is not None
            and DATA_AXIS in mesh.shape else None)


def split_ranks(data) -> int:
    """How many ranks share a batch: the size of a process-group ``data``
    axis, else 1 (one process holds the whole batch)."""
    return data.n if data is not None and data.distributed else 1


def rank_mean(x: torch.Tensor, data) -> torch.Tensor:
    """A value each rank computed on its shard, as the mean over the ranks
    of ``data`` (form (b)); as it is elsewhere."""
    x = x.detach()
    if split_ranks(data) > 1:
        x = x.clone()
        torch.distributed.all_reduce(x, group=data.group)
        x /= data.n
    return x


@torch.no_grad()
def replicated_layout(model: nn.Module, mesh) -> StateLayout:
    """The data-parallel layout of the VAE, ViT, CLIP and VLM trainers (the
    JAX trainers' ``replicate``): the state whole on every rank, broadcast
    from the group's first rank in form (b), the batch sharded. The modules
    that reduce over the batch (``BatchNorm``, the ViT's dropout) get the
    ``data`` axis, so that a rank computes its part of the global batch's
    statistics and draws its slice of the global batch's masks."""
    if mesh is None:
        return StateLayout()
    if mesh.distributed:
        for t in itertools.chain(model.parameters(), model.buffers()):
            t.copy_(replicate(mesh, t))
    for m in model.modules():
        if hasattr(m, "data_axis"):
            m.data_axis = data_axis(mesh)
    return lay_out(model, mesh, fsdp=False, tp=False)


def apply_update(state: TrainState, loss: torch.Tensor,
                 grad_clip: Optional[float],
                 ema_decay: Optional[float]) -> bool:
    """One micro-step of ``state`` in place from a scalar ``loss``:
    backward, then, with ``state.accum`` > 1, the gradient folded into the
    window's running mean (optax's Welford form acc + (g − acc)/(n + 1), in
    fp32). On the window's last micro-step (every step without
    accumulation): the mean clipped to ``grad_clip`` by its global norm
    (not clipped when ``grad_clip`` is None), AdamW at the rate of the
    update count before this one, the EMA. The
    other micro-steps leave parameters, moments and EMA untouched.
    On a process-group mesh ``state.layout`` combines the ranks' gradients
    right after the backward and gives the clip the whole gradient's norm.
    Returns whether the parameters were updated."""
    named = state.trainable()
    params = list(named.values())
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    split = state.layout.distributed
    if split:
        state.layout.reduce_grads(named)
    state.step += 1
    grads = [p.grad for p in params]
    if state.accum > 1:
        n = state.mini_step
        with torch.no_grad():
            torch._foreach_sub_(grads, state.acc_grads)
            torch._foreach_div_(grads, float(n + 1))
            torch._foreach_add_(state.acc_grads, grads)
            if n + 1 < state.accum:
                state.mini_step = n + 1
                return False
            torch._foreach_copy_(grads, state.acc_grads)
            torch._foreach_zero_(state.acc_grads)
        state.mini_step = 0
    if grad_clip is not None:
        clip_by_global_norm_(grads, grad_clip, state.layout.grad_norm(
            dict(zip(named, grads))) if split else None)
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.updates)
    state.optimizer.step()
    state.updates += 1
    if state.ema_params is not None:
        ema = list(_flat(state.ema_params).values())
        with torch.no_grad():
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
    return True


def checkpoint_tree(state: TrainState,
                    generator: Optional[torch.Generator]) -> dict:
    """:meth:`TrainState.state_dict` with the generator's state."""
    tree = state.state_dict()
    tree["generator"] = None if generator is None else generator.get_state()
    return tree


def save_checkpoint(ckpt: CheckpointManager, step: int, state: TrainState,
                    generator: Optional[torch.Generator],
                    force: bool = False) -> None:
    """``ckpt.save`` of the whole state. On a process-group mesh every rank
    gathers (:func:`checkpoint_tree`), the group's first rank writes and
    the others wait for it at a barrier, so that a rank that reads the
    directory next finds the step."""
    tree = checkpoint_tree(state, generator)
    if state.layout.writer:
        ckpt.save(step, tree, force=force)
    if state.layout.group is not None:
        torch.distributed.barrier(group=state.layout.group)


def restore_tree(state: TrainState, generator: Optional[torch.Generator],
                 saved: Mapping) -> None:
    state.load_state_dict(saved)
    if generator is not None:
        generator.set_state(saved["generator"])


def train_epochs(trainer, loader: Iterable, state: TrainState, epochs: int,
                 checkpoint_dir: Optional[str], *, batch_size: Optional[int]
                 = None, resume: bool = True, epoch_awoken: Optional[int] =
                 None, prefetch: bool = True, log_rate: bool = True
                 ) -> TrainState:
    """The JAX trainers' ``fit`` loop. With ``checkpoint_dir``: a resume
    (when ``resume``) from ``epoch_awoken`` or the latest step, which
    restarts at the saved epoch's index; a save after each epoch whose mean
    loss is the lowest so far; under SIGTERM a forced save of the epoch at
    the next step boundary, then a return. Logs ``resume``, ``preempted``
    and ``epoch`` (``loss``, ``sec``, and ``imgs_per_sec`` with a
    ``batch_size`` and ``log_rate``) through ``trainer.logger``, keeping the
    unrounded records, ``imgs_per_sec`` with a ``batch_size``, in
    ``trainer.history``."""
    generator = getattr(trainer, "generator", None)
    ckpt, start = None, 0
    if checkpoint_dir:
        ckpt = CheckpointManager(checkpoint_dir)
        if resume and (epoch_awoken or ckpt.latest_step is not None):
            saved, at = ckpt.restore(epoch_awoken)
            if saved is not None:
                restore_tree(state, generator, saved)
                start = at
                trainer.logger.log("resume", epoch=at)
    best = float("inf")
    with PreemptionGuard() as guard:
        for epoch in range(start, epochs):
            t0 = time.perf_counter()
            total, count = torch.zeros((), device=trainer.device), 0
            batches = (prefetch_to_device(loader, trainer.device) if prefetch
                       else loader)
            for batch in batches:
                state, loss = trainer.train_step(state, *batch)
                total += loss
                count += 1
                if guard.should_stop:
                    break
            if guard.should_stop:
                if ckpt:
                    save_checkpoint(ckpt, epoch, state, generator,
                                    force=True)
                trainer.logger.log("preempted", epoch=epoch)
                break
            epoch_loss = float(total) / max(count, 1)
            dt = time.perf_counter() - t0
            rec = dict(epoch=epoch, loss=epoch_loss, sec=dt)
            if batch_size:
                rec["imgs_per_sec"] = count * batch_size / dt
            trainer.history.append(rec)
            trainer.logger.log(
                "epoch", epoch=epoch, loss=epoch_loss, sec=round(dt, 2),
                **({"imgs_per_sec": round(rec["imgs_per_sec"], 1)}
                   if batch_size and log_rate else {}))
            if ckpt and epoch_loss < best:
                best = epoch_loss
                save_checkpoint(ckpt, epoch, state, generator)
    return state


class DDPMTrainer:
    """Pixel-space (``02_train_direct.py``) or latent-space
    (``03_train_with_vae.py``) DDPM training of the class-conditional
    :class:`TinyUNet`, or of ``model``.

    Latent space: ``latent_encode_fn(images, generator) -> latents`` (a
    frozen encoder, run without gradients, its noise drawn from the
    trainer's generator) and ``latent_decode_fn(latents) -> images``; set
    ``config.img_channel`` to the latent channels and ``config.img_size``
    to the latent size. ``model``: any ε-predictor module called as
    ``model(x, t, labels)``, holding storage (``create_state`` redraws or
    loads its values), with ``sample_shape`` the shape of one sample.
    ``lora_rank``: train rank-r adapters only, over ``base_params`` (a JAX
    parameter tree) or a fresh init. ``mesh``: a :class:`..parallel.Mesh`
    with a ``data`` axis (form (a) over devices of ``device``'s kind, or
    form (b), whose rank's device the trainer takes); without one
    ``config.mesh_shape`` builds one over the visible devices of that kind.
    ``fsdp``: the state stored sharded over ``data`` (module docstring)."""

    def __init__(self, config: TinySDConfig, device="cuda", mesh=None,
                 logger: Optional[MetricsLogger] = None,
                 latent_encode_fn=None, latent_decode_fn=None,
                 model: Optional[nn.Module] = None, sample_shape=None,
                 fsdp: bool = False, lora_rank: Optional[int] = None,
                 base_params=None, lora_scale: float = 1.0):
        self.cfg = config
        self.device = torch.device(device)
        if mesh is None and config.mesh_shape:
            mesh = build_mesh(config.mesh_shape,
                              visible_devices(self.device.type))
        if mesh is not None:
            self.device = torch.device(mesh_device(mesh))
        self.mesh, self.fsdp = mesh, fsdp
        self.data = data_axis(mesh)
        self.dtype = POLICIES[config.dtype].compute_dtype
        self.logger = logger or MetricsLogger()
        self.latent_encode_fn = latent_encode_fn
        self.latent_decode_fn = latent_decode_fn
        self.model = model
        self.lora_rank = lora_rank
        self.lora_scale = lora_scale
        self.base_params = base_params
        self.sample_shape = tuple(sample_shape) if sample_shape else (
            config.img_size, config.img_size, config.img_channel)
        self.tables = ddpm_tables(config.beta_1, config.beta_T, config.T)
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self.history: List[dict] = []

    def make_model(self) -> nn.Module:
        """The configured model (a copy of ``model`` when one was given)
        with uninitialised storage on the device."""
        if self.model is not None:
            return copy.deepcopy(self.model).to(self.device)
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
        """The model filled by :func:`init_params` from ``config.seed`` or
        ``params`` (and ``base_params`` under LoRA)."""
        model = self.make_model()
        lora = init_params(model, self.cfg.seed, params,
                           lora_rank=self.lora_rank,
                           base_params=self.base_params)
        model = model.to(memory_format=torch.channels_last).train()
        # a model axis replicates the model, as in the JAX trainer
        layout = lay_out(model, self.mesh, self.fsdp, tp=False)
        return new_train_state(model, self.cfg, steps_per_epoch, lora=lora,
                               lora_scale=self.lora_scale, layout=layout)

    def num_params(self, state: TrainState) -> int:
        """The parameters that train (the adapters under LoRA)."""
        return sum(p.numel() for p in state.trainable().values())

    # ---------------- train ----------------
    def train_step(self, state: TrainState, images, labels, *, drop=None,
                   t=None, noise=None):
        """One micro-step on a batch of images (B, H, W, C) in [−1, 1] and
        0-based labels (B,); returns (state, loss). ``drop`` (the CFG drop
        mask), ``t`` and ``noise`` are drawn from the trainer's generator
        (seeded with ``config.seed + 1``) unless given; the latent encoder,
        when there is one, runs first and draws its noise there too."""
        cfg, dev, gen = self.cfg, self.device, self.generator
        x0 = torch.as_tensor(images, dtype=torch.float32, device=dev)
        if self.latent_encode_fn is not None:
            with torch.no_grad():
                x0 = self.latent_encode_fn(x0, gen).float()
        labels = torch.as_tensor(labels, device=dev).long() + 1
        if drop is None:
            drop = torch.rand(labels.shape, generator=gen,
                              device=dev) < cfg.train_rand
        labels = torch.where(torch.as_tensor(drop, device=dev),
                             torch.zeros_like(labels), labels)
        ranks = split_ranks(self.data)
        if ranks > 1:
            # the whole batch's draws, in ddpm_loss's order; each rank
            # keeps its slice of them, as of the batch
            if t is None:
                t = torch.randint(0, cfg.T, (x0.shape[0],), generator=gen,
                                  device=dev)
            if noise is None:
                noise = torch.randn(x0.shape, generator=gen, device=dev)
        if self.mesh is not None:
            x0, labels, t, noise = shard_batch(self.mesh,
                                               (x0, labels, t, noise))
        state.model.train()
        # sum / batch_size² over the whole batch: each rank's share, times
        # the ranks, so that their mean (the averaged gradient) is it
        loss = ddpm_loss(state.model_fn(), self.tables, x0, labels, cfg.T,
                         gen, t=t, noise=noise).sum() * ranks / (
                             cfg.batch_size ** 2)
        apply_update(state, loss, cfg.grad_clip, cfg.ema_decay)
        return state, rank_mean(loss, self.data)

    def fit(self, loader: Iterable, state: Optional[TrainState] = None,
            epochs: Optional[int] = None, sample_every: int = 1,
            checkpoint_dir: Optional[str] = None) -> TrainState:
        """Trains for ``epochs`` (``config.epoch``) passes over ``loader``
        (:func:`train_epochs`; ``sample_every`` is unused, as in the JAX
        trainer)."""
        if state is None:
            state = self.create_state(len(loader))
        return train_epochs(self, loader, state, epochs or self.cfg.epoch,
                            checkpoint_dir, batch_size=self.cfg.batch_size,
                            epoch_awoken=self.cfg.epoch_awoken)

    # ---------------- sample ----------------
    @torch.no_grad()
    def sample(self, state: TrainState, labels, use_ema: bool = False, *,
               noise=None, step_noise=None) -> torch.Tensor:
        """CFG ancestral sampling over ``config.T`` steps, noise seeded with
        ``config.seed + 2``; ``labels`` are 1-based class ids
        (0 = unconditional). Returns (N,) + ``sample_shape`` in [−1, 1], or
        the decoded images, clipped to [−1, 1], in latent space. ``noise``
        (x_T) and ``step_noise`` (one array per loop step) replace the
        draws, as the tests feed the JAX sampler's."""
        cfg, dev = self.cfg, self.device
        generator = torch.Generator(device=dev).manual_seed(cfg.seed + 2)
        labels = torch.as_tensor(np.asarray(labels), device=dev).long()
        state.model.eval()
        model_fn = state.model_fn(state.ema_params if use_ema else None)
        if noise is None:
            x_T = torch.randn((labels.shape[0],) + self.sample_shape,
                              generator=generator, device=dev)
        else:
            x_T = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        noise_fn = None if step_noise is None else (
            lambda step: torch.as_tensor(step_noise[step],
                                         dtype=torch.float32, device=dev))
        out = ddpm_sample(model_fn, self.tables, x_T, labels, cfg.T,
                          w=cfg.w, generator=generator, noise_fn=noise_fn)
        if self.latent_decode_fn is not None:
            out = self.latent_decode_fn(out).clamp(-1.0, 1.0)
        return out
