"""The JAX package's Flax parameter trees <-> this package's ``state_dict``s.

The port names its submodules after the Flax parameter paths, so the
conversion only renames and transposes leaves (the reverse of
``io/weights.py``'s ``t_conv`` / ``t_dense``):

- 4-D ``kernel`` (kH, kW, I, O) -> conv ``weight`` (O, I, kH, kW)
- 2-D ``kernel`` (I, O) -> linear ``weight`` (O, I)
- ``scale`` -> norm ``weight``; ``embedding`` -> embedding ``weight``
- every other leaf (``bias``, ``position_value``, ``cls_token``,
  ``pos_embed``, a VQ ``codebook``) keeps its name; so do a
  ``QuantDense``'s ``q`` (K, N) int8, turned to (N, K) as a linear weight,
  and its ``scale`` (``ops/quantize.py::QuantLinear``'s buffers).
- a Switch-MoE's ``router/kernel`` (C, E) is a linear's ``router.weight``
  (E, C); its bare expert weights ``wi``, ``wg`` (E, C, H) and ``wo``
  (E, H, C) keep their names and layout (``parallel/expert.py``);
- a Flax ``ConvTranspose`` kernel (kH, kW, I, O) turns as a conv kernel
  does: ``models/vae.py::ConvTranspose2d`` stores it so and flips it at the
  call;
- the ``batch_stats`` collection of a Flax ``BatchNorm`` (``mean``,
  ``var``) fills the port's ``BatchNorm`` buffers of the same names.

:func:`jax_params_from_module` goes the other way (a trained port model, or
its EMA, as the tree the JAX trainer keeps in ``TrainState.params`` /
``ema_params``); it needs the module, since a port ``weight`` is a Flax
``kernel``, ``scale`` or ``embedding`` depending on the layer that owns it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_RENAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _leaves(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _to_numpy(leaf) -> np.ndarray:
    a = np.asarray(leaf)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = np.asarray(leaf, np.float32)
    return a


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax parameter tree (nested dict of arrays) as a ``state_dict``."""
    out = {}
    leaves = list(_leaves(tree))
    quantized = {path[:-1] for path, _ in leaves if path[-1] == "q"}
    for path, leaf in leaves:
        a = _to_numpy(leaf)
        name = path[-1]
        if path[:-1] in quantized and name in ("q", "scale"):
            out[".".join(path)] = torch.from_numpy(np.array(
                a.T if name == "q" else a, order="C"))
            continue
        if name == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"{'/'.join(path)}: {a.ndim}-D kernel")
        out[".".join(path[:-1] + (_RENAMES.get(name, name),))] = \
            torch.from_numpy(np.array(a, order="C"))
    return out


def load_state_checked(module: nn.Module, sd: Mapping[str, torch.Tensor],
                       source: str = "checkpoint tensor") -> nn.Module:
    """Fill every parameter of ``module`` from ``sd`` (name -> tensor, on
    any device, in any float dtype: each is copied and converted into the
    parameter), consuming every entry of it; raises on a missing or unused
    entry or a shape mismatch. ``source`` names an entry in the messages."""
    own = module.state_dict()
    missing, unused = sorted(own.keys() - sd.keys()), sorted(sd.keys() - own)
    if missing or unused:
        raise ValueError(f"{type(module).__name__}: port parameters without "
                         f"a {source} {missing}; entries ({source}) without "
                         f"a port parameter {unused}")
    for key, value in sd.items():
        if value.shape != own[key].shape:
            raise ValueError(f"{key}: {source} {tuple(value.shape)} vs port "
                             f"{tuple(own[key].shape)}")
    module.load_state_dict(sd)
    return module


def load_jax_params(module: nn.Module, tree: Mapping,
                    batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Fill every parameter of ``module`` from ``tree`` (and its BatchNorm
    running statistics from ``batch_stats``, the Flax collection),
    consuming every leaf; raises on a missing or unused leaf or a shape
    mismatch."""
    sd = state_dict_from_jax(tree)
    if batch_stats is not None:
        sd.update(state_dict_from_jax(batch_stats))
    return load_state_checked(module, sd, "JAX leaf")


def jax_params_from_module(
        module: nn.Module,
        params: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """The Flax parameter tree (nested dict of numpy arrays, in each
    parameter's own dtype widened to fp32 for bf16) of ``module``: the
    inverse of :func:`state_dict_from_jax`. ``params`` (name -> tensor, e.g.
    a trainer's ``ema_params``) replaces the module's own values."""
    own = dict(module.named_parameters())
    if params is not None and set(params) != set(own):
        raise ValueError("params must name exactly the module's parameters")
    tree: dict = {}
    for name, p in (own if params is None else params).items():
        *path, leaf = name.split(".")
        parent = module.get_submodule(".".join(path))
        a = p.detach()
        a = (a.float() if a.dtype == torch.bfloat16 else a).cpu().numpy()
        if leaf == "weight":
            if isinstance(parent, nn.Conv2d):
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
            elif isinstance(parent, nn.Linear):
                leaf, a = "kernel", a.T
            elif isinstance(parent, nn.Embedding):
                leaf = "embedding"
            else:
                leaf = "scale"
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.array(a, order="C")
    return tree
