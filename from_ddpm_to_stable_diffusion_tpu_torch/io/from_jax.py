"""The JAX package's Flax parameter trees -> this package's ``state_dict``s.

The port names its submodules after the Flax parameter paths, so the
conversion only renames and transposes leaves (the reverse of
``io/weights.py``'s ``t_conv`` / ``t_dense``):

- 4-D ``kernel`` (kH, kW, I, O) -> conv ``weight`` (O, I, kH, kW)
- 2-D ``kernel`` (I, O) -> linear ``weight`` (O, I)
- ``scale`` -> norm ``weight``; ``embedding`` -> embedding ``weight``
- every other leaf (``bias``, ``position_value``) keeps its name.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
    for path, leaf in _leaves(tree):
        a = _to_numpy(leaf)
        name = path[-1]
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


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Fill every parameter of ``module`` from ``tree``, consuming every
    leaf of it; raises on a missing or unused leaf or a shape mismatch."""
    sd = state_dict_from_jax(tree)
    own = module.state_dict()
    missing, unused = sorted(own.keys() - sd.keys()), sorted(sd.keys() - own)
    if missing or unused:
        raise ValueError(f"{type(module).__name__}: port parameters without "
                         f"a JAX leaf {missing}; JAX leaves without a port "
                         f"parameter {unused}")
    for key, value in sd.items():
        if value.shape != own[key].shape:
            raise ValueError(f"{key}: JAX {tuple(value.shape)} vs port "
                             f"{tuple(own[key].shape)}")
    module.load_state_dict(sd)
    return module
