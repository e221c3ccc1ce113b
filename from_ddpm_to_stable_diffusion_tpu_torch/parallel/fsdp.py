"""ZeRO-style fully-sharded data parallelism (port of ``parallel/fsdp.py``).

In the JAX package FSDP is a sharding annotation: every leaf of the train
state of at least :data:`MIN_SHARD_SIZE` elements is stored sharded over the
``data`` axis on the dim :func:`fsdp_spec` picks from its shape, XLA gathers
it at the top of the loss and reduce-scatters its gradient. The spec
functions are copied here verbatim (specs as plain tuples), and the trainers
state the rest:

- :func:`fsdp_dims` gives, per parameter of a port model, the torch dim
  that the JAX spec of its Flax leaf shards over ``data`` (a Flax kernel is
  (in, out), a torch weight (out, in); a conv kernel (kH, kW, I, O) is (O,
  I, kH, kW));
- in mesh form (b) :func:`shard_params` keeps the rank's slice of each such
  parameter, so the AdamW moments, the EMA and the accumulators made from
  the parameters are slices too; :func:`gather` rebuilds the whole tensors
  at the top of the loss (all-gather forward, reduce-scatter backward:
  ``AxisComm.gather_batch``), :func:`mean_grads` divides the summed slices
  and averages the replicated leaves over the ranks, and
  :func:`global_grad_norm` all-reduces the sum of squares so that clipping
  sees the whole gradient, each replicated leaf counted once;
- in mesh form (a) a sharded tensor is the whole tensor and its shards are
  views of it (:func:`apply_fsdp`), so the state is the meshless one and the
  steps equal the meshless steps up to nothing.

Under FSDP x TP the TP spec comes first (:func:`fsdp_tp_shardings`) and the
data axis goes on the largest dim it leaves free; :func:`drop_data_axis`
gives the just-in-time layout, gathered over data and still sharded over
model.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .mesh import DATA_AXIS, MODEL_AXIS
from .sharding import _axis_size, map_with_path, spec_fits, tp_layout, \
    tp_spec_for_path

# Below this many elements a leaf stays replicated: the all-gather of a
# tiny bias/scale costs more than its copy.
MIN_SHARD_SIZE = 2 ** 15


def fsdp_spec(shape, size: int, min_size: int = MIN_SHARD_SIZE,
              taken: Optional[tuple] = None) -> tuple:
    """The spec sharding the largest free dim of ``shape`` over data.
    ``taken``: an existing spec (e.g. TP) whose axes are kept; the data axis
    goes on the largest dim it leaves free. Fully replicated: ()."""
    dims = tuple(shape)
    base = list(taken) if taken is not None else []
    base += [None] * (len(dims) - len(base))
    if int(np.prod(dims, dtype=np.int64)) < min_size:
        return tuple(base) if any(a is not None for a in base) else ()
    # largest dim, ties to the first (leading)
    order = sorted(range(len(dims)), key=lambda i: -dims[i])
    for i in order:
        if base[i] is None and dims[i] % size == 0:
            base[i] = DATA_AXIS
            return tuple(base)
    return tuple(base) if any(a is not None for a in base) else ()


def fsdp_shardings(tree, mesh, min_size: int = MIN_SHARD_SIZE):
    """The FSDP spec of every leaf of ``tree`` (shape only: parameters,
    moments and EMA alike)."""
    size = _axis_size(mesh, DATA_AXIS)
    return map_with_path(
        lambda _, x: fsdp_spec(tuple(x.shape), size, min_size), tree)


def fsdp_tp_shardings(params, mesh, min_size: int = MIN_SHARD_SIZE):
    """Hybrid 2-D specs: TP by the param-path rule, FSDP on the free dim;
    a TP spec that does not divide is dropped first."""
    data = _axis_size(mesh, DATA_AXIS)
    model = _axis_size(mesh, MODEL_AXIS)

    def leaf(path, x):
        dims = tuple(x.shape)
        tp = tp_spec_for_path(path)
        return fsdp_spec(dims, data, min_size,
                         taken=tp if spec_fits(tp, dims, model) else None)

    return map_with_path(leaf, params)


def drop_data_axis(specs):
    """The specs with ``data`` removed and every other axis kept: the
    just-in-time layout of hybrid FSDP x TP."""
    def leaf(_, spec):
        spec = tuple(None if a == DATA_AXIS else a for a in spec)
        return spec if any(a is not None for a in spec) else ()

    return map_with_path(leaf, specs) if isinstance(specs, Mapping) \
        else leaf(None, specs)


# --------------------------------------------------------------------------
# the port's parameters
# --------------------------------------------------------------------------
_CONV_TO_TORCH = (2, 3, 1, 0)     # Flax (kH, kW, I, O) dim -> torch dim


def _flax_shape(owner: nn.Module, leaf: str, t: torch.Tensor):
    """The Flax shape of a port tensor and, per Flax dim, its torch dim."""
    if leaf == "q" or (leaf == "weight" and isinstance(owner, nn.Linear)):
        return (t.shape[1], t.shape[0]), (1, 0)
    if leaf == "weight" and t.dim() == 4 and isinstance(owner, nn.Conv2d):
        return tuple(t.shape[i] for i in (2, 3, 1, 0)), _CONV_TO_TORCH
    return tuple(t.shape), tuple(range(t.dim()))


def fsdp_dims(model: nn.Module, data: int, model_axis: int = 1,
              min_size: int = MIN_SHARD_SIZE) -> Dict[str, Optional[int]]:
    """Per parameter of ``model`` (whole, before any slicing), the torch dim
    stored sharded over a ``data`` axis of ``data`` (None: replicated): the
    JAX FSDP spec of its Flax leaf, after the TP spec of :func:`tp_layout`
    over a ``model`` axis of ``model_axis``."""
    layout = tp_layout(model, model_axis) if model_axis > 1 else {}
    out = {}
    for name, p in model.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        shape, to_torch = _flax_shape(model.get_submodule(owner_name), leaf,
                                      p)
        spec = fsdp_spec(shape, data, min_size,
                         taken=layout.get(name) or None)
        out[name] = (to_torch[spec.index(DATA_AXIS)] if DATA_AXIS in spec
                     else None)
    return out


def apply_fsdp(tensor: torch.Tensor, dim: Optional[int], comm) -> list:
    """The shards this process stores of a leaf sharded on ``dim`` over the
    data axis ``comm``: in form (a) views of the whole tensor (never
    copies), in form (b) the rank's slice."""
    if dim is None:
        return [tensor]
    if comm.distributed:
        return [tensor.chunk(comm.n, dim)[comm.index[0]]]
    return list(tensor.chunk(comm.n, dim))


@torch.no_grad()
def shard_params(model: nn.Module, dims: Mapping[str, Optional[int]],
                 comm) -> None:
    """Form (b): every parameter with a dim in ``dims`` replaced, in place,
    by the rank's slice (contiguous); form (a) keeps the whole tensors."""
    if not comm.distributed:
        return
    for name, dim in dims.items():
        if dim is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        p = getattr(owner, leaf)
        local = apply_fsdp(p.detach(), dim, comm)[0].contiguous()
        setattr(owner, leaf, nn.Parameter(local,
                                          requires_grad=p.requires_grad))


def gather(params: Mapping[str, torch.Tensor],
           dims: Mapping[str, Optional[int]], comm) -> Dict[str, torch.Tensor]:
    """The whole tensors from the stored shards, at the top of the loss:
    form (b) all-gathers each sharded leaf (its gradient is summed over the
    ranks and sliced: a reduce-scatter); form (a) is whole already."""
    if not comm.distributed:
        return dict(params)
    return {name: (p if dims.get(name) is None
                   else comm.gather_batch(p, dims[name]))
            for name, p in params.items()}


@torch.no_grad()
def mean_grads(params: Mapping[str, torch.Tensor],
               dims: Mapping[str, Optional[int]], comm) -> None:
    """Form (b), after the backward of the ranks' own losses: the gradient
    of the mean loss. Sharded leaves hold the reduce-scattered sum and are
    divided by n; replicated ones are all-reduced, then divided."""
    for name, p in params.items():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        if dims.get(name) is None:
            dist.all_reduce(p.grad, group=comm.group)
        p.grad.div_(comm.n)


def global_grad_norm(grads: Mapping[str, torch.Tensor],
                     sharded_over: Mapping[str, tuple], comms: Mapping
                     ) -> torch.Tensor:
    """The norm of the whole gradient from a form-(b) rank's leaves:
    ``sharded_over[name]`` the mesh axes a leaf's slices span (() for a
    replicated one, counted once); the sums of squares of each group of
    leaves all-reduced over their axes."""
    groups: Dict[tuple, list] = {}
    for name, g in grads.items():
        groups.setdefault(tuple(sharded_over.get(name, ())), []).append(g)
    total = None
    for axes, gs in groups.items():
        sq = torch.nn.utils.get_total_norm(gs, 2.0).float() ** 2
        for axis in axes:
            dist.all_reduce(sq, group=comms[axis].group)
        total = sq if total is None else total + sq
    return total.sqrt()


def constrain(params: Mapping[str, torch.Tensor],
              dims: Mapping[str, Optional[int]], comm) -> list:
    """The stored shards of every leaf after an update (the JAX
    ``constrain``): views in form (a), the rank's own slices in form (b),
    where the update already ran on them."""
    if comm.distributed:
        return list(params.values())
    return [s for name, p in params.items()
            for s in apply_fsdp(p, dims.get(name), comm)]
