"""Tensor parallelism over a ``model`` mesh axis (port of
``parallel/sharding.py``).

The JAX package states TP as sharding annotations: path-regex
``PartitionSpec`` rules on the Flax parameter tree, and XLA inserts every
collective. The rules are copied here verbatim (:func:`tp_spec_for_path`,
:func:`tp_shardings`, specs as plain tuples), so the tests hold them against
the JAX rules leaf by leaf. Column-parallel (the output dim sharded): the
attention q / k / v and fused qkv, the MLP up / gate projections, adaLN.
Row-parallel (the input dim sharded): the attention out / proj and the MLP
down projections. Everything else is replicated. A Flax ``kernel`` is (in,
out) and a torch ``weight`` (out, in): the column spec ``(None, "model")``
shards dim 0 of the weight.

There is no compiler here to place the collectives, so the compute is
Megatron's block, stated by the modules that :func:`apply_tp` switches (each
with a ``tp`` attribute, the axis's :class:`..parallel.mesh.AxisComm`, and a
``TP_LAYERS`` table naming its linears):

- the input is replicated; a column layer gives each shard its slice
  (:func:`column`), the shard computes its heads, and a row layer sums the
  shards' partial products over the axis and adds its bias once, after the
  sum (:func:`row`);
- a column output that no row layer follows (adaLN) is gathered whole
  (:func:`gathered`); a row layer on a replicated input takes the shard's
  slice of it (:func:`row_replicated`, SD1's ``time_proj``);
- fused projections split by heads, never across one: shard *j* of a qkv
  weight holds heads [jH/n, (j+1)H/n) of q, of k and of v, and of GEGLU's
  z | gate the matching halves (the ``groups`` of a layer);
- a module whose heads (or widths) do not divide by the axis runs whole on
  every shard (the SD1 VAE's one-head attention; :func:`tp_layout` says
  which leaves differ from the JAX specs).

Storage. In mesh form (a) the model keeps its whole tensors and a shard is a
view of them (chunks of one tensor, never copies), so the meshless forward,
the optimizer and the checkpoints see the whole parameters. In form (b)
:func:`apply_tp` replaces each sharded tensor by the rank's slice. W8A8
(:class:`..ops.quantize.QuantLinear`): a column layer's ``q`` and ``scale``
split with its output; a row layer's per-token abs-max is reduced with max
over the axis before quantizing and its int32 partial accumulators are summed
before dequantizing, so the row product equals the unsharded one bit for bit.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quantize import RECIP_127, QuantLinear, int8_dot, int8_matmul
from .mesh import MODEL_AXIS

# (path regex, spec) — first match wins. Paths are '/'-joined Flax param
# paths ending in the leaf name (kernel/bias/scale/embedding/...).
_COL_FAMS = r"(qkv|/q|/k|/v|fc1|geglu_in|mlp_fc1|wi_0|wi_1|adaLN|time_fc1)"
_ROW_FAMS = r"(out|proj|fc2|geglu_out|mlp_fc2|/o|wo|time_fc2)"
_COLUMN = re.compile(_COL_FAMS + r"[^/]*/kernel$")
_ROW = re.compile(_ROW_FAMS + r"[^/]*/kernel$")
_COLUMN_BIAS = re.compile(
    r"(qkv|/q|/k|/v|fc1|geglu_in|mlp_fc1|adaLN|time_fc1)[^/]*/bias$")
# W8A8 layout: kernel -> {q int8 (K, N), scale fp32 (N,)}; a column layer's
# per-output scale shards with the output dim, a row layer's stays whole.
_COLUMN_Q = re.compile(_COL_FAMS + r"[^/]*/q$")
_ROW_Q = re.compile(_ROW_FAMS + r"[^/]*/q$")
_COLUMN_SCALE = re.compile(_COL_FAMS + r"[^/]*/scale$")

COLUMN_SPEC = (None, MODEL_AXIS)
ROW_SPEC = (MODEL_AXIS, None)


def tp_spec_for_path(path: str) -> tuple:
    """The spec of one Flax param path under model-axis TP."""
    if _ROW.search(path) or _ROW_Q.search(path):
        return ROW_SPEC
    if _COLUMN.search(path) or _COLUMN_Q.search(path):
        return COLUMN_SPEC
    if _COLUMN_BIAS.search(path) or _COLUMN_SCALE.search(path):
        return (MODEL_AXIS,)
    return ()


def _axis_size(mesh, axis: str) -> int:
    shape = mesh.shape if hasattr(mesh, "axis_names") else mesh
    return int(shape.get(axis, 1))


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested mapping (a Flax tree of arrays, or a
    flat one with '/'-joined keys), paths '/'-joined; the same nesting
    back."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out[key] = (map_with_path(fn, value, path)
                    if isinstance(value, Mapping) else fn(path, value))
    return out


def spec_fits(spec: tuple, shape, size: int) -> bool:
    """Whether every axis of ``spec`` divides its dim of ``shape``."""
    return len(spec) <= len(shape) and all(
        s is None or shape[i] % size == 0 for i, s in enumerate(spec))


def tp_shardings(params, mesh):
    """The TP spec of every leaf of ``params`` (nested or '/'-keyed), as
    ``jax_tp_shardings`` gives it: a spec that does not divide its leaf
    falls back to replication (correct, just not sharded). ``mesh``: a
    :class:`..parallel.mesh.Mesh` or its shape."""
    size = _axis_size(mesh, MODEL_AXIS)

    def leaf(path, x):
        spec = tp_spec_for_path(path)
        return spec if spec_fits(spec, tuple(x.shape), size) else ()

    return map_with_path(leaf, params)


# --------------------------------------------------------------------------
# Megatron's block
# --------------------------------------------------------------------------
def _held(t, dim: int, comm, groups: int = 1):
    """The shards of ``t`` this process holds, sharded on ``dim`` with
    ``groups`` blocks along it (q|k|v: 3): for each held shard a list, per
    group, of that group's slice. Form (a): views of the whole tensor; form
    (b): ``t`` is already the rank's slice."""
    n = 1 if comm.distributed else comm.n
    if t is None:
        return [[None] * groups for _ in range(n)]
    parts = t.unflatten(dim, (groups, -1))
    return [[parts.select(dim, g).chunk(n, dim)[j] for g in range(groups)]
            for j in range(n)]


def _dense(lin, x, w, b):
    dt = getattr(lin, "compute_dtype", None)
    if isinstance(lin, QuantLinear):
        y = int8_dot(x.to(lin.compute_dtype), w.t(), b[1])
        return y if b[0] is None else y + b[0].to(y.dtype)
    if dt is not None:
        x, w = x.to(dt), w.to(dt)
        b = None if b is None else b.to(dt)
    return F.linear(x, w, b)


def _column_parts(lin, comm, groups: int):
    """Per held shard, per group: (weight, bias) of a column layer; a
    QuantLinear's as (q, (bias, scale))."""
    if isinstance(lin, QuantLinear):
        ws = _held(lin.q, 0, comm, groups)
        bs = _held(lin.bias, 0, comm, groups)
        ss = _held(lin.scale, 0, comm, groups)
        return [[(w, (b, s)) for w, b, s in zip(*parts)]
                for parts in zip(ws, bs, ss)]
    return [list(zip(w, b)) for w, b in zip(_held(lin.weight, 0, comm,
                                                  groups),
                                            _held(lin.bias, 0, comm, groups))]


def column(lin, x, comm, groups: int = 1) -> list:
    """A column-parallel layer on a replicated input: for each held shard
    its slice of the output (a list of ``groups`` slices when the layer is
    fused, e.g. q, k, v)."""
    x = comm.copy_to(x)
    outs = []
    for parts in _column_parts(lin, comm, groups):
        ys = [_dense(lin, x, w, b) for w, b in parts]
        outs.append(ys if groups > 1 else ys[0])
    return outs


def gathered(lin, x, comm):
    """A column-parallel layer whose consumer is replicated: the shards'
    outputs gathered whole (adaLN)."""
    outs = column(lin, x, comm)
    last = outs[0].dim() - 1
    return comm.gather(outs[0], last) if comm.distributed else torch.cat(
        outs, last)


def row_int8_accumulators(lin: QuantLinear, xs: list, comm):
    """A row-parallel W8A8 layer's int32 accumulators, summed over the axis,
    and the per-token activation scales: each token's abs-max reduced with
    max over the shards' input slices before quantizing, so that every
    shard rounds on the whole row's grid and the sum equals the unsharded
    accumulator exactly."""
    xs = [x.to(lin.compute_dtype) for x in xs]
    amax = comm.pmax([x.float().abs().amax(-1, keepdim=True) for x in xs])
    scale = amax[0].clamp(min=1e-8) * RECIP_127
    accs = []
    for x, (q,) in zip(xs, _held(lin.q, 1, comm)):
        xq = torch.round(x.float() / scale.to(x.device)).to(torch.int8)
        acc = int8_matmul(xq.reshape(-1, x.shape[-1]), q.t())
        accs.append(acc.reshape(*x.shape[:-1], q.shape[0]))
    return comm.psum(accs)[0], scale


def _row_int8(lin, xs, comm):
    acc, scale = row_int8_accumulators(lin, xs, comm)
    y = (acc.float() * scale * lin.scale).to(lin.compute_dtype)
    return y if lin.bias is None else y + lin.bias.to(y.dtype)


def row(lin, xs: list, comm):
    """A row-parallel layer on the held shards' input slices: the partial
    products summed over the axis (int32 accumulators for W8A8), the bias
    added once after the sum; replicated."""
    if isinstance(lin, QuantLinear):
        return _row_int8(lin, xs, comm)
    parts = [_dense(lin, x, w, None)
             for x, (w,) in zip(xs, _held(lin.weight, 1, comm))]
    y = comm.psum(parts)[0]
    if lin.bias is None:
        return y
    return y + lin.bias.to(getattr(lin, "compute_dtype", None) or y.dtype)


def row_replicated(lin, x, comm):
    """A row-parallel layer on a replicated input: each shard takes its
    slice of it."""
    return row(lin, comm.local_shards(x, x.dim() - 1), comm)


def head_slices(x, dim: int, comm) -> list:
    """The held shards' slices of a replicated per-head tensor (T5's
    relative-position bias on its head dim)."""
    return [x.chunk(comm.n, dim)[j] for j in comm.index]


# --------------------------------------------------------------------------
# switching a model
# --------------------------------------------------------------------------
def _layers(module: nn.Module):
    """(name, linear, kind, groups) of each layer ``module.TP_LAYERS`` names
    and the module has; kind is "column", "row" or "gathered"."""
    for name, (kind, groups) in module.TP_LAYERS.items():
        lin = getattr(module, name, None)
        if lin is not None:
            yield name, lin, kind, groups


def _divides(module: nn.Module, n: int) -> bool:
    heads = getattr(module, "num_heads", None)
    if heads is not None and heads % n:
        return False
    for _, lin, kind, groups in _layers(module):
        width = lin.in_features if kind == "row" else lin.out_features
        if width % (n * (1 if kind == "row" else groups)):
            return False
    return True


def tp_modules(model: nn.Module, n: int) -> Dict[str, nn.Module]:
    """The modules of ``model`` that run sharded over an axis of ``n``:
    every one with a ``TP_LAYERS`` table whose heads and widths divide."""
    return {name: m for name, m in model.named_modules()
            if hasattr(m, "TP_LAYERS") and _divides(m, n)}


def tp_roles(model: nn.Module, n: int) -> Dict[str, tuple]:
    """(kind, groups, dim) of every ``state_dict`` entry that :func:`apply_tp`
    shards over an axis of ``n``: the layer's kind ("column", "row",
    "gathered"), its fused groups and the torch dim split (a row layer's
    bias and scale stay whole and are not listed)."""
    out = {}
    own = model.state_dict()
    for mname, m in tp_modules(model, n).items():
        for lname, lin, kind, groups in _layers(m):
            prefix = f"{mname}.{lname}." if mname else f"{lname}."
            leaves = ("weight", "q") if kind == "row" else (
                "weight", "q", "bias", "scale")
            for leaf in leaves:
                if prefix + leaf in own:
                    dim = 1 if kind == "row" else 0
                    out[prefix + leaf] = (kind, groups, dim)
    return out


def tp_slice(t, role: tuple, j: int, n: int):
    """Shard ``j`` of ``n`` of the whole tensor ``t`` under ``role`` (from
    :func:`tp_roles`): what a form-(b) rank at axis position ``j`` keeps."""
    _, groups, dim = role
    parts = t.unflatten(dim, (groups, -1))
    return torch.cat([parts.select(dim, g).chunk(n, dim)[j]
                      for g in range(groups)], dim)


def tp_layout(model: nn.Module, n: int) -> Dict[str, tuple]:
    """The spec, in the Flax orientation of :func:`tp_spec_for_path`, of
    every parameter and buffer of ``model`` as :func:`apply_tp` lays it out
    over an axis of ``n``; keys are ``state_dict`` names."""
    out = {name: () for name in model.state_dict()}
    for name, (kind, _, _) in tp_roles(model, n).items():
        out[name] = ((MODEL_AXIS,) if name.endswith(("bias", "scale"))
                     else ROW_SPEC if kind == "row" else COLUMN_SPEC)
    return out


@torch.no_grad()
def _keep_local(lin, kind: str, groups: int, comm) -> None:
    dim = 1 if kind == "row" else 0
    names = ["q" if isinstance(lin, QuantLinear) else "weight"]
    if kind != "row":
        names += ["bias", "scale"]
    for name in names:
        t = getattr(lin, name, None)
        if t is None:
            continue
        local = tp_slice(t, (kind, groups, dim if name in ("weight", "q")
                             else 0), comm.index[0], comm.n).contiguous()
        if isinstance(t, nn.Parameter):
            setattr(lin, name, nn.Parameter(local,
                                            requires_grad=t.requires_grad))
        else:
            setattr(lin, name, local)


def apply_tp(model: nn.Module, mesh, axis: str = MODEL_AXIS) -> nn.Module:
    """Switch ``model`` in place to its TP form over ``axis`` of ``mesh``:
    every module of :func:`tp_modules` computes Megatron's block over the
    axis's shards. Form (a) keeps the whole tensors (a shard is a view of
    them); form (b) keeps the rank's slice of each sharded one. An axis of
    size 1 leaves the model as it is. Returns ``model``."""
    if axis not in mesh.shape or mesh.shape[axis] == 1:
        return model
    comm = mesh.comm(axis)
    for m in tp_modules(model, comm.n).values():
        if getattr(m, "tp", None) is not None:
            continue
        if comm.distributed:
            for _, lin, kind, groups in _layers(m):
                _keep_local(lin, kind, groups, comm)
        m.tp = comm
    return model
