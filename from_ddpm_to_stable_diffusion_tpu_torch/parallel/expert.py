"""Expert parallelism: a Switch-style top-1 MoE FFN whose experts shard over
a mesh axis (port of ``parallel/expert.py``).

A router (fp32) picks one of E gated-MLP experts per token; a static
capacity ``int(capacity_factor · tokens / E + 1)`` bounds each expert's
inbox, the slot of a token in its expert's queue comes from a cumsum over
the flattened (b·l) token order, and tokens past capacity pass through as
zeros (the caller adds the residual). Dispatch and combine are one-hot
einsums in fp32, as in the JAX module. With a mesh that has the ``expert``
axis, each shard of it runs the E/n local experts on its slice of the
inboxes (:class:`.mesh.AxisComm`); without, the same math runs as batched
einsums, and the two agree exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Linear
from .mesh import DATA_AXIS, Mesh

EXPERT_AXIS = "expert"


def _lecun_normal_(p, fan_in, generator):
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)


def _expert_ffn(xe, wi, wg, wo):
    up = torch.einsum("ekc,ech->ekh", xe, wi)
    gate = torch.einsum("ekc,ech->ekh", xe, wg)
    return torch.einsum("ekh,ehc->ekc", F.silu(gate) * up, wo)


class SwitchFFN(nn.Module):
    """Top-1 routed mixture of experts over (B, L, C) tokens. ``forward``
    returns (out, aux): ``out`` in x's dtype, each token's expert output
    scaled by its router probability (zeros past capacity); ``aux`` the
    Switch load-balancing loss E · Σ_e fraction_e · mean_prob_e.

    Parameters keep the JAX layout: ``router`` a linear C -> E; ``wi``,
    ``wg`` (E, C, H) and ``wo`` (E, H, C), H = hidden_mult · C.

    Routing and dispatch run on the whole batch, as the JAX module's do under
    GSPMD: on a form-(b) mesh with a ``data`` axis the tokens are gathered
    over it first and each rank keeps its own rows of the result."""

    def __init__(self, dim: int, num_experts: int, hidden_mult: int = 4,
                 capacity_factor: float = 1.25):
        super().__init__()
        e, h = num_experts, hidden_mult * dim
        self.num_experts, self.capacity_factor = e, capacity_factor
        self.router = Linear(dim, e, compute_dtype=torch.float32)
        self.wi = nn.Parameter(torch.empty(e, dim, h))
        self.wg = nn.Parameter(torch.empty(e, dim, h))
        self.wo = nn.Parameter(torch.empty(e, h, dim))

    def init_leaves_(self, generator: Optional[torch.Generator] = None):
        """Flax's lecun_normal of the expert weights (fan-in: the middle
        dim)."""
        for p in (self.wi, self.wg, self.wo):
            _lecun_normal_(p, p.shape[1], generator)

    def forward(self, x, mesh: Optional[Mesh] = None,
                axis: str = EXPERT_AXIS):
        data = (mesh.comm(DATA_AXIS) if mesh is not None and mesh.distributed
                and mesh.shape.get(DATA_AXIS, 1) > 1 else None)
        if data is not None:
            x = data.gather_batch(x, 0)
        b, l, c = x.shape
        e = self.num_experts
        # router in fp32: top-1 decisions should not flip with bf16 rounding
        probs = torch.softmax(self.router(x.float()), dim=-1)   # (B, L, E)
        gate = probs.amax(dim=-1)
        choice = probs.argmax(dim=-1)       # the first index on ties, as JAX
        tokens = b * l
        capacity = int(self.capacity_factor * tokens / e + 1)
        onehot = F.one_hot(choice.reshape(tokens), e).float()   # (T, E)
        # each token's position in its expert's queue; -1 off its expert
        pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
        keep = (pos < capacity) & (onehot > 0)
        slot_idx = torch.where(keep, pos, torch.full_like(pos, -1.0)).amax(-1)
        slot = F.one_hot(slot_idx.clamp(min=0).long(), capacity).float()
        slot = slot * (slot_idx >= 0).float()[:, None]           # (T, K)
        dispatch = keep.float()[:, :, None] * slot[:, None, :]   # (T, E, K)
        xe = torch.einsum("td,tek->ekd", x.reshape(tokens, c).float(),
                          dispatch)                              # (E, K, C)
        w = [p.float() for p in (self.wi, self.wg, self.wo)]
        if mesh is not None and mesh.shape.get(axis, 1) > 1:
            comm = mesh.comm(axis)
            if e % comm.n:
                raise ValueError(f"experts {e} must divide axis size "
                                 f"{comm.n}")
            local = [comm.local_shards(t, 0) for t in (xe, *w)]
            ye = comm.gather(comm.unshard(
                [_expert_ffn(*args) for args in zip(*local)], 0), 0)
            ye = ye.to(xe.device)
        else:
            ye = _expert_ffn(xe, *w)
        out = torch.einsum("ekd,tek->td", ye, dispatch)
        out = (out * gate.reshape(tokens, 1)).reshape(b, l, c).to(x.dtype)
        frac = onehot.mean(dim=0)
        mean_prob = probs.reshape(tokens, e).mean(dim=0)
        aux = e * torch.sum(frac * mean_prob)
        if data is not None:
            out = data.slice_batch(out, 0)
        return out, aux
