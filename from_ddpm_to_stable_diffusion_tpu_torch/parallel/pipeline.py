"""Pipeline parallelism: GPipe-style microbatched stages and the 1F1B
training schedule (port of ``parallel/pipeline.py``).

A homogeneous stack (the MMDiT's joint blocks) is split into stages over a
``stage`` mesh axis; microbatches stream through them with ``ppermute``
hand-offs between neighbours. :func:`pipeline_apply` runs the classic
(n_micro + n_stages − 1)-tick schedule: tick t runs stage s on microbatch
t − s (a stage idles where that is out of range: the JAX schedule computes
a discarded result there). :func:`pipeline_value_and_grad` runs the 1F1B
(PipeDream-flush) schedule of :func:`make_1f1b_schedule`: each stage
stashes at most n_stages microbatch inputs and recomputes its forward at the
stashed input for the backward (``torch.autograd.grad``, as ``jax.vjp``
there). Both equal the sequential stack.

``stage_params`` is a pytree (dict, tuple or list) of tensors with a leading
stage dim: n_stages in mesh form (a), the rank's 1 in form (b).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .mesh import Mesh

STAGE_AXIS = "stage"


def _stage_slices(comm, stage_params):
    """Each held stage's parameters (leading dim dropped), on its device."""
    leaves, spec = pytree.tree_flatten(stage_params)
    per_leaf = [comm.shards(p, 0) for p in leaves]
    return [pytree.tree_unflatten([s[i][0] for s in per_leaf], spec)
            for i in range(len(comm.index))]


def _microbatches(x, n_microbatches):
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} "
                         "microbatches")
    return x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   mesh: Mesh, n_microbatches: int,
                   axis: str = STAGE_AXIS) -> torch.Tensor:
    """``x`` through the stacked stages, pipelined over ``axis``.
    ``stage_fn(params_slice, x_micro) -> y_micro`` of the same shape;
    ``x`` (batch, ...) with batch % n_microbatches == 0, whole on every
    shard; the output is too (the last stage's, summed over the axis)."""
    comm = mesh.comm(axis)
    n_stages, m = comm.n, n_microbatches
    micro = _microbatches(x, m)
    params = _stage_slices(comm, stage_params)
    held = list(enumerate(comm.index))
    feeds = [micro.to(comm.devices[i]) for i, _ in held]
    zero = [torch.zeros_like(f[0]) for f in feeds]
    outputs = [torch.zeros_like(f) for f in feeds]
    buf = list(zero)
    up = [(s, s + 1) for s in range(n_stages - 1)]
    for t in range(m + n_stages - 1):
        ys = []
        for i, sid in held:
            midx = t - sid
            if not 0 <= midx < m:
                ys.append(zero[i])
                continue
            y = stage_fn(params[i], feeds[i][midx] if sid == 0 else buf[i])
            if sid == n_stages - 1:
                outputs[i][midx] = y
            ys.append(y)
        buf = comm.ppermute(ys, up)
    last = [o if sid == n_stages - 1 else torch.zeros_like(o)
            for o, (_, sid) in zip(outputs, held)]
    out = comm.psum(last)[0].to(x.device)
    return out.reshape(x.shape)


def make_1f1b_schedule(n_stages: int, n_micro: int):
    """Simulate the synchronous 1F1B (PipeDream-flush) schedule host-side.

    Returns int32 arrays ``F``, ``Bw`` of shape (n_ticks, n_stages): the
    microbatch index stage s forwards/backwards at tick t (−1 = idle).
    Policy: stage s keeps at most min(n_stages − s, n_micro) microbatches
    in flight; once at the cap (or out of forwards) it runs a backward —
    so the steady state alternates 1 forward / 1 backward and the live
    activation stash per stage is bounded by n_stages, not n_micro.
    """
    S, M = n_stages, n_micro
    limit = [min(S - s, M) for s in range(S)]
    f_done_tick = [[-1] * M for _ in range(S)]   # tick fwd(s,m) ran
    b_done_tick = [[-1] * M for _ in range(S)]
    f_cnt = [0] * S
    b_cnt = [0] * S
    F, Bw = [], []
    t = 0
    while b_cnt[0] < M:
        assert t < 4 * (M + S), "1F1B schedule failed to converge"
        frow, brow = [-1] * S, [-1] * S
        for s in range(S):
            m_f, m_b = f_cnt[s], b_cnt[s]
            f_ready = m_f < M and (s == 0 or 0 <= f_done_tick[s - 1][m_f] < t)
            b_ready = m_b < m_f and (
                s == S - 1 or 0 <= b_done_tick[s + 1][m_b] < t)
            in_flight = m_f - m_b
            if b_ready and (in_flight >= limit[s] or m_f == M):
                brow[s] = m_b
                b_done_tick[s][m_b] = t
                b_cnt[s] += 1
            elif f_ready and in_flight < limit[s]:
                # at the cap the stage IDLES until a gradient arrives —
                # eager forwards would grow the stash past the 1F1B bound
                frow[s] = m_f
                f_done_tick[s][m_f] = t
                f_cnt[s] += 1
        F.append(frow)
        Bw.append(brow)
        t += 1
    return np.asarray(F, np.int32), np.asarray(Bw, np.int32)


def _stage_vjp(stage_fn, params, x_in, g):
    """(dparams, dx) of ``stage_fn`` at (params, x_in) against ``g``, the
    forward recomputed under autograd."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    x_in = x_in.detach().requires_grad_()
    with torch.enable_grad():
        y = stage_fn(pytree.tree_unflatten(leaves, spec), x_in)
        grads = torch.autograd.grad(y, [x_in, *leaves], g,
                                    allow_unused=True)
    dx, dps = grads[0], grads[1:]
    dps = [torch.zeros_like(p) if d is None else d
           for p, d in zip(leaves, dps)]
    return dps, (torch.zeros_like(x_in) if dx is None else dx)


def pipeline_value_and_grad(stage_fn: Callable, stage_params,
                            x: torch.Tensor, targets: torch.Tensor,
                            loss_fn: Callable, mesh: Mesh,
                            n_microbatches: int, axis: str = STAGE_AXIS):
    """One pipelined training step: (mean loss over the microbatches,
    gradients of ``stage_params`` in its structure and stage dims).

    1F1B over ``axis``: activations go forward and gradients back through
    ``ppermute`` hand-offs; each stage stashes at most n_stages microbatch
    inputs and recomputes its forward there for the backward.
    ``loss_fn(y_micro, target_micro) -> scalar``; x and targets (batch, …),
    whole on every shard."""
    comm = mesh.comm(axis)
    S, M = comm.n, n_microbatches
    micro = _microbatches(x, M)
    tgt = _microbatches(targets, M)
    F, Bw = make_1f1b_schedule(S, M)
    params = _stage_slices(comm, stage_params)
    held = list(enumerate(comm.index))
    devs = [comm.devices[i] for i, _ in held]
    feeds = [micro.to(d) for d in devs]
    tgts = [tgt.to(d) for d in devs]
    zero = [torch.zeros_like(f[0]) for f in feeds]
    in_buf = [dict() for _ in held]       # slot (micro % S) -> activation
    stash = [dict() for _ in held]        # slot -> stashed stage input
    g_buf = [dict() for _ in held]        # slot -> gradient of the output
    dparams = [None] * len(held)
    loss_acc = [torch.zeros((), device=d) for d in devs]
    up = [(s, s + 1) for s in range(S - 1)]
    down = [(s + 1, s) for s in range(S - 1)]
    for t in range(F.shape[0]):
        ys, dxs = [], []
        for i, sid in held:
            fm, bm = int(F[t, sid]), int(Bw[t, sid])
            y = zero[i]
            if fm >= 0:
                x_in = feeds[i][fm] if sid == 0 else in_buf[i].pop(fm % S)
                with torch.no_grad():
                    y = stage_fn(params[i], x_in)
                stash[i][fm % S] = x_in
                if sid == S - 1:
                    # the last stage: the loss and dL/dy enter the gradient
                    # stream at forward time
                    yy = y.detach().requires_grad_()
                    with torch.enable_grad():
                        loss_m = loss_fn(yy, tgts[i][fm])
                        (gy,) = torch.autograd.grad(loss_m, yy)
                    loss_acc[i] = loss_acc[i] + loss_m.detach().float() / M
                    g_buf[i][fm % S] = gy / M
            dx = zero[i]
            if bm >= 0:
                dps, dx = _stage_vjp(stage_fn, params[i],
                                     stash[i].pop(bm % S),
                                     g_buf[i].pop(bm % S))
                dparams[i] = (dps if dparams[i] is None else
                              [a + d for a, d in zip(dparams[i], dps)])
            ys.append(y)
            dxs.append(dx)
        y_recv = comm.ppermute(ys, up)
        dx_recv = comm.ppermute(dxs, down)
        for i, sid in held:
            fm_prev = int(F[t, sid - 1]) if sid > 0 else -1
            bm_next = int(Bw[t, sid + 1]) if sid < S - 1 else -1
            if fm_prev >= 0:
                in_buf[i][fm_prev % S] = y_recv[i]
            if bm_next >= 0:
                g_buf[i][bm_next % S] = dx_recv[i]
    loss = comm.psum(loss_acc)[0].to(x.device)
    leaves, spec = pytree.tree_flatten(params[0])
    grads = []
    for j in range(len(leaves)):
        grads.append(comm.unshard(
            [(torch.zeros_like(pytree.tree_flatten(params[i])[0][j])
              if dparams[i] is None else dparams[i][j])[None]
             for i in range(len(held))], 0))
    return loss, pytree.tree_unflatten(grads, spec)
