"""DDPM q-sample training loss and ancestral sampler with CFG (port of
``samplers/ddpm.py``).

The coefficient tables are the host float32 tables of
:func:`..ops.schedules.ddpm_tables`, moved to the device once per call.
The T-step reverse process is a host loop (the JAX ``lax.scan``), with the
cond/uncond CFG pair batched into one forward at batch 2B. Random numbers
come from a ``torch.Generator``; JAX's draws cannot be reproduced, so
:func:`ddpm_loss` takes optional ``t`` and ``noise`` and :func:`ddpm_sample`
an optional per-step noise source, which is how the tests feed both
frameworks the same numbers.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.schedules import DDPMTables


def _table(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def q_sample(tables: DDPMTables, x0, t, noise):
    """Forward diffusion x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε ."""
    shape = (-1,) + (1,) * (x0.dim() - 1)
    t = t.long()
    sab = _table(tables.sqrt_alphas_bar, x0.device)[t].reshape(shape)
    somab = _table(tables.sqrt_one_minus_alphas_bar, x0.device)[t]
    return sab * x0 + somab.reshape(shape) * noise


def ddpm_loss(model_fn: Callable, tables: DDPMTables, x0, labels, T: int,
              generator: Optional[torch.Generator] = None, t=None,
              noise=None):
    """Per-element (ε̂ − ε)² with t ~ U[0, T) and ε ~ N(0, I) drawn from
    ``generator`` unless given. Unreduced: the caller reduces it."""
    if t is None:
        t = torch.randint(0, T, (x0.shape[0],), generator=generator,
                          device=x0.device)
    else:
        t = torch.as_tensor(t, device=x0.device)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                            dtype=x0.dtype)
    else:
        noise = torch.as_tensor(noise, dtype=x0.dtype, device=x0.device)
    pred = model_fn(q_sample(tables, x0, t, noise), t, labels)
    return (pred - noise) ** 2


def ddpm_sample(model_fn: Callable, tables: DDPMTables, x_T, labels, T: int,
                w: float = 0.0, generator: Optional[torch.Generator] = None,
                noise_fn: Optional[Callable] = None,
                batched_cfg: bool = True):
    """The T-step ancestral reverse process from ``x_T``, clipped to [−1, 1].

    ε̂ = (1+w)·ε(x, t, labels) − w·ε(x, t, 0), as one forward at batch 2B
    (``batched_cfg``) or as two forwards at batch B, cond then uncond;
    x_{t−1} = c1·x − c2·ε̂ + √var·z, with no noise at t = 0. ``noise_fn(step)``
    gives z for loop step ``step`` (t = T−1−step); otherwise z is drawn from
    ``generator``.
    """
    c1, c2, var = (_table(a, x_T.device) for a in
                   (tables.coeff1, tables.coeff2, tables.sampler_var))
    b = x_T.shape[0]
    ll = torch.cat([labels, torch.zeros_like(labels)])
    x = x_T
    for step in range(T):
        t = T - 1 - step
        if batched_cfg:
            t_vec = torch.full((2 * b,), t, dtype=torch.int32,
                               device=x.device)
            cond, uncond = model_fn(torch.cat([x, x]), t_vec, ll).chunk(2)
        else:
            t_vec = torch.full((b,), t, dtype=torch.int32, device=x.device)
            cond = model_fn(x, t_vec, labels)
            uncond = model_fn(x, t_vec, torch.zeros_like(labels))
        eps = (1.0 + w) * cond - w * uncond
        x = c1[t] * x - c2[t] * eps
        if t > 0:
            z = (noise_fn(step) if noise_fn is not None else
                 torch.randn(x.shape, generator=generator, device=x.device,
                             dtype=x.dtype))
            x = x + torch.sqrt(var[t]) * z
    return x.clamp(-1.0, 1.0)
