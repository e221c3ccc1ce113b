"""Noise and sigma schedules, host numpy in float64 (port of
``ops/schedules.py``).

Copies of the table builders of
``from_ddpm_to_stable_diffusion_tpu/ops/schedules.py`` that the k-LMS, DDPM
and SD3 flow paths need (the JAX module cannot be imported without jax), and
the warmup-cosine learning rate as a plain function of the update count. The
tests hold them against the JAX functions and ``tests/goldens/goldens.npz``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

# numpy >= 2.0 names it trapezoid; older releases only have trapz.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def get_alphas_cumprod(beta_start: float = 0.00085, beta_end: float = 0.0120,
                       n_training_steps: int = 1000) -> np.ndarray:
    """SD1 scaled-linear ᾱ table: β from sqrt-linspace(√β₀, √β₁)², ᾱ=∏(1−β)."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5, n_training_steps,
                        dtype=np.float32) ** 2
    return np.cumprod(1.0 - betas, axis=0)


def karras_sigma_schedule(n_inference_steps: int = 50,
                          n_training_steps: int = 1000,
                          beta_start: float = 0.00085,
                          beta_end: float = 0.0120):
    """(sigmas (steps+1,) descending with a final 0, timesteps (steps,))."""
    timesteps = np.linspace(n_training_steps - 1, 0, n_inference_steps)
    alphas_cumprod = get_alphas_cumprod(beta_start, beta_end,
                                        n_training_steps)
    sigmas = ((1.0 - alphas_cumprod) / alphas_cumprod) ** 0.5
    log_sigmas = np.interp(timesteps, np.arange(n_training_steps),
                           np.log(sigmas))
    return np.append(np.exp(log_sigmas), 0.0), timesteps


def input_scale(sigmas: np.ndarray) -> np.ndarray:
    """Per-step latent pre-scale 1/√(σ²+1)."""
    return 1.0 / np.sqrt(sigmas**2 + 1.0)


def lms_coefficients(sigmas: np.ndarray, order: int = 4, start_step: int = 0,
                     n_quad_points: int = 81) -> np.ndarray:
    """(steps, order) linear-multistep coefficients: entry [t, i] integrates
    the Lagrange basis polynomial through the last min(t-start+1, order)
    sigmas from σ_t to σ_{t+1} by an ``n_quad_points`` trapezoid rule."""
    n_steps = len(sigmas) - 1
    table = np.zeros((n_steps, order), dtype=np.float64)
    for t in range(start_step, n_steps):
        m = min(t - start_step + 1, order)
        x = np.linspace(sigmas[t], sigmas[t + 1], n_quad_points)
        for i in range(m):
            y = np.ones(n_quad_points)
            for j in range(m):
                if i != j:
                    y *= (x - sigmas[t - j]) / (sigmas[t - i] - sigmas[t - j])
            table[t, i] = _trapezoid(y=y, x=x)
    return table


@dataclasses.dataclass(frozen=True)
class DDPMTables:
    """DDPM q-sample / ancestral-sampling coefficients, (T,) float32 each."""

    betas: np.ndarray
    sqrt_alphas_bar: np.ndarray           # √ᾱ, q-sample signal coefficient
    sqrt_one_minus_alphas_bar: np.ndarray  # √(1−ᾱ), q-sample noise coefficient
    coeff1: np.ndarray                    # √(1/α)
    coeff2: np.ndarray                    # coeff1·(1−α)/√(1−ᾱ)
    posterior_var: np.ndarray             # β·(1−ᾱ_{t−1})/(1−ᾱ)
    sampler_var: np.ndarray               # [posterior_var[1], betas[1:]]


def ddpm_tables(beta_1: float, beta_T: float, T: int) -> DDPMTables:
    """β linear in [β₁, β_T]; everything derived in float64, stored float32."""
    betas = np.linspace(beta_1, beta_T, T, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_bar = np.cumprod(alphas)
    alphas_bar_prev = np.concatenate([[1.0], alphas_bar[:-1]])
    coeff1 = np.sqrt(1.0 / alphas)
    coeff2 = coeff1 * (1.0 - alphas) / np.sqrt(1.0 - alphas_bar)
    posterior_var = betas * (1.0 - alphas_bar_prev) / (1.0 - alphas_bar)
    sampler_var = np.concatenate([posterior_var[1:2], betas[1:]])
    f32 = lambda a: a.astype(np.float32)
    return DDPMTables(
        betas=f32(betas), sqrt_alphas_bar=f32(np.sqrt(alphas_bar)),
        sqrt_one_minus_alphas_bar=f32(np.sqrt(1.0 - alphas_bar)),
        coeff1=f32(coeff1), coeff2=f32(coeff2),
        posterior_var=f32(posterior_var), sampler_var=f32(sampler_var))


def flow_sigma(timestep, shift: float = 1.0, num_timesteps: int = 1000):
    """SD3 discrete-flow σ(t) = shift·(t/1000) / (1 + (shift−1)·(t/1000))."""
    t = timestep / float(num_timesteps)
    if shift == 1.0:
        return t
    return shift * t / (1.0 + (shift - 1.0) * t)


def flow_timestep(sigma, num_timesteps: int = 1000):
    """The timestep fed to the MMDiT: σ·1000."""
    return sigma * float(num_timesteps)


def sd3_sigma_schedule(steps: int = 50, shift: float = 3.0,
                       num_timesteps: int = 1000) -> np.ndarray:
    """(steps+1,) σ trajectory: σ(linspace(t_max, t_min, steps)), then 0; the
    σ table is indexed 1..1000, so σ_min = σ(1) and σ_max = σ(1000)."""
    ts = flow_sigma(np.arange(1, num_timesteps + 1, dtype=np.float64), shift,
                    num_timesteps)
    timesteps = np.linspace(flow_timestep(ts[-1], num_timesteps),
                            flow_timestep(ts[0], num_timesteps), steps)
    return np.append(flow_sigma(timesteps, shift, num_timesteps), 0.0)


def cosine_warmup_lr(base_lr: float, max_lr: float, warmup_epochs: int,
                     total_epochs: int, steps_per_epoch: int = 1,
                     min_lr: Optional[float] = None) -> Callable[[int], float]:
    """``schedule(count) -> lr``: epoch-granular linear warmup base→max, then
    a cosine anneal to ``min_lr`` (0). ``count`` is the number of optimizer
    updates made before this one, so the first update uses ``base_lr``."""
    min_lr = 0.0 if min_lr is None else min_lr
    cosine_epochs = max(total_epochs - warmup_epochs, 1)

    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr + (max_lr - base_lr) * epoch / max(warmup_epochs, 1)
        progress = min(max((epoch - warmup_epochs) / cosine_epochs, 0.0), 1.0)
        return min_lr + 0.5 * (max_lr - min_lr) * (1 + math.cos(math.pi
                                                              * progress))

    return schedule


def warmup_cosine_decay_lr(init_lr: float, peak_lr: float, warmup_steps: int,
                           decay_steps: int,
                           end_lr: float = 0.0) -> Callable[[int], float]:
    """``schedule(count) -> lr`` of ``optax.warmup_cosine_decay_schedule``:
    linear from ``init_lr`` to ``peak_lr`` over ``warmup_steps`` updates,
    then a cosine from ``peak_lr`` to ``end_lr`` that ends at update
    ``decay_steps`` and stays there. ``count`` is the number of updates made
    before this one, so with ``init_lr`` = 0 the first update moves
    nothing."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_lr + (peak_lr - init_lr) * count / warmup_steps
        progress = min(count - warmup_steps, cosine_steps) / cosine_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * progress))
        return end_lr + (peak_lr - end_lr) * cosine

    return schedule
