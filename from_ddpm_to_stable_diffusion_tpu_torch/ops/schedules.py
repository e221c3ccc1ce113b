"""SD1 noise / sigma schedules, host numpy in float64.

Copies of the four table builders of
``from_ddpm_to_stable_diffusion_tpu/ops/schedules.py`` that the k-LMS path
needs (the JAX module cannot be imported without jax). The tests hold them
against the JAX functions and ``tests/goldens/goldens.npz``.
"""

from __future__ import annotations

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
