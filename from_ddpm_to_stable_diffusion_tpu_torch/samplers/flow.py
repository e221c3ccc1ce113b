"""Rectified-flow Euler and Heun samplers for SD3-class models (port of
``samplers/flow.py``).

σ(t) = shift·t / (1 + (shift − 1)·t); ``denoise_fn(x, sigma)`` returns the
denoised prediction; d = (x − denoised) / σ; x ← x + d·(σ_next − σ). A host
loop over the steps, as the other samplers of this package; the σ table and
its differences are fp32, as in the JAX package's scan.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops import schedules


def noise_scaling(sigma, noise, latent):
    """Flow-matching forward blend: σ·noise + (1 − σ)·latent."""
    return sigma * noise + (1.0 - sigma) * latent


def _sigmas(sigmas, steps, shift, num_timesteps) -> np.ndarray:
    if sigmas is None:
        sigmas = schedules.sd3_sigma_schedule(steps, shift, num_timesteps)
    return np.asarray(sigmas, np.float32)


def _finish(x, traj, keep_trajectory):
    return (x, torch.stack(traj)) if keep_trajectory else x


def flow_euler_sample(denoise_fn: Callable, latents: torch.Tensor,
                      steps: int = 50, shift: float = 3.0,
                      num_timesteps: int = 1000,
                      keep_trajectory: bool = False,
                      sigmas: Optional[np.ndarray] = None):
    """Euler-integrate the probability-flow ODE over ``steps`` steps. With
    ``keep_trajectory`` also returns every intermediate latent, stacked
    (steps, B, ...)."""
    sig = _sigmas(sigmas, steps, shift, num_timesteps)
    x, traj = latents, []
    for i in range(steps):
        sigma = sig[i]
        denoised = denoise_fn(x, float(sigma))
        d = (x - denoised) / float(np.maximum(sigma, np.float32(1e-12)))
        x = x + d * float(sig[i + 1] - sigma)
        if keep_trajectory:
            traj.append(x)
    return _finish(x, traj, keep_trajectory)


def flow_heun_sample(denoise_fn: Callable, latents: torch.Tensor,
                     steps: int = 25, shift: float = 3.0,
                     num_timesteps: int = 1000,
                     keep_trajectory: bool = False,
                     sigmas: Optional[np.ndarray] = None):
    """Heun (second-order) integration of the same ODE: a trapezoid
    corrector at 2 model calls per step, except a step that lands on
    σ = 0, which stays a plain Euler step (the velocity is not defined
    there)."""
    sig = _sigmas(sigmas, steps, shift, num_timesteps)
    tiny = np.float32(1e-12)
    x, traj = latents, []
    for i in range(steps):
        sigma, sigma_next = sig[i], sig[i + 1]
        h = float(sigma_next - sigma)
        d = (x - denoise_fn(x, float(sigma))) / float(np.maximum(sigma, tiny))
        x_euler = x + d * h
        if sigma_next > 0:
            d2 = ((x_euler - denoise_fn(x_euler, float(sigma_next)))
                  / float(np.maximum(sigma_next, tiny)))
            x = x + 0.5 * (d + d2) * h
        else:
            x = x_euler
        if keep_trajectory:
            traj.append(x)
    return _finish(x, traj, keep_trajectory)
