"""k-diffusion LMS sampler (port of ``samplers/k_samplers.py``).

Sigma, timestep and input-scale tables and the whole LMS coefficient table
are computed on the host in float64 once per configuration and moved to
the device as fp32. The LMS history is an (order, ...) ring with slot 0 the
newest output; unfilled slots meet a zero coefficient. The other samplers
of the JAX module (k_euler, k_euler_ancestral, dpmpp_2m) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops import schedules

_NOT_PORTED = ("k_euler", "k_euler_ancestral", "dpmpp_2m")


@dataclasses.dataclass(frozen=True)
class KSamplerConfig:
    method: str = "k_lms"
    n_inference_steps: int = 50
    n_training_steps: int = 1000
    lms_order: int = 4
    strength: float = 1.0           # img2img partial denoise (1.0 = from noise)


def sigma_tables(cfg: KSamplerConfig):
    """Host tables: sigmas (S+1,), timesteps (S,), input_scales (S+1,),
    start_step, initial_scale, lms_coeffs (S, order) or None."""
    sigmas, timesteps = schedules.karras_sigma_schedule(
        cfg.n_inference_steps, cfg.n_training_steps)
    start_step = cfg.n_inference_steps - int(cfg.n_inference_steps
                                             * cfg.strength)
    lms = None
    if cfg.method == "k_lms":
        lms = schedules.lms_coefficients(sigmas, cfg.lms_order,
                                         start_step=start_step)
    return dict(sigmas=sigmas, timesteps=timesteps,
                input_scales=schedules.input_scale(sigmas),
                start_step=start_step,
                initial_scale=float(sigmas[start_step]), lms_coeffs=lms)


def make_sampler_body(denoise_fn: Callable, cfg: KSamplerConfig,
                      tables=None, device=None):
    """``(body, make_carry, extract)`` for one sampler method:
    ``body(carry, t) -> carry`` is one denoise step, where ``denoise_fn``
    gets the pre-scaled latent and the fp32 timestep."""
    if cfg.method in _NOT_PORTED:
        raise NotImplementedError(
            f"sampler {cfg.method!r} is not ported yet (k_lms only)")
    if cfg.method != "k_lms":
        raise ValueError(f"unknown sampler {cfg.method!r}")
    if tables is None:
        tables = sigma_tables(cfg)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    timesteps = f32(tables["timesteps"])
    scales = f32(tables["input_scales"])
    coeffs = f32(tables["lms_coeffs"])

    def body(carry, t):
        x, hist = carry
        out = denoise_fn(x * scales[t], timesteps[t])
        hist = torch.roll(hist, 1, dims=0)
        hist[0] = out
        return x + torch.einsum("o,o...->...", coeffs[t], hist), hist

    def make_carry(latents):
        return latents, latents.new_zeros((cfg.lms_order,) + latents.shape)

    return body, make_carry, lambda carry: carry[0]
