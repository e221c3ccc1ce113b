"""k-diffusion samplers as host loops (port of ``samplers/k_samplers.py``):
k_lms, k_euler, k_euler_ancestral and dpmpp_2m (DPM-Solver++(2M)).

Sigma, timestep and input-scale tables, the whole LMS coefficient table and
DPM-Solver++'s log-sigma coefficients are computed on the host in float64
once per configuration and moved to the device as fp32. The LMS history is
an (order, ...) ring with slot 0 the newest output; unfilled slots meet a
zero coefficient. The denoiser callback receives the pre-scaled latent and
the fp32 timestep and returns the CFG-combined model output.

The ancestral sampler's per-step noise comes from a ``torch.Generator`` or
from a ``step_noise`` hook, a callable ``t -> array`` of the latent's shape
(the JAX package draws ``normal(fold_in(rng, t))``; a test feeds those
draws through the hook).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import schedules

SAMPLERS = ("k_lms", "k_euler", "k_euler_ancestral", "dpmpp_2m")


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
                      tables=None, device=None,
                      generator: Optional[torch.Generator] = None,
                      step_noise: Optional[Callable] = None):
    """``(body, make_carry, extract)`` for one sampler method:
    ``body(carry, t) -> carry`` is one denoise step, where ``denoise_fn``
    gets the pre-scaled latent and the fp32 timestep. k_euler_ancestral
    needs ``generator`` (on the latents' device) or ``step_noise``."""
    if cfg.method not in SAMPLERS:
        raise ValueError(f"unknown sampler {cfg.method!r}")
    if tables is None:
        tables = sigma_tables(cfg)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=device)
    sigmas = f32(tables["sigmas"])
    timesteps = f32(tables["timesteps"])
    scales = f32(tables["input_scales"])

    if cfg.method == "k_lms":
        coeffs = f32(tables["lms_coeffs"])

        def body(carry, t):
            x, hist = carry
            out = denoise_fn(x * scales[t], timesteps[t])
            hist = torch.roll(hist, 1, dims=0)
            hist[0] = out
            return x + torch.einsum("o,o...->...", coeffs[t], hist), hist

        def make_carry(latents):
            return latents, latents.new_zeros((cfg.lms_order,)
                                              + latents.shape)

        return body, make_carry, lambda carry: carry[0]

    if cfg.method == "k_euler":

        def body(x, t):
            out = denoise_fn(x * scales[t], timesteps[t])
            return x + out * (sigmas[t + 1] - sigmas[t])

        return body, lambda latents: latents, lambda carry: carry

    if cfg.method == "dpmpp_2m":
        # epsilon-prediction form (denoised = x - sigma_t * eps):
        #   h_t = ln sigma_t - ln sigma_{t+1}, ratio_t = sigma_{t+1} / sigma_t,
        #   em1_t = expm1(-h_t), r_t = h_{t-1} / h_t
        #   x <- ratio * x - em1 * D,
        #   D = (1 + 1/2r) * denoised - (1/2r) * previous denoised;
        # first order at the first executed step and at the final sigma = 0.
        s = np.asarray(tables["sigmas"], np.float64)
        n = len(s) - 1
        ls = np.log(np.maximum(s, 1e-40))
        h = ls[:-1] - ls[1:]
        ratio_t = f32(s[1:] / np.maximum(s[:-1], 1e-40))
        em1_t = f32(np.expm1(-h))
        r = np.ones(n)
        r[1:] = h[:-1] / np.maximum(h[1:], 1e-40)
        r_t = f32(r)
        use2 = (np.arange(n) > tables["start_step"]) & (s[1:] > 0)

        def body(carry, t):
            x, old = carry
            out = denoise_fn(x * scales[t], timesteps[t])
            denoised = x - sigmas[t] * out
            d = denoised
            if use2[t]:
                w = 1.0 / (2.0 * r_t[t])
                d = (1.0 + w) * denoised - w * old
            return ratio_t[t] * x - em1_t[t] * d, denoised

        return (body, lambda latents: (latents, torch.zeros_like(latents)),
                lambda carry: carry[0])

    if generator is None and step_noise is None:
        raise ValueError("k_euler_ancestral needs a generator or step_noise")

    def body(x, t):
        out = denoise_fn(x * scales[t], timesteps[t])
        s_from, s_to = sigmas[t], sigmas[t + 1]
        s_from_safe = s_from.clamp(min=1e-12)
        s_up = s_to * torch.sqrt((1.0 - s_to ** 2 / s_from_safe ** 2)
                                 .clamp(min=0.0))
        s_down = s_to ** 2 / s_from_safe
        x = x + out * (s_down - s_from)
        if step_noise is not None:
            noise = torch.tensor(np.asarray(step_noise(t)), dtype=x.dtype,
                                 device=x.device)
        else:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                device=x.device)
        return x + noise * s_up

    return body, lambda latents: latents, lambda carry: carry


def k_sampler_scan(denoise_fn: Callable, latents, cfg: KSamplerConfig,
                   generator: Optional[torch.Generator] = None, tables=None,
                   step_noise: Optional[Callable] = None):
    """Run the denoise trajectory from ``start_step`` to the end as a host
    loop; returns the final latents."""
    if tables is None:
        tables = sigma_tables(cfg)
    body, make_carry, extract = make_sampler_body(
        denoise_fn, cfg, tables, latents.device, generator, step_noise)
    carry = make_carry(latents)
    for t in range(tables["start_step"], cfg.n_inference_steps):
        carry = body(carry, t)
    return extract(carry)
