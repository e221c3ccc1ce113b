"""Stable Diffusion 1 text→image (port of ``pipelines/sd1.py``, txt2img).

:class:`SD1Generator` pins the operating point (size, steps, sampler, CFG)
at construction and answers requests: CLIP text encode, a host loop of
k-LMS steps over one batch-2B UNet forward (cond | uncond), VAE decode,
uint8 NHWC numpy out. bf16 weights and activations, fp32 latents.

Not ported yet (ROADMAP.md): img2img (VAE encoder), the other samplers,
tensor-parallel ``mesh``, ``loop="trajectory"``, ``per_sample_seeds`` and
prompt weighting. The tokenizer is any object with ``encode_batch(texts)``
returning (N, 77) ids; without one, all-zero tokens are used.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..io.from_jax import load_jax_params
from ..models.sd1 import CLIPText, SD1UNet, VAEDecoder
from ..models.siglip import SiglipVisionModel
from ..ops.embeddings import sd1_time_embedding
from ..ops.image import to_uint8
from ..samplers.k_samplers import (KSamplerConfig, make_sampler_body,
                                   sigma_tables)
from ..utils.dtypes import POLICIES, cast_params_for_inference


@torch.no_grad()
def flax_default_init_(module: nn.Module, generator: torch.Generator):
    """Re-draw every parameter with Flax's default initializers, in place:
    lecun_normal (fan-in truncated normal) conv and linear kernels, zero
    biases, unit norm scales, fan-in normal embeddings, zero position
    tables, and the JAX modules' own choices for T5's
    ``relative_attention_bias`` (standard normal) and CLIP's
    ``text_projection`` (identity). Keeps random-weight activations in the
    range the JAX package's random-init runs see. The SigLIP tower's
    ``position_embedding`` and the TinyVLM's ``text_pos`` are normal(0.02)
    tables there, unlike CLIP's zero position table."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, m.embedding_dim ** -0.5,
                            generator=generator)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        parent = module.get_submodule(name.rpartition(".")[0])
        if isinstance(parent, (nn.Linear, nn.Conv2d, nn.Embedding)):
            continue
        if leaf == "weight" or leaf.endswith("_scale"):   # norm scales
            p.fill_(1.0)
        elif leaf == "relative_attention_bias":
            p.normal_(0.0, 1.0, generator=generator)
        elif leaf == "text_projection":
            p.copy_(torch.eye(p.shape[0], device=p.device))
        elif leaf == "text_pos" or (leaf == "position_embedding"
                                    and isinstance(parent, SiglipVisionModel)):
            p.normal_(0.0, 0.02, generator=generator)
        else:                     # norm biases, position tables
            p.zero_()
    return module


def _prepare(module: nn.Module, device, dtype: str) -> nn.Module:
    if dtype == "bf16":
        cast_params_for_inference(module, POLICIES[dtype].compute_dtype)
    elif dtype != "fp32":
        raise ValueError(f"unknown dtype {dtype!r}")
    return module.to(device=device,
                     memory_format=torch.channels_last).eval()


@dataclasses.dataclass
class SD1Models:
    """Device-resident model bundle."""

    clip: CLIPText
    unet: SD1UNet
    decoder: VAEDecoder

    @classmethod
    def initialize(cls, generator: torch.Generator, device,
                   dtype: str = "bf16") -> "SD1Models":
        """Full-size random-init bundle, drawn on ``generator``'s device."""
        mods = []
        for make in (CLIPText, SD1UNet, VAEDecoder):
            with torch.device("meta"):
                m = make()
            m = m.to_empty(device=generator.device)
            mods.append(_prepare(flax_default_init_(m, generator), device,
                                 dtype))
        return cls(*mods)

    @classmethod
    def from_jax(cls, params: Mapping, device="cuda", dtype: str = "fp32",
                 clip_heads: int = 12, unet_heads: int = 8) -> "SD1Models":
        """The JAX package's ``SD1Models.params`` (``clip``, ``unet``,
        ``decoder`` trees; ``encoder`` is not used until img2img is
        ported). Widths and depths are read from the trees; head counts
        cannot be, so they are arguments."""
        clip_p, unet_p = params["clip"], params["unet"]
        vocab, embed = np.shape(clip_p["token_embedding"]["embedding"])
        n_layers = sum(1 for k in clip_p if str(k).startswith("layer"))
        clip = CLIPText(vocab_size=vocab, embed_dim=embed,
                        num_positions=np.shape(clip_p["position_value"])[0],
                        num_layers=n_layers, num_heads=clip_heads)
        unet = SD1UNet(
            model_channels=np.shape(unet_p["enc0_conv"]["kernel"])[-1],
            context_dim=np.shape(unet_p["enc1_att"]["attn2"]["k"]["kernel"])[0],
            num_heads=unet_heads)
        mods = [load_jax_params(m, params[name]) for m, name in
                ((clip, "clip"), (unet, "unet"), (VAEDecoder(), "decoder"))]
        return cls(*(_prepare(m, device, dtype) for m in mods))


class SD1Generator:
    """Text→image at a fixed operating point, with classifier-free guidance;
    call it once per request."""

    def __init__(self, models: SD1Models, tokenizer=None,
                 sampler: str = "k_lms", n_inference_steps: int = 50,
                 cfg_scale: float = 7.5,
                 height: int = 512, width: int = 512):
        if height % 8 or width % 8:
            raise ValueError("height and width must be multiples of 8")
        self.models = models
        self.tokenizer = tokenizer
        self.cfg_scale = cfg_scale
        self.height, self.width = height, width
        self.device = next(models.unet.parameters()).device
        self.cfg = KSamplerConfig(method=sampler,
                                  n_inference_steps=n_inference_steps)
        self.tables = sigma_tables(self.cfg)
        make_sampler_body(lambda x, t: x, self.cfg, self.tables)  # validates

    def _denoise(self, x, timestep, context):
        """CFG as one batch-2B UNet forward over [x | x] and [cond | uncond]."""
        t_feat = sd1_time_embedding(timestep).expand(2 * x.shape[0], -1)
        cond, uncond = self.models.unet(torch.cat([x, x]), context,
                                        t_feat).chunk(2)
        return uncond + self.cfg_scale * (cond - uncond)

    def _encode_text(self, prompts, uncond_prompts):
        """CLIP states for [prompts | uncond prompts] (2B, 77, d)."""
        b = len(prompts)
        if self.tokenizer is None:
            tokens = np.zeros((2 * b, 77), np.int64)
        else:
            texts = list(prompts) + list(uncond_prompts or [""] * b)
            tokens = np.asarray(self.tokenizer.encode_batch(texts), np.int64)
        return self.models.clip(torch.as_tensor(tokens, device=self.device))

    def _sample(self, latents, context):
        """Run the denoise loop from initial latents; final latents out."""
        body, make_carry, extract = make_sampler_body(
            lambda x, t: self._denoise(x, t, context), self.cfg, self.tables,
            self.device)
        carry = make_carry(latents)
        for t in range(self.tables["start_step"], self.cfg.n_inference_steps):
            carry = body(carry, t)
        return extract(carry)

    @torch.inference_mode()
    def __call__(self, prompts: Sequence[str],
                 uncond_prompts: Optional[Sequence[str]] = None,
                 seed: Optional[int] = None,
                 noise: Optional[np.ndarray] = None) -> np.ndarray:
        """uint8 images (B, H, W, 3). ``noise`` is an explicit standard
        normal (B, H/8, W/8, 4) array for the initial latents; otherwise
        they are drawn from a generator seeded with ``seed`` (0 if None)."""
        if not isinstance(prompts, (list, tuple)) or not prompts:
            raise ValueError("prompts must be a non-empty list or tuple")
        if uncond_prompts and len(uncond_prompts) != len(prompts):
            raise ValueError("length of uncond_prompts must be same as "
                             "length of prompts")
        b = len(prompts)
        shape = (b, self.height // 8, self.width // 8, 4)
        if noise is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0 if seed is None else seed)
            noise = torch.randn(shape, generator=gen, device=self.device)
        else:
            if tuple(np.shape(noise)) != shape:
                raise ValueError(f"noise must be {shape}")
            noise = torch.tensor(np.asarray(noise), dtype=torch.float32,
                                 device=self.device)
        context = self._encode_text(prompts, uncond_prompts)
        latents = self._sample(noise * self.tables["initial_scale"], context)
        images = self.models.decoder(latents)
        return to_uint8(images).cpu().numpy()
