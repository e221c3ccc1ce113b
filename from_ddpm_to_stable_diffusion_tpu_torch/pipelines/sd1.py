"""Stable Diffusion 1 text→image and image→image (port of
``pipelines/sd1.py``).

:class:`SD1Generator` pins the operating point (size, steps, sampler, CFG)
at construction and answers requests: CLIP text encode (optionally with the
``(text:1.3)`` prompt-weight syntax), initial latents from noise or, for
img2img, from the VAE-encoded input image noised to sigma[start_step], a
host loop of sampler steps (k_lms, k_euler, k_euler_ancestral, dpmpp_2m)
over one batch-2B UNet forward (cond | uncond; batch B with ``do_cfg=False``),
VAE decode, uint8 NHWC numpy out. bf16 or fp32 weights and activations,
fp32 latents. :func:`generate` is the one-off form of the same request.

The tokenizer is any object with ``encode_batch(texts)`` returning (N, 77)
ids (``io/tokenizer.py::CLIPTokenizer``; prompt weighting also needs its
``encode_fragment``); without one, all-zero tokens are used. Random draws
come from ``torch.Generator``s seeded from ``seed`` (or, per sample, from
``per_sample_seeds``); ``noise=``, ``enc_noise=`` and ``step_noise=`` replace
them with explicit arrays, so that a test feeds both packages one draw.

:meth:`SD1Models.from_checkpoint_dir` loads the reference's checkpoint
layout (``io/weights.py``) onto the card without the JAX package.

:meth:`SD1Models.quantize_int8` switches the UNet's attention and GEGLU
projections to W8A8 int8 (``ops/quantize.py``).

``SD1Generator(mesh=)`` serves tensor-parallel over the mesh's ``model``
axis (:func:`..parallel.sharding.apply_tp` on every model of the bundle, in
place: the attentions on each shard's heads, the VAE's one-head attention
whole).

``SD1Generator(loop="trajectory")`` runs the whole denoise loop, from the
request's ``start_step`` to the end, as one captured CUDA graph: the
counterpart of the JAX generator's one jitted ``lax.scan``, keyed as it is
on (batch, start_step). See :class:`Trajectory`.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..io.from_jax import load_jax_params, load_state_checked
from ..io.prompt_weights import (apply_token_weights,
                                 batch_encode_with_weights)
from ..io.weights import (import_sd1_clip, import_sd1_unet,
                          import_sd1_vae_decoder, import_sd1_vae_encoder)
from ..models.sd1 import CLIPText, SD1UNet, VAEDecoder, VAEEncoder
from ..models.siglip import SiglipVisionModel
from ..models.vae import BatchNorm
from ..models.vit import ViT
from ..ops.embeddings import sd1_time_embedding
from ..ops.image import rescale, to_uint8
from ..ops.quantize import quantize_module
from ..parallel.sharding import apply_tp
from ..samplers.k_samplers import (SAMPLERS, KSamplerConfig, k_sampler_scan,
                                   make_sampler_body, sigma_tables)
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
    ``position_embedding``, the TinyVLM's ``text_pos`` and the ViT's
    ``cls_token`` and ``pos_embed`` are normal(0.02) tables there, unlike
    CLIP's zero position table; a VQ ``codebook`` is uniform(−1/K, 1/K);
    BatchNorm running statistics start at mean 0, variance 1. A module with
    an ``init_leaves_(generator)`` hook (the stage-05 CLIP and its vision
    tower) draws its own bare parameters with it."""
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
        if (isinstance(parent, (nn.Linear, nn.Conv2d, nn.Embedding))
                or hasattr(parent, "init_leaves_")):
            continue
        if leaf == "weight" or leaf.endswith("_scale"):   # norm scales
            p.fill_(1.0)
        elif leaf == "relative_attention_bias":
            p.normal_(0.0, 1.0, generator=generator)
        elif leaf == "text_projection":
            p.copy_(torch.eye(p.shape[0], device=p.device))
        elif (leaf == "text_pos"
              or (leaf == "position_embedding"
                  and isinstance(parent, SiglipVisionModel))
              or (leaf in ("cls_token", "pos_embed")
                  and isinstance(parent, ViT))):
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "codebook":
            bound = 1.0 / p.shape[0]
            p.uniform_(-bound, bound, generator=generator)
        else:                     # norm biases, position tables
            p.zero_()
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.reset_running_stats()
        elif hasattr(m, "init_leaves_"):
            m.init_leaves_(generator)
    return module


def _prepare(module: nn.Module, device, dtype: str) -> nn.Module:
    if dtype == "bf16":
        cast_params_for_inference(module, POLICIES[dtype].compute_dtype)
    elif dtype != "fp32":
        raise ValueError(f"unknown dtype {dtype!r}")
    return module.to(device=device,
                     memory_format=torch.channels_last).eval()


def _from_state(make: Callable[[], nn.Module], state: Mapping, device
                ) -> nn.Module:
    """``make()`` built without storage, given fp32 storage on ``device``
    and filled from ``state`` (every parameter, nothing left over)."""
    with torch.device("meta"):
        module = make()
    return load_state_checked(module.to_empty(device=device), state)


@dataclasses.dataclass
class SD1Models:
    """Device-resident model bundle. ``encoder`` is None when the bundle was
    made from a parameter tree without one; img2img then raises."""

    clip: CLIPText
    unet: SD1UNet
    encoder: Optional[VAEEncoder]
    decoder: VAEDecoder

    @classmethod
    def initialize(cls, generator: torch.Generator, device,
                   dtype: str = "bf16") -> "SD1Models":
        """Full-size random-init bundle, drawn on ``generator``'s device."""
        mods = []
        for make in (CLIPText, SD1UNet, VAEEncoder, VAEDecoder):
            with torch.device("meta"):
                m = make()
            m = m.to_empty(device=generator.device)
            mods.append(_prepare(flax_default_init_(m, generator), device,
                                 dtype))
        return cls(*mods)

    @classmethod
    def from_checkpoint_dir(cls, ckpt_dir: str, dtype: str = "bf16",
                            device="cuda") -> "SD1Models":
        """Load the reference's checkpoint layout: ``<dir>/ckpt/{clip,
        diffusion,encoder,decoder}.pt`` (01_.../model_loader.py:35-77) into
        the default ``CLIPText()``, ``SD1UNet()``, ``VAEEncoder()`` and
        ``VAEDecoder()``. Each group is read, moved to ``device`` and cast
        before the next is read."""
        groups = (("clip", CLIPText, import_sd1_clip),
                  ("diffusion", SD1UNet, import_sd1_unet),
                  ("encoder", VAEEncoder, import_sd1_vae_encoder),
                  ("decoder", VAEDecoder, import_sd1_vae_decoder))
        return cls(*(
            _prepare(_from_state(make, read(os.path.join(
                ckpt_dir, "ckpt", f"{name}.pt")), device), device, dtype)
            for name, make, read in groups))

    @classmethod
    def from_jax(cls, params: Mapping, device="cuda", dtype: str = "fp32",
                 clip_heads: int = 12, unet_heads: int = 8) -> "SD1Models":
        """The JAX package's ``SD1Models.params`` (``clip``, ``unet``,
        ``decoder`` and, for img2img, ``encoder`` trees). Widths and depths
        are read from the trees; head counts cannot be, so they are
        arguments."""
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
        mods = {"clip": clip, "unet": unet, "decoder": VAEDecoder()}
        if params.get("encoder") is not None:
            mods["encoder"] = VAEEncoder()
        mods = {name: _prepare(load_jax_params(m, params[name]), device, dtype)
                for name, m in mods.items()}
        return cls(mods["clip"], mods["unet"], mods.get("encoder"),
                   mods["decoder"])

    def quantize_int8(self) -> "SD1Models":
        """Switch the UNet's attention and GEGLU projections to the W8A8
        int8 serving path (ops/quantize.py), in place on the UNet's device,
        one linear at a time (the JAX method rebuilds ``SD1UNet(int8_mm=
        True)`` over ``quantize_tree``'s parameters: the same layers)."""
        quantize_module(self.unet)
        self.unet.int8_mm = True
        return self


def sample_seeds(seed: int, per_sample_seeds) -> list:
    """Each sample's seed: its own, or for ``None`` the JAX package's
    ``seed * 100003 + 17 * i + 1``, masked to 32 bits."""
    return [(s if s is not None else seed * 100003 + 17 * i + 1)
            & 0xFFFFFFFF for i, s in enumerate(per_sample_seeds)]


def _check_prompts(prompts, uncond_prompts):
    if not isinstance(prompts, (list, tuple)) or not prompts:
        raise ValueError("prompts must be a non-empty list or tuple")
    if uncond_prompts and not isinstance(uncond_prompts, (list, tuple)):
        raise ValueError("uncond_prompts must be a non-empty list or tuple "
                         "if provided")
    if uncond_prompts and len(prompts) != len(uncond_prompts):
        raise ValueError("length of uncond_prompts must be same as length "
                         "of prompts")


def _check_strength(strength):
    if not 0.0 < strength <= 1.0:
        raise ValueError("strength must be between 0 and 1")


class Trajectory:
    """The denoise loop of one (batch, start_step) key over static buffers:
    the initial latents, the text context and, for the ancestral sampler,
    every step's noise, staged by :meth:`run` before the loop runs; the
    final latents come out of ``out``.

    On a CUDA device the first :meth:`run` warms one step up on a side
    stream (the kernels' builds and plans, cuBLAS and cuDNN), then captures
    every step into one ``torch.cuda.CUDAGraph`` on that stream; each run
    copies into the buffers and replays it. The sampler's tables reach the
    device before the capture, and the kernels' launch arguments (the flash
    kernels' TMA descriptors among them) are baked in with the addresses of
    the buffers and of the graph's own memory pool, which stay put while
    the object lives. A failed capture or replay raises. On the CPU the same
    loop runs on the same buffers without a graph."""

    def __init__(self, gen: "SD1Generator", batch: int, cfg, tables,
                 context: torch.Tensor):
        dev = gen.device
        self.start = tables["start_step"]
        self.steps = range(self.start, cfg.n_inference_steps)
        shape = (batch, gen.height // 8, gen.width // 8, 4)
        self.latents = torch.zeros(shape, device=dev)
        self.context = torch.zeros_like(context)
        self.noise = (torch.zeros((len(self.steps),) + shape, device=dev)
                      if cfg.method == "k_euler_ancestral" else None)
        self.body, self.make_carry, self.extract = make_sampler_body(
            lambda x, t: gen._denoise(x, t, self.context), cfg, tables, dev,
            step_noise=lambda t: self.noise[t - self.start])
        self.graph = None
        self.out = None

    def _loop(self):
        carry = self.make_carry(self.latents)
        for t in self.steps:
            carry = self.body(carry, t)
        return self.extract(carry)

    def _warm_up(self, stream):
        """One step, eagerly, on the capture stream: builds the kernels and
        their launch plans, and makes the library handles, before a
        capture that must not."""
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            self.body(self.make_carry(self.latents.clone()), self.start)
        torch.cuda.current_stream(stream.device).wait_stream(stream)

    def _capture(self, stream):
        # A CUDAGraph that Python's collector frees during the capture (an
        # earlier generator's, held in a reference cycle) destroys its
        # executable graph there, which invalidates this capture: collect
        # first, and keep the collector off until the capture has ended.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                self.out = self._loop()
        finally:
            if collecting:
                gc.enable()
        self.graph = graph

    def run(self, latents, context, step_noise) -> torch.Tensor:
        """The final latents (a copy) from ``latents`` under ``context``;
        ``step_noise(t)`` gives step t's noise (ancestral sampler)."""
        self.latents.copy_(latents)
        self.context.copy_(context)
        if self.noise is not None:
            for i, t in enumerate(self.steps):
                z = step_noise(t)
                self.noise[i].copy_(z if torch.is_tensor(z)
                                    else torch.tensor(np.asarray(z)))
        if self.latents.is_cuda:
            if self.graph is None:
                stream = torch.cuda.Stream(self.latents.device)
                self._warm_up(stream)
                self._capture(stream)
            self.graph.replay()
        else:
            self.out = self._loop()
        return self.out.clone()


class SD1Generator:
    """Text→image and image→image at a fixed operating point; call it once
    per request. ``loop``: "steps" drives the sampler from a host loop of
    eager steps, "trajectory" replays one captured CUDA graph of the whole
    loop per (batch, start_step) (:class:`Trajectory`); both give the same
    latents for the same draws."""

    def __init__(self, models: SD1Models, tokenizer=None,
                 sampler: str = "k_lms", n_inference_steps: int = 50,
                 do_cfg: bool = True, cfg_scale: float = 7.5,
                 height: int = 512, width: int = 512,
                 prompt_weighting: bool = False, mesh=None,
                 loop: str = "steps"):
        if loop not in ("steps", "trajectory"):
            raise ValueError(f"unknown loop value {loop!r}")
        self.loop = loop
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler value {sampler!r}")
        if height % 8 or width % 8:
            raise ValueError("height and width must be multiples of 8")
        if mesh is not None:
            # tensor-parallel serving: every model of the bundle computes
            # its attention, GEGLU and MLP blocks over the mesh's ``model``
            # axis (parallel/sharding.py), each shard on its heads
            for model in (models.clip, models.unet, models.encoder,
                          models.decoder):
                if model is not None:
                    apply_tp(model, mesh)
        self.mesh = mesh
        self.models = models
        self.tokenizer = tokenizer
        self.prompt_weighting = prompt_weighting
        self.do_cfg = do_cfg
        self.cfg_scale = cfg_scale
        self.height, self.width = height, width
        self.device = next(models.unet.parameters()).device
        self.cfg = KSamplerConfig(method=sampler,
                                  n_inference_steps=n_inference_steps)
        self.tables = sigma_tables(self.cfg)
        # loop="trajectory": one Trajectory per (batch, start_step), as the
        # JAX generator keeps one compiled scan per key (cfg and the tables
        # are fixed at construction; a strength fixes start_step's table)
        self.trajectories = {}

    def _denoise(self, x, timestep, context):
        """The model output for one step: with CFG one batch-2B UNet forward
        over [x | x] and [cond | uncond], else one batch-B forward."""
        t_feat = sd1_time_embedding(timestep).expand(context.shape[0], -1)
        if not self.do_cfg:
            return self.models.unet(x, context, t_feat)
        cond, uncond = self.models.unet(torch.cat([x, x]), context,
                                        t_feat).chunk(2)
        return uncond + self.cfg_scale * (cond - uncond)

    def _encode_text(self, prompts, uncond_prompts):
        """CLIP states for [prompts | uncond prompts] (2B, 77, d), or for the
        prompts alone (B, 77, d) without CFG."""
        b = len(prompts)
        n = 2 * b if self.do_cfg else b
        token_weights = None
        if self.tokenizer is None:
            tokens = np.zeros((n, 77), np.int64)
        else:
            texts = list(prompts) + (list(uncond_prompts or [""] * b)
                                     if self.do_cfg else [])
            if self.prompt_weighting:
                tokens, token_weights = batch_encode_with_weights(
                    self.tokenizer, texts)
            else:
                tokens = self.tokenizer.encode_batch(texts)
            tokens = np.asarray(tokens, np.int64)
        context = self.models.clip(torch.as_tensor(tokens,
                                                   device=self.device))
        if token_weights is not None:
            context = apply_token_weights(
                context, np.asarray(token_weights, np.float32))
        return context

    def _sample(self, latents, context, cfg=None, tables=None,
                generator=None, step_noise=None):
        """Run the denoise loop from initial latents, through the loop the
        generator was built with; final latents out."""
        cfg = self.cfg if cfg is None else cfg
        tables = self.tables if tables is None else tables
        if self.loop == "trajectory":
            key = (latents.shape[0], tables["start_step"])
            traj = self.trajectories.get(key)
            if traj is None:
                traj = self.trajectories[key] = Trajectory(
                    self, latents.shape[0], cfg, tables, context)
            if step_noise is None and generator is not None:
                # the eager loop's draws, in its order
                step_noise = lambda t: torch.randn(
                    latents.shape, generator=generator, dtype=latents.dtype,
                    device=latents.device)
            return traj.run(latents, context, step_noise)
        return k_sampler_scan(
            lambda x, t: self._denoise(x, t, context), latents, cfg,
            generator, tables, step_noise)

    def _given(self, name, array, shape):
        if tuple(np.shape(array)) != shape:
            raise ValueError(f"{name} must be {shape}")
        return torch.tensor(np.asarray(array), dtype=torch.float32,
                            device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def initial_noise(self, b: int, seed: Optional[int] = None,
                      per_sample_seeds=None, generator=None):
        """The standard-normal (B, H/8, W/8, 4) draw behind the initial
        latents: one draw from ``generator`` (default: a new one seeded with
        ``seed``), or with ``per_sample_seeds`` each sample from a generator
        of its own, so that a sample's noise does not depend on the batch it
        rides in. ``None`` entries become ``base * 100003 + 17 * i + 1``."""
        shape = (self.height // 8, self.width // 8, 4)
        base = 0 if seed is None else seed
        if per_sample_seeds is None:
            gen = self._generator(base) if generator is None else generator
            return torch.randn((b, *shape), generator=gen, device=self.device)
        if len(per_sample_seeds) != b:
            raise ValueError("per_sample_seeds must match len(prompts)")
        return torch.stack([
            torch.randn(shape, generator=self._generator(s),
                        device=self.device)
            for s in sample_seeds(base, per_sample_seeds)])

    def _encode_images(self, input_images, enc_noise):
        """The scaled latents of uint8 (H, W, 3) images at the pipeline
        size, from the VAE encoder fed ``enc_noise``."""
        if self.models.encoder is None:
            raise ValueError(
                "img2img needs the VAE encoder, and this bundle has none "
                "(SD1Models.from_jax was given no 'encoder' tree)")
        imgs = np.stack([np.asarray(im, np.float32) for im in input_images])
        if imgs.shape[1:] != (self.height, self.width, 3):
            raise ValueError(f"input_images must be ({self.height}, "
                             f"{self.width}, 3) each, got {imgs.shape[1:]}")
        imgs = rescale(torch.as_tensor(imgs, device=self.device), (0, 255),
                       (-1, 1))
        return self.models.encoder(imgs, enc_noise)

    @torch.inference_mode()
    def _run(self, prompts, uncond_prompts, seed, input_images, strength,
             per_sample_seeds, noise, enc_noise, step_noise, return_latents):
        _check_prompts(prompts, uncond_prompts)
        b = len(prompts)
        if per_sample_seeds is not None and input_images is not None:
            raise ValueError("per_sample_seeds is txt2img-only")
        shape = (b, self.height // 8, self.width // 8, 4)
        gen = self._generator(0 if seed is None else seed)
        if noise is None:
            noise = self.initial_noise(b, seed, per_sample_seeds, gen)
        else:
            noise = self._given("noise", noise, shape)
        context = self._encode_text(prompts, uncond_prompts)

        cfg, tables = self.cfg, self.tables
        if input_images is not None:
            _check_strength(strength)
            cfg = dataclasses.replace(self.cfg, strength=strength)
            tables = sigma_tables(cfg)
            if enc_noise is None:
                enc_noise = torch.randn(shape, generator=gen,
                                        device=self.device)
            else:
                enc_noise = self._given("enc_noise", enc_noise, shape)
            latents = (self._encode_images(input_images, enc_noise)
                       + noise * tables["initial_scale"])
        else:
            latents = noise * tables["initial_scale"]
        latents = self._sample(latents, context, cfg, tables, gen, step_noise)
        if return_latents:
            return latents
        return to_uint8(self.models.decoder(latents)).cpu().numpy()

    def __call__(self, prompts: Sequence[str],
                 uncond_prompts: Optional[Sequence[str]] = None,
                 seed: Optional[int] = None,
                 input_images: Optional[Sequence[np.ndarray]] = None,
                 strength: float = 0.8,
                 per_sample_seeds: Optional[Sequence[Optional[int]]] = None,
                 noise: Optional[np.ndarray] = None,
                 enc_noise: Optional[np.ndarray] = None,
                 step_noise: Optional[Callable] = None) -> np.ndarray:
        """uint8 images (B, H, W, 3): txt2img, or img2img when
        ``input_images`` (uint8 HWC arrays at the pipeline size) are given:
        the latents start from the VAE-encoded image noised to
        sigma[start_step] and the remaining ``int(steps * strength)`` steps
        run (the LMS table is rebuilt from ``start_step``).

        ``per_sample_seeds`` (txt2img only) draws each sample's initial
        latents from its own generator (:meth:`initial_noise`), so a request
        reproduces at any batch position with the deterministic samplers;
        the ancestral sampler also mixes batch-level noise at every step.

        Random draws: a generator seeded with ``seed`` (0 if None) gives, in
        this order, the initial noise, the encoder's noise and the
        ancestral sampler's step noise. ``noise`` and ``enc_noise`` are
        explicit standard-normal (B, H/8, W/8, 4) arrays that replace the
        first two, ``step_noise`` a callable ``t -> array`` of that shape
        that replaces the third."""
        return self._run(prompts, uncond_prompts, seed, input_images,
                         strength, per_sample_seeds, noise, enc_noise,
                         step_noise, False)


def generate(prompts: Sequence[str], models: SD1Models, tokenizer=None,
             uncond_prompts: Optional[Sequence[str]] = None,
             input_images: Optional[Sequence[np.ndarray]] = None,
             strength: float = 0.8, do_cfg: bool = True,
             cfg_scale: float = 7.5, height: int = 512, width: int = 512,
             sampler: str = "k_lms", n_inference_steps: int = 50,
             seed: Optional[int] = None, return_latents: bool = False,
             loop: str = "scan", prompt_weighting: bool = False,
             noise: Optional[np.ndarray] = None,
             enc_noise: Optional[np.ndarray] = None,
             step_noise: Optional[Callable] = None):
    """Text→image (image→image when ``input_images`` are given) as a one-off
    call: uint8 images (B, H, W, 3), or the final latents with
    ``return_latents``. It runs on the device the models are on. The same
    parts as :class:`SD1Generator`, which holds nothing compiled here, so
    the two differ only in where the operating point is named. ``loop``
    takes the JAX values, ``"scan"`` and ``"jit_step"`` (two ways to drive
    a jitted step there); both run the one host loop here."""
    if loop not in ("scan", "jit_step"):
        raise ValueError(f"unknown loop driver {loop!r}")
    _check_prompts(prompts, uncond_prompts)
    _check_strength(strength)
    gen = SD1Generator(models, tokenizer, sampler, n_inference_steps, do_cfg,
                       cfg_scale, height, width, prompt_weighting)
    return gen._run(prompts, uncond_prompts, seed, input_images, strength,
                    None, noise, enc_noise, step_noise, return_latents)
