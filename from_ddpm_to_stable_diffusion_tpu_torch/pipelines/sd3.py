"""Stable Diffusion 3 text→image (port of ``pipelines/sd3.py``).

:class:`SD3Inferencer` answers a request from token ids: CLIP-L, CLIP-G and
T5 encode the prompt and the negative prompt, a host loop of rectified-flow
steps runs classifier-free guidance as one batch-2B MMDiT forward
(cond | uncond), the 16-channel VAE decodes image by image, uint8 NHWC numpy
comes out. bf16 weights and activations, fp32 latents. All five model
groups stay resident on the device.

:meth:`SD3Models.from_checkpoints` loads the reference's safetensors files
(``io/weights_sd3.py``) onto the card without the JAX package, the MMDiT's
config sniffed from the checkpoint's shapes (:func:`sniff_mmdit_config`).

Not ported yet (ROADMAP.md): the tokenizers and the text entry points, int8
serving (``quantize_int8``), tensor-parallel ``mesh``, the tiled VAE decode,
img2img (``init_image``; the VAE encoder's weights are read but have no
module to fill), ``per_sample_seeds``, prompt weighting (``clip_weights``)
and ``offload_text_encoders``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch

from ..io.from_jax import load_jax_params
from ..io.weights_sd3 import import_clip_text, import_sd3_checkpoint, import_t5
from ..models.mmdit import (BOUNDED_LOGIT_BUDGET, MMDiT, MMDiTConfig,
                            qk_norm_logit_bound)
from ..models.sd3_vae import SD3LatentFormat, SD3VAEDecoder
from ..models.text_encoders import (CLIP_G_CONFIG, CLIP_L_CONFIG,
                                    CLIPTextConfig, CLIPTextModel, T5Config,
                                    T5Encoder, assemble_sd3_cond)
from ..ops.image import to_uint8
from ..ops.schedules import sd3_sigma_schedule
from ..samplers.flow import (flow_euler_sample, flow_heun_sample,
                             noise_scaling)
from .sd1 import _from_state, _prepare, flax_default_init_


def sniff_mmdit_config(state: Mapping[str, torch.Tensor],
                       prefix: str = "model.diffusion_model.") -> MMDiTConfig:
    """Infer MMDiTConfig from a safetensors state dict's tensor shapes."""
    patch_kernel = state[f"{prefix}x_embedder.proj.weight"]
    patch_size = patch_kernel.shape[2]
    in_channels = patch_kernel.shape[1]
    hidden = patch_kernel.shape[0]
    depth = hidden // 64
    pos = state.get(f"{prefix}pos_embed")
    pos_embed_max_size = (int(math.sqrt(pos.shape[1]))
                          if pos is not None else 192)
    y_key = f"{prefix}y_embedder.mlp.0.weight"
    adm = state[y_key].shape[1] if y_key in state else None
    ctx_key = f"{prefix}context_embedder.weight"
    context_dim = state[ctx_key].shape[1] if ctx_key in state else None
    qk_norm = ("rms" if f"{prefix}joint_blocks.0.x_block.attn.ln_q.weight"
               in state else None)
    return MMDiTConfig(patch_size=patch_size, in_channels=in_channels,
                       depth=depth, adm_in_channels=adm,
                       context_dim=context_dim,
                       pos_embed_max_size=pos_embed_max_size,
                       qk_norm=qk_norm)


def _certify_bounded(mmdit: MMDiT) -> MMDiT:
    """With qk-norm, the bounded softmax is certified from the loaded
    gains; a checkpoint whose logit bound reaches the budget gets the online
    softmax instead (the same parameters, rebuilt under that config)."""
    cfg = mmdit.config
    if not cfg.qk_norm:
        return mmdit
    bound = qk_norm_logit_bound(mmdit, 64, cfg.qk_norm)
    if bound < BOUNDED_LOGIT_BUDGET:
        return mmdit
    print(f"[sd3] qk-norm logit bound {bound:.1f} >= "
          f"{BOUNDED_LOGIT_BUDGET:.0f}: online softmax")
    with torch.device("meta"):
        online = MMDiT(dataclasses.replace(cfg, stability="online"))
    online.load_state_dict(mmdit.state_dict(), assign=True)
    return online


@dataclasses.dataclass
class SD3Models:
    """Device-resident bundle of the SD3 model groups; ``t5`` may be None
    (its slot of the context is then zeros)."""

    mmdit: MMDiT
    vae_decoder: SD3VAEDecoder
    clip_l: CLIPTextModel
    clip_g: CLIPTextModel
    t5: Optional[T5Encoder]

    @classmethod
    def _build(cls, fill, device, dtype, mmdit_config, clip_l_cfg, clip_g_cfg,
               t5_config) -> "SD3Models":
        """Make each group in turn, hand it to ``fill(name, make)`` for its
        weights, then cast and move it before the next is made.
        ``t5_config=None`` leaves T5 out."""
        makers = {
            "mmdit": lambda: MMDiT(mmdit_config),
            "vae_decoder": SD3VAEDecoder,
            "clip_l": lambda: CLIPTextModel(clip_l_cfg,
                                            intermediate_output=-2),
            "clip_g": lambda: CLIPTextModel(clip_g_cfg,
                                            intermediate_output=-2),
        }
        if t5_config is not None:
            makers["t5"] = lambda: T5Encoder(t5_config)
        mods = {name: _prepare(fill(name, make), device, dtype)
                for name, make in makers.items()}
        return cls(**mods, t5=None) if t5_config is None else cls(**mods)

    @classmethod
    def initialize(cls, generator: torch.Generator, device="cuda",
                   dtype: str = "bf16", depth: int = 4, with_t5: bool = True,
                   t5_config: Optional[T5Config] = None,
                   pos_embed_max_size: int = 96,
                   clip_l_cfg: CLIPTextConfig = CLIP_L_CONFIG,
                   clip_g_cfg: CLIPTextConfig = CLIP_G_CONFIG) -> "SD3Models":
        """Random-init bundle with Flax's default initializers. Each group
        is created without storage, drawn in fp32 on ``generator``'s device
        and cast to ``dtype`` before the next one is made, so the fp32
        values of the whole bundle never exist at once, and never on the
        host when the generator is on the card. ``depth=24`` and
        ``pos_embed_max_size=192`` with the default text-encoder configs
        give SD3-medium; the defaults are a scaled-down stand-in."""
        def fill(name, make):
            with torch.device("meta"):
                m = make()
            return flax_default_init_(m.to_empty(device=generator.device),
                                      generator)

        return cls._build(
            fill, device, dtype,
            MMDiTConfig(depth=depth, pos_embed_max_size=pos_embed_max_size),
            clip_l_cfg, clip_g_cfg,
            (t5_config or T5Config()) if with_t5 else None)

    @classmethod
    def from_checkpoints(cls, sd3_path: str,
                         clip_l_path: Optional[str] = None,
                         clip_g_path: Optional[str] = None,
                         t5_path: Optional[str] = None, dtype: str = "bf16",
                         device="cuda") -> "SD3Models":
        """Load the reference's model groups from safetensors files
        (sd3_infer.py load(); the MMDiT's config sniffed from the sd3 file).
        Each group goes from the mapped file to ``device`` and is cast
        before the next is read. Both CLIP files are required (the bundle
        has no empty slot for one); without ``t5_path`` the bundle has no
        T5."""
        for name, path in (("clip_l_path", clip_l_path),
                           ("clip_g_path", clip_g_path)):
            if not path:
                raise ValueError(f"SD3Models.from_checkpoints needs {name}")
        mmdit, encoder, decoder, cfg = import_sd3_checkpoint(sd3_path)
        states = {"mmdit": mmdit, "vae_decoder": decoder}
        # the sd3 file stays mapped while any view of it lives: only
        # ``states`` may hold them, so that it is unmapped once both groups
        # are on the device
        del mmdit, encoder, decoder
        t5_config = T5Config() if t5_path else None
        readers = {
            "clip_l": lambda: import_clip_text(clip_l_path,
                                               CLIP_L_CONFIG.num_layers),
            "clip_g": lambda: import_clip_text(clip_g_path,
                                               CLIP_G_CONFIG.num_layers),
            "t5": lambda: import_t5(t5_path, t5_config.num_layers),
        }

        def fill(name, make):
            state = states.pop(name) if name in states else readers[name]()
            module = _from_state(make, state, device)
            return _certify_bounded(module) if name == "mmdit" else module

        return cls._build(fill, device, dtype, cfg, CLIP_L_CONFIG,
                          CLIP_G_CONFIG, t5_config)

    @classmethod
    def from_jax(cls, params: Mapping, device="cuda", dtype: str = "fp32",
                 mmdit_config: MMDiTConfig = MMDiTConfig(),
                 clip_l_cfg: CLIPTextConfig = CLIP_L_CONFIG,
                 clip_g_cfg: CLIPTextConfig = CLIP_G_CONFIG,
                 t5_config: Optional[T5Config] = None) -> "SD3Models":
        """The JAX package's ``SD3Models.params`` (``mmdit``,
        ``vae_decoder``, ``clip_l``, ``clip_g`` and, if present, ``t5``
        trees; ``vae_encoder`` is not used until img2img is ported). The
        configs are those of the JAX modules."""
        return cls._build(
            lambda name, make: load_jax_params(make(), params[name]),
            device, dtype, mmdit_config, clip_l_cfg, clip_g_cfg,
            (t5_config or T5Config()) if "t5" in params else None)


class SD3Inferencer:
    """``gen_image``: token ids in, uint8 images out."""

    def __init__(self, models: SD3Models, shift: float = 3.0):
        self.models = models
        self.shift = shift
        self.device = models.mmdit.pos_embed.device

    def get_empty_latent(self, width: int, height: int) -> torch.Tensor:
        return torch.full((1, height // 8, width // 8, 16), 0.0609,
                          device=self.device)

    @staticmethod
    def empty_t5_tokens(batch: int = 1, length: int = 77) -> np.ndarray:
        """Token ids of the empty prompt for T5: [</s> = 1, 0, 0, ...]. Its
        embeddings are not zero, so the negative conditioning encodes it
        through T5 and does not zero-fill the slot."""
        ids = np.zeros((batch, length), np.int32)
        ids[:, 0] = 1
        return ids

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids), dtype=torch.long,
                               device=self.device)

    @torch.inference_mode()
    def get_cond(self, clip_tokens, t5_tokens=None, clip_g_tokens=None):
        """clip_tokens (B, 77) for CLIP-L, and for CLIP-G unless
        ``clip_g_tokens`` is given; t5_tokens (B, 77), or None for the
        empty prompt. Returns (context (B, 154, 4096), pooled (B, 2048))."""
        m = self.models
        toks = self._tokens(clip_tokens)
        toks_g = toks if clip_g_tokens is None else self._tokens(clip_g_tokens)
        _, l_hidden, l_pooled = m.clip_l(toks)
        _, g_hidden, g_pooled = m.clip_g(toks_g)
        if m.t5 is not None:
            if t5_tokens is None:
                t5_tokens = self.empty_t5_tokens(toks.shape[0])
            t5_out = m.t5(self._tokens(t5_tokens))
        else:
            t5_out = torch.zeros((toks.shape[0], 77, 4096),
                                 dtype=l_hidden.dtype, device=self.device)
        return assemble_sd3_cond(l_hidden, l_pooled, g_hidden, g_pooled,
                                 t5_out)

    @torch.inference_mode()
    def denoise(self, latent, context, pooled, neg_context, neg_pooled,
                steps: int = 50, cfg_scale: float = 5.0, seed: int = 1,
                denoise_strength: float = 1.0, keep_trajectory: bool = False,
                sampler: str = "euler", noise=None):
        """Noise the latent and integrate the flow with batched CFG.
        ``sampler``: 'euler' or 'heun' (2 model calls per step). With
        ``keep_trajectory`` also returns every intermediate latent.
        ``noise`` is an explicit standard-normal array of the latent's
        shape; otherwise it is drawn from a generator seeded with
        ``seed``."""
        if not 0.0 < denoise_strength <= 1.0:
            raise ValueError("denoise_strength must be in (0, 1]")
        if sampler not in ("euler", "heun"):
            raise ValueError(f"unknown sampler {sampler!r}")
        sigmas = sd3_sigma_schedule(steps, self.shift)
        sigmas = sigmas[int(steps * (1.0 - denoise_strength)):]
        latent = torch.as_tensor(latent, dtype=torch.float32,
                                 device=self.device)
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = torch.randn(latent.shape, generator=gen,
                                device=self.device)
        else:
            if tuple(np.shape(noise)) != tuple(latent.shape):
                raise ValueError(f"noise must be {tuple(latent.shape)}")
            noise = torch.as_tensor(np.asarray(noise), dtype=torch.float32,
                                    device=self.device)
        x = noise_scaling(float(sigmas[0]), noise, latent)
        ctx = torch.cat([context, neg_context])
        pld = torch.cat([pooled, neg_pooled])
        b = latent.shape[0]
        mmdit = self.models.mmdit

        def denoise_fn(xt, sigma):
            xx = torch.cat([xt, xt])
            t = torch.full((2 * b,), float(np.float32(sigma)
                                           * np.float32(1000.0)),
                           device=self.device)
            pos, neg = (xx - mmdit(xx, t, pld, ctx) * sigma).chunk(2)
            return neg + (pos - neg) * cfg_scale

        sample = flow_euler_sample if sampler == "euler" else flow_heun_sample
        return sample(denoise_fn, x, steps=len(sigmas) - 1, shift=self.shift,
                      sigmas=sigmas, keep_trajectory=keep_trajectory)

    @torch.inference_mode()
    def vae_decode(self, latent) -> np.ndarray:
        """Latents -> uint8 images, decoded image by image: at 1024² the
        decoder's activations take GiBs per image."""
        decoder = self.models.vae_decoder
        return np.concatenate([
            to_uint8(decoder(SD3LatentFormat.process_out(
                latent[i:i + 1]))).cpu().numpy()
            for i in range(latent.shape[0])])

    def gen_image(self, clip_tokens, t5_tokens=None, neg_clip_tokens=None,
                  neg_t5_tokens=None, width: int = 1024, height: int = 1024,
                  steps: int = 50, cfg_scale: float = 5.0, seed: int = 1,
                  denoise_strength: float = 1.0,
                  keep_trajectory: bool = False, clip_g_tokens=None,
                  neg_clip_g_tokens=None, sampler: str = "euler",
                  noise=None):
        """uint8 images (B, height, width, 3) from (B, 77) token ids. The
        negative prompt defaults to all-zero CLIP tokens and the empty T5
        prompt. With ``keep_trajectory`` also returns uint8 RGB previews
        (steps·B, height/8, width/8, 3) of every intermediate latent,
        through the latent→RGB preview matrix."""
        clip_tokens = np.asarray(clip_tokens)
        if neg_clip_tokens is None:
            neg_clip_tokens = np.zeros_like(clip_tokens)
        context, pooled = self.get_cond(clip_tokens, t5_tokens,
                                        clip_g_tokens=clip_g_tokens)
        neg_context, neg_pooled = self.get_cond(
            neg_clip_tokens, neg_t5_tokens, clip_g_tokens=neg_clip_g_tokens)
        latent = self.get_empty_latent(width, height).expand(
            clip_tokens.shape[0], -1, -1, -1)
        out = self.denoise(latent, context, pooled, neg_context, neg_pooled,
                           steps, cfg_scale, seed, denoise_strength,
                           keep_trajectory=keep_trajectory, sampler=sampler,
                           noise=noise)
        if keep_trajectory:
            latent, traj = out
            previews = SD3LatentFormat.decode_latent_to_preview(
                traj.reshape(-1, *traj.shape[2:])).cpu().numpy()
            return self.vae_decode(latent), previews
        return self.vae_decode(out)
