"""Stable Diffusion 3 text→image and image→image (port of
``pipelines/sd3.py``).

:class:`SD3Inferencer` answers a request from token ids, or from prompt
strings through ``io/spm_tokenizer.py::SD3Tokenizer`` (``gen_image_text``,
``gen_images_text``; ``prompt_weighting`` honours the ``(text:1.3)`` syntax
on both CLIP streams): CLIP-L, CLIP-G and T5 encode the prompt and the
negative prompt, a host loop of rectified-flow steps runs classifier-free
guidance as one batch-2B MMDiT forward (cond | uncond), the 16-channel VAE
decodes, uint8 NHWC numpy comes out. bf16 weights and activations, fp32
latents. ``init_image`` starts from the VAE encoder's latent (img2img);
``per_sample_seeds`` draws each sample's noise from its own generator;
``decode_mode`` picks the whole-image or the streamed row-strip decode
(``models/sd3_vae_tiled.py``); ``offload_text_encoders`` frees the text
encoders once the conditioning is on the card (:meth:`SD3Models.free`).
:meth:`SD3Models.quantize_int8` switches the MMDiT's block projections and
T5's to W8A8 int8 (``ops/quantize.py``).

:meth:`SD3Models.from_checkpoints` loads the reference's safetensors files
(``io/weights_sd3.py``) onto the card without the JAX package, the MMDiT's
config sniffed from the checkpoint's shapes (:func:`sniff_mmdit_config`).

The MMDiT of the bundle may run sequence-parallel joint attention
(:meth:`..models.mmdit.MMDiT.set_attention`: "ring" or "ulysses" over the
``seq`` axis of a :mod:`..parallel` mesh); the inferencer calls it as it
is. ``SD3Inferencer(mesh=)`` serves tensor-parallel over the mesh's
``model`` axis (:func:`..parallel.sharding.apply_tp` on the MMDiT, CLIP-L,
CLIP-G, T5 and the VAE, in place; the VAE's one-head attention runs whole).
Both compose: over a ring or Ulysses MMDiT, on its own ``seq`` mesh or on
one mesh with ``seq`` and ``model`` axes, each head shard runs its own
sequence-parallel joint attention (the command line keeps ``--tp`` and
``--sp`` apart, as the JAX one does). Quantize to int8 before: a form-(b)
rank keeps only its slice of each sharded weight, and a row layer's scales
are over the whole input.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..io.from_jax import load_jax_params
from ..io.prompt_weights import apply_token_weights
from ..io.weights_sd3 import import_clip_text, import_sd3_checkpoint, import_t5
from ..models.mmdit import (BOUNDED_LOGIT_BUDGET, MMDiT, MMDiTConfig,
                            qk_norm_logit_bound)
from ..models.sd3_vae import SD3LatentFormat, SD3VAEDecoder, SD3VAEEncoder
from ..models.sd3_vae_tiled import tiled_decode
from ..models.text_encoders import (CLIP_G_CONFIG, CLIP_L_CONFIG,
                                    CLIPTextConfig, CLIPTextModel, T5Config,
                                    T5Encoder, assemble_sd3_cond)
from ..ops.image import to_uint8
from ..ops.quantize import quantize_module
from ..ops.schedules import sd3_sigma_schedule
from ..parallel.sharding import apply_tp
from ..samplers.flow import (flow_euler_sample, flow_heun_sample,
                             noise_scaling)
from .sd1 import _from_state, _prepare, flax_default_init_, sample_seeds


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
        online = MMDiT(dataclasses.replace(cfg, stability="online"),
                       mesh=mmdit.mesh, seq_axis=mmdit.seq_axis)
    online.load_state_dict(mmdit.state_dict(), assign=True)
    return online


TEXT_ENCODERS = ("clip_l", "clip_g", "t5")
INT8_GROUPS = ("mmdit", "t5")


def quantize_group(module) -> None:
    """Switch an MMDiT or a T5 encoder to its W8A8 projections in place,
    one linear at a time (``ops/quantize.py::quantize_module``), and mark
    its config ``int8_mm=True``."""
    quantize_module(module)
    module.config = dataclasses.replace(module.config, int8_mm=True)


@dataclasses.dataclass
class SD3Models:
    """Device-resident bundle of the SD3 model groups. ``t5`` may be None
    (its slot of the context is then zeros); ``vae_encoder`` is None when
    the bundle was made from a tree or file without one (img2img then
    raises). :meth:`free` sets a group to None and remembers it."""

    mmdit: MMDiT
    vae_encoder: Optional[SD3VAEEncoder]
    vae_decoder: SD3VAEDecoder
    clip_l: CLIPTextModel
    clip_g: CLIPTextModel
    t5: Optional[T5Encoder]

    def __post_init__(self):
        self.freed = set()

    @classmethod
    def _build(cls, fill, device, dtype, mmdit_config, clip_l_cfg, clip_g_cfg,
               t5_config, encoder: bool = True,
               quantize: Sequence[str] = ()) -> "SD3Models":
        """Make each group in turn, hand it to ``fill(name, make)`` for its
        weights, then cast and move it (and switch it to int8 if it is in
        ``quantize``) before the next is made. ``t5_config=None`` leaves T5
        out, ``encoder=False`` the VAE encoder."""
        makers = {
            "mmdit": lambda: MMDiT(mmdit_config),
            "vae_encoder": SD3VAEEncoder,
            "vae_decoder": SD3VAEDecoder,
            "clip_l": lambda: CLIPTextModel(clip_l_cfg,
                                            intermediate_output=-2),
            "clip_g": lambda: CLIPTextModel(clip_g_cfg,
                                            intermediate_output=-2),
        }
        if not encoder:
            del makers["vae_encoder"]
        if t5_config is not None:
            makers["t5"] = lambda: T5Encoder(t5_config)
        mods = {name: None for name in ("vae_encoder", "t5")}
        for name, make in makers.items():
            mods[name] = _prepare(fill(name, make), device, dtype)
            if name in quantize:
                quantize_group(mods[name])
        return cls(**mods)

    @classmethod
    def initialize(cls, generator: torch.Generator, device="cuda",
                   dtype: str = "bf16", depth: int = 4, with_t5: bool = True,
                   t5_config: Optional[T5Config] = None,
                   pos_embed_max_size: int = 96,
                   clip_l_cfg: CLIPTextConfig = CLIP_L_CONFIG,
                   clip_g_cfg: CLIPTextConfig = CLIP_G_CONFIG,
                   int8: bool = False) -> "SD3Models":
        """Random-init bundle with Flax's default initializers. Each group
        is created without storage, drawn in fp32 on ``generator``'s device
        and cast to ``dtype`` (with ``int8``, the MMDiT and T5 then switched
        to W8A8) before the next one is made, so the fp32 values of the
        whole bundle never exist at once, and never on the host when the
        generator is on the card. ``depth=24`` and ``pos_embed_max_size=192``
        with the default text-encoder configs give SD3-medium; the defaults
        are a scaled-down stand-in."""
        def fill(name, make):
            with torch.device("meta"):
                m = make()
            return flax_default_init_(m.to_empty(device=generator.device),
                                      generator)

        return cls._build(
            fill, device, dtype,
            MMDiTConfig(depth=depth, pos_embed_max_size=pos_embed_max_size),
            clip_l_cfg, clip_g_cfg,
            (t5_config or T5Config()) if with_t5 else None,
            quantize=INT8_GROUPS if int8 else ())

    @classmethod
    def from_checkpoints(cls, sd3_path: str,
                         clip_l_path: Optional[str] = None,
                         clip_g_path: Optional[str] = None,
                         t5_path: Optional[str] = None, dtype: str = "bf16",
                         device="cuda") -> "SD3Models":
        """Load the reference's model groups from safetensors files
        (sd3_infer.py load(); the MMDiT's config sniffed from the sd3 file,
        the VAE encoder read from it where it holds one). Each group goes
        from the mapped file to ``device`` and is cast before the next is
        read. Both CLIP files are required (the bundle has no empty slot
        for one); without ``t5_path`` the bundle has no T5."""
        for name, path in (("clip_l_path", clip_l_path),
                           ("clip_g_path", clip_g_path)):
            if not path:
                raise ValueError(f"SD3Models.from_checkpoints needs {name}")
        mmdit, encoder, decoder, cfg = import_sd3_checkpoint(sd3_path)
        states = {"mmdit": mmdit, "vae_encoder": encoder,
                  "vae_decoder": decoder}
        has_encoder = bool(encoder)
        # the sd3 file stays mapped while any view of it lives: only
        # ``states`` may hold them, so that it is unmapped once the groups
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
                          CLIP_G_CONFIG, t5_config, encoder=has_encoder)

    @classmethod
    def from_jax(cls, params: Mapping, device="cuda", dtype: str = "fp32",
                 mmdit_config: MMDiTConfig = MMDiTConfig(),
                 clip_l_cfg: CLIPTextConfig = CLIP_L_CONFIG,
                 clip_g_cfg: CLIPTextConfig = CLIP_G_CONFIG,
                 t5_config: Optional[T5Config] = None) -> "SD3Models":
        """The JAX package's ``SD3Models.params`` (``mmdit``,
        ``vae_decoder``, ``clip_l``, ``clip_g`` and, if present,
        ``vae_encoder`` and ``t5`` trees; an int8 tree's ``q`` / ``scale``
        leaves need configs with ``int8_mm=True``). The configs are those
        of the JAX modules."""
        return cls._build(
            lambda name, make: load_jax_params(make(), params[name]),
            device, dtype, mmdit_config, clip_l_cfg, clip_g_cfg,
            (t5_config or T5Config()) if "t5" in params else None,
            encoder="vae_encoder" in params)

    def _groups(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def quantize_int8(self, groups=INT8_GROUPS) -> "SD3Models":
        """Switch groups to the W8A8 int8 serving path (ops/quantize.py):
        each linear of the MMDiT's blocks and of T5 that the JAX package's
        targets name is converted on its device, one at a time, so that no
        fp32 copy of a group exists. Groups the bundle lacks (freed, no T5)
        are skipped; CLIP and the VAE raise ``ValueError``, as in JAX."""
        for g in groups:
            module = self._groups().get(g)
            if module is None:
                continue
            if g not in INT8_GROUPS:
                raise ValueError(f"int8 not supported for group '{g}'")
            quantize_group(module)
        return self

    def free(self, *names: str) -> None:
        """Drop model groups: the bundle keeps no reference to them, so
        their device memory is released (the reference's ``model.cpu()``
        phase offload, sd3_infer.py:324-375). Encoding with a freed text
        encoder raises."""
        for name in names:
            if self._groups().get(name) is not None:
                setattr(self, name, None)
                self.freed.add(name)

    def free_text_encoders(self) -> None:
        self.free(*TEXT_ENCODERS)

    def hbm_bytes_live(self) -> Optional[int]:
        """Device bytes currently allocated on the bundle's card
        (``torch.cuda.memory_allocated``); None for a CPU bundle."""
        device = next(p.device for m in self._groups().values()
                      if m is not None for p in m.parameters())
        if device.type != "cuda":
            return None
        return torch.cuda.memory_allocated(device)


class SD3Inferencer:
    """``gen_image``: token ids in, uint8 images out; ``gen_image_text`` /
    ``gen_images_text``: prompt strings in, with a tokenizer."""

    def __init__(self, models: SD3Models, shift: float = 3.0,
                 tokenizer=None, mesh=None, decode_mode: str = "auto"):
        """``tokenizer``: an ``io.spm_tokenizer.SD3Tokenizer`` (CLIP + T5),
        needed by the text entry points only. ``decode_mode``: ``"whole"``
        decodes image by image through the decoder module, ``"tiled"``
        streams row strips over the whole batch
        (``models/sd3_vae_tiled.py``), ``"auto"`` takes the tiled decode
        for a batch above 1 at latents of 128 rows and more (1024²)."""
        if decode_mode not in ("auto", "whole", "tiled"):
            raise ValueError(f"unknown decode_mode {decode_mode!r}")
        if mesh is not None:
            for model in models._groups().values():
                if model is not None:
                    apply_tp(model, mesh)
        self.mesh = mesh
        self.models = models
        self.shift = shift
        self.tokenizer = tokenizer
        self.decode_mode = decode_mode
        self.device = models.mmdit.pos_embed.device

    def get_empty_latent(self, width: int, height: int) -> torch.Tensor:
        return torch.full((1, height // 8, width // 8, 16), 0.0609,
                          device=self.device)

    # -- tokenization -----------------------------------------------------
    def tokenize(self, text: str):
        """(clip_l_ids, clip_g_ids, t5_ids) each (1, 77) int32."""
        if self.tokenizer is None:
            raise ValueError(
                "text prompts need a tokenizer: pass io.spm_tokenizer."
                "SD3Tokenizer(clip_tok, t5_tok) to SD3Inferencer")
        streams = self.tokenizer.encode(text)
        return (np.asarray([streams["l"]], np.int32),
                np.asarray([streams["g"]], np.int32),
                np.asarray([streams["t5xxl"]], np.int32))

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

    def _floats(self, name, x, shape=None) -> torch.Tensor:
        """An fp32 tensor on the card from a tensor or an array, checked
        against ``shape`` when given."""
        if shape is not None and tuple(np.shape(x) if not torch.is_tensor(x)
                                       else x.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}")
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    @torch.inference_mode()
    def get_cond(self, clip_tokens, t5_tokens=None, clip_g_tokens=None,
                 clip_weights=None):
        """clip_tokens (B, 77) for CLIP-L, and for CLIP-G unless
        ``clip_g_tokens`` is given (the trio tokenizer pads CLIP-L with EOS
        and CLIP-G with 0); t5_tokens (B, 77), or None for the empty
        prompt. ``clip_weights`` (B, 77): per-token weights from the
        ``(text:w)`` syntax, applied to both CLIP hidden streams
        (mean-preserving, ``io/prompt_weights.py``). Returns (context
        (B, 154, 4096), pooled (B, 2048))."""
        m = self.models
        freed = [g for g in TEXT_ENCODERS if g in m.freed]
        if freed:
            raise ValueError(
                f"the text encoders {freed} were freed (SD3Models.free, "
                f"offload_text_encoders): reload them to encode a prompt")
        toks = self._tokens(clip_tokens)
        toks_g = toks if clip_g_tokens is None else self._tokens(clip_g_tokens)
        _, l_hidden, l_pooled = m.clip_l(toks)
        _, g_hidden, g_pooled = m.clip_g(toks_g)
        if clip_weights is not None:
            w = np.asarray(clip_weights, np.float32)
            l_hidden = apply_token_weights(l_hidden, w)
            g_hidden = apply_token_weights(g_hidden, w)
        if m.t5 is not None:
            if t5_tokens is None:
                t5_tokens = self.empty_t5_tokens(toks.shape[0])
            t5_out = m.t5(self._tokens(t5_tokens))
        else:
            t5_out = torch.zeros((toks.shape[0], 77, 4096),
                                 dtype=l_hidden.dtype, device=self.device)
        return assemble_sd3_cond(l_hidden, l_pooled, g_hidden, g_pooled,
                                 t5_out)

    def get_cond_text(self, text: str):
        l_ids, g_ids, t5_ids = self.tokenize(text)
        return self.get_cond(l_ids, t5_ids, clip_g_tokens=g_ids)

    def initial_noise(self, shape, seed: int = 1, per_sample_seeds=None):
        """The standard-normal starting noise of ``shape`` (B, h, w, 16) on
        the card: one draw from a generator seeded with ``seed``, or with
        ``per_sample_seeds`` each sample from a generator of its own
        (:func:`.sd1.sample_seeds`), so that a sample's noise does not
        depend on the batch it rides in."""
        if per_sample_seeds is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            return torch.randn(tuple(shape), generator=gen,
                               device=self.device)
        if len(per_sample_seeds) != shape[0]:
            raise ValueError("per_sample_seeds must match the batch")
        return torch.stack([
            torch.randn(tuple(shape[1:]), device=self.device,
                        generator=torch.Generator(
                            device=self.device).manual_seed(s))
            for s in sample_seeds(seed, per_sample_seeds)])

    @torch.inference_mode()
    def denoise(self, latent, context, pooled, neg_context, neg_pooled,
                steps: int = 50, cfg_scale: float = 5.0, seed: int = 1,
                denoise_strength: float = 1.0, keep_trajectory: bool = False,
                per_sample_seeds=None, sampler: str = "euler", noise=None):
        """Noise the latent and integrate the flow with batched CFG.
        ``sampler``: 'euler' or 'heun' (2 model calls per step). With
        ``keep_trajectory`` also returns every intermediate latent.
        The starting noise is :meth:`initial_noise` (``seed``,
        ``per_sample_seeds``), unless ``noise``, an explicit
        standard-normal array of the latent's shape, is given."""
        if not 0.0 < denoise_strength <= 1.0:
            raise ValueError("denoise_strength must be in (0, 1]")
        if sampler not in ("euler", "heun"):
            raise ValueError(f"unknown sampler {sampler!r}")
        sigmas = sd3_sigma_schedule(steps, self.shift)
        sigmas = sigmas[int(steps * (1.0 - denoise_strength)):]
        latent = torch.as_tensor(latent, dtype=torch.float32,
                                 device=self.device)
        if noise is None:
            noise = self.initial_noise(latent.shape, seed, per_sample_seeds)
        else:
            noise = self._floats("noise", noise, latent.shape)
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
    def vae_decode(self, latent, mode: Optional[str] = None) -> np.ndarray:
        """Latents -> uint8 images. ``"whole"`` decodes image by image (at
        1024² the decoder's activations take GiBs per image); ``"tiled"``
        streams the same decoder over the whole batch in row strips
        (:func:`..models.sd3_vae_tiled.tiled_decode`); ``None`` takes the
        inferencer's ``decode_mode`` (``"auto"``: tiled for a batch above
        1 at latents of 128 rows and more)."""
        decoder = self.models.vae_decoder
        mode = mode or self.decode_mode
        if mode not in ("auto", "whole", "tiled"):
            raise ValueError(f"unknown decode mode {mode!r}")
        latent = torch.as_tensor(latent, dtype=torch.float32,
                                 device=self.device)
        if mode == "tiled" or (mode == "auto" and latent.shape[0] > 1
                               and latent.shape[1] >= 128):
            img = tiled_decode(decoder, SD3LatentFormat.process_out(latent))
            return to_uint8(img).cpu().numpy()
        return np.concatenate([
            to_uint8(decoder(SD3LatentFormat.process_out(
                latent[i:i + 1]))).cpu().numpy()
            for i in range(latent.shape[0])])

    @torch.inference_mode()
    def vae_encode(self, images, enc_noise=None,
                   generator: Optional[torch.Generator] = None):
        """Images (B, H, W, 3) in [-1, 1] -> latents (B, H/8, W/8, 16):
        mean + std * noise from the encoder in fp32, the log-variance
        clamped to [-30, 20], through ``SD3LatentFormat.process_in``. The
        noise is ``enc_noise`` (a standard-normal array of the latent's
        shape) or a draw from ``generator`` (default: a new one seeded 0)."""
        encoder = self.models.vae_encoder
        if encoder is None:
            raise ValueError("img2img needs the VAE encoder, and this bundle "
                             "has none")
        mean, log_var = encoder(self._floats("images", images)).chunk(2,
                                                                     dim=-1)
        if enc_noise is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            enc_noise = torch.randn(mean.shape, generator=generator,
                                    device=self.device)
        else:
            enc_noise = self._floats("enc_noise", enc_noise, mean.shape)
        z = mean + torch.exp(0.5 * log_var.clamp(-30.0, 20.0)) * enc_noise
        return SD3LatentFormat.process_in(z)

    def gen_image(self, clip_tokens, t5_tokens=None, neg_clip_tokens=None,
                  neg_t5_tokens=None, width: int = 1024, height: int = 1024,
                  steps: int = 50, cfg_scale: float = 5.0, seed: int = 1,
                  init_image=None, denoise_strength: float = 1.0,
                  offload_text_encoders: bool = False,
                  keep_trajectory: bool = False, clip_g_tokens=None,
                  neg_clip_g_tokens=None, per_sample_seeds=None,
                  sampler: str = "euler", clip_weights=None,
                  neg_clip_weights=None, noise=None, enc_noise=None):
        """uint8 images (B, height, width, 3) from (B, 77) token ids. The
        negative prompt defaults to all-zero CLIP tokens and the empty T5
        prompt. ``init_image`` (B, H, W, 3) in [-1, 1] starts from its
        VAE-encoded latent (encoder noise from a generator seeded
        ``seed + 1``, or ``enc_noise``) and runs the last
        ``denoise_strength`` of the schedule. ``offload_text_encoders``
        frees CLIP and T5 once the conditioning is computed (the bundle
        cannot encode a prompt afterwards). With ``keep_trajectory`` also
        returns uint8 RGB previews (steps·B, height/8, width/8, 3) of every
        intermediate latent, through the latent→RGB preview matrix.
        ``noise`` and ``enc_noise`` replace the draws with explicit arrays,
        so that a test feeds both packages one draw."""
        clip_tokens = np.asarray(clip_tokens)
        if neg_clip_tokens is None:
            neg_clip_tokens = np.zeros_like(clip_tokens)
        context, pooled = self.get_cond(clip_tokens, t5_tokens,
                                        clip_g_tokens=clip_g_tokens,
                                        clip_weights=clip_weights)
        neg_context, neg_pooled = self.get_cond(
            neg_clip_tokens, neg_t5_tokens, clip_g_tokens=neg_clip_g_tokens,
            clip_weights=neg_clip_weights)
        if offload_text_encoders:
            self.models.free_text_encoders()
        if init_image is not None:
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            latent = self.vae_encode(init_image, enc_noise, gen)
        else:
            latent = self.get_empty_latent(width, height).expand(
                clip_tokens.shape[0], -1, -1, -1)
        out = self.denoise(latent, context, pooled, neg_context, neg_pooled,
                           steps, cfg_scale, seed, denoise_strength,
                           keep_trajectory=keep_trajectory,
                           per_sample_seeds=per_sample_seeds,
                           sampler=sampler, noise=noise)
        if keep_trajectory:
            latent, traj = out
            previews = SD3LatentFormat.decode_latent_to_preview(
                traj.reshape(-1, *traj.shape[2:])).cpu().numpy()
            return self.vae_decode(latent), previews
        return self.vae_decode(out)

    def gen_image_text(self, prompt: str, neg_prompt: str = "",
                       prompt_weighting: bool = False, **kwargs
                       ) -> np.ndarray:
        """Prompt-string entry point: the prompt and the (possibly empty)
        negative prompt through the CLIP-L / CLIP-G / T5 tokenizer trio.
        ``prompt_weighting`` honours the ``(text:w)`` syntax on the CLIP
        streams (T5 reads the text without the syntax, unweighted)."""
        if prompt_weighting:
            streams, w = self.tokenizer.encode_with_weights(prompt)
            nstreams, nw = self.tokenizer.encode_with_weights(neg_prompt)
            arr = lambda x: np.asarray([x], np.int32)
            return self.gen_image(
                arr(streams["l"]), t5_tokens=arr(streams["t5xxl"]),
                neg_clip_tokens=arr(nstreams["l"]),
                neg_t5_tokens=arr(nstreams["t5xxl"]),
                clip_g_tokens=arr(streams["g"]),
                neg_clip_g_tokens=arr(nstreams["g"]),
                clip_weights=np.asarray([w], np.float32),
                neg_clip_weights=np.asarray([nw], np.float32), **kwargs)
        l_ids, g_ids, t5_ids = self.tokenize(prompt)
        nl_ids, ng_ids, nt5_ids = self.tokenize(neg_prompt)
        return self.gen_image(
            l_ids, t5_tokens=t5_ids, neg_clip_tokens=nl_ids,
            neg_t5_tokens=nt5_ids, clip_g_tokens=g_ids,
            neg_clip_g_tokens=ng_ids, **kwargs)

    def gen_images_text(self, prompts, neg_prompts=None,
                        per_sample_seeds=None, **kwargs) -> np.ndarray:
        """Batched prompt-string entry point (serving): one text encode and
        one denoise over the whole batch. ``per_sample_seeds`` (one per
        prompt, ``None`` entries derived from ``seed``) keeps each
        request's image under any batch composition."""
        neg_prompts = list(neg_prompts or [""] * len(prompts))
        if len(neg_prompts) != len(prompts):
            raise ValueError("neg_prompts must match len(prompts)")

        def stack(texts):
            ids = [self.tokenize(t) for t in texts]
            return tuple(np.concatenate([t[i] for t in ids])
                         for i in range(3))

        l_ids, g_ids, t5_ids = stack(prompts)
        nl_ids, ng_ids, nt5_ids = stack(neg_prompts)
        return self.gen_image(
            l_ids, t5_tokens=t5_ids, neg_clip_tokens=nl_ids,
            neg_t5_tokens=nt5_ids, clip_g_tokens=g_ids,
            neg_clip_g_tokens=ng_ids, per_sample_seeds=per_sample_seeds,
            **kwargs)
