"""From-scratch CLIP (ViT-L/14 class), image and text towers, stage 05
(port of ``models/clip.py``).

- The vision tower: conv patchify (no bias), class token, LN-pre / LN-post,
  projection from the class-token state (``x @ proj``, no transpose).
- The text tower: token and learned positional embeddings, causal
  transformer, final LN, EOS-argmax pooling (the first maximum of the token
  ids, in torch as in jnp), text projection.
- ``forward``: L2-normalised features in fp32, cosine logits scaled by
  ``exp(logit_scale)`` (init ln(1/0.07)).
- :func:`clip_contrastive_loss` (symmetric InfoNCE) and :func:`siglip_loss`
  (pairwise sigmoid), as the JAX package's pure functions.

Activations are NHWC images and (B, L, C) tokens, as in the JAX package.
Submodules and parameters are named after the Flax parameter paths
(``visual.block{i}.attn.qkv``, ``text_block{i}``, ``ln_final``,
``visual.class_embedding`` ...), so ``io/from_jax.py`` carries a JAX tree
across by renaming leaves only. ``dtype`` is the JAX module's ``dtype=``:
parameters stay fp32, and the patchify conv (its input cast first), every
linear and the residual streams compute in it; the norms keep fp32
statistics, and the logits are fp32. On the card a vision tower over at
least 512 tokens (336^2 images at patch 14: 577) runs its attention in the
flash kernels; at 224^2 (257 tokens) and in the 77-token text tower it is
plain.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, LayerNorm, Linear, SelfAttention


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, num_heads: int, causal: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        self.ln1 = LayerNorm(width)
        self.attn = SelfAttention(width, num_heads, qkv_bias=True,
                                  causal=causal, compute_dtype=dt)
        self.ln2 = LayerNorm(width)
        self.fc = Linear(width, 4 * width, compute_dtype=dt)
        self.proj = Linear(4 * width, width, compute_dtype=dt)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = self.fc(self.ln2(x))
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        return x + self.proj(h)


class CLIPVisionTower(nn.Module):
    """x (B, H, W, 3) -> pooled projected features (B, output_dim). The
    position table holds (input_resolution / patch_size)^2 + 1 rows, and
    the input must give that many tokens (the JAX tower sizes it from its
    first input)."""

    def __init__(self, input_resolution: int = 224, patch_size: int = 14,
                 width: int = 1024, layers: int = 24, output_dim: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.layers, self.dtype = width, layers, dtype
        dt = None if dtype == torch.float32 else dtype
        heads = max(1, width // 64)
        tokens = (input_resolution // patch_size) ** 2 + 1
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size,
                            bias=False, compute_dtype=dt)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(tokens, width))
        self.ln_pre = LayerNorm(width)
        for i in range(layers):
            self.add_module(f"block{i}",
                            ResidualAttentionBlock(width, heads,
                                                   compute_dtype=dt))
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))
        self.init_leaves_()

    @torch.no_grad()
    def init_leaves_(self, generator: Optional[torch.Generator] = None):
        """The JAX tower's initializers of its bare parameters: normal with
        std width^-0.5."""
        for p in (self.class_embedding, self.positional_embedding,
                  self.proj):
            p.normal_(0.0, self.width ** -0.5, generator=generator)

    def forward(self, x):
        b = x.shape[0]
        h = self.conv1(x.to(self.dtype))
        h = h.reshape(b, -1, self.width)
        cls = self.class_embedding.to(h.dtype).expand(b, 1, self.width)
        h = torch.cat([cls, h], dim=1)
        if h.shape[1] != self.positional_embedding.shape[0]:
            raise ValueError(
                f"{h.shape[1]} tokens for a position table of "
                f"{self.positional_embedding.shape[0]}: build the tower for "
                f"this image size")
        h = self.ln_pre(h + self.positional_embedding.to(h.dtype))
        for i in range(self.layers):
            h = getattr(self, f"block{i}")(h)
        h = self.ln_post(h[:, 0])
        return h @ self.proj.to(h.dtype)


class CLIP(nn.Module):
    """Both towers and the logit scale; ``config`` holds the arguments, so
    a trainer can build the same model elsewhere."""

    def __init__(self, embed_dim: int = 768, image_resolution: int = 224,
                 vision_layers: int = 24, vision_width: int = 1024,
                 vision_patch_size: int = 14, context_length: int = 77,
                 vocab_size: int = 49408, transformer_width: int = 768,
                 transformer_heads: int = 12, transformer_layers: int = 12,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = dict(
            embed_dim=embed_dim, image_resolution=image_resolution,
            vision_layers=vision_layers, vision_width=vision_width,
            vision_patch_size=vision_patch_size,
            context_length=context_length, vocab_size=vocab_size,
            transformer_width=transformer_width,
            transformer_heads=transformer_heads,
            transformer_layers=transformer_layers, dtype=dtype)
        self.dtype, self.transformer_layers = dtype, transformer_layers
        dt = None if dtype == torch.float32 else dtype
        self.visual = CLIPVisionTower(image_resolution, vision_patch_size,
                                      vision_width, vision_layers, embed_dim,
                                      dtype)
        self.token_embedding = nn.Embedding(vocab_size, transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, transformer_width))
        for i in range(transformer_layers):
            self.add_module(f"text_block{i}", ResidualAttentionBlock(
                transformer_width, transformer_heads, causal=True,
                compute_dtype=dt))
        self.ln_final = LayerNorm(transformer_width)
        self.text_projection = nn.Parameter(
            torch.empty(transformer_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.init_leaves_()

    @torch.no_grad()
    def init_leaves_(self, generator: Optional[torch.Generator] = None):
        """The JAX model's initializers of its bare parameters (the vision
        tower's are its own): positions normal(0.01), the text projection
        normal(width^-0.5), the logit scale ln(1/0.07)."""
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(
            0.0, self.text_projection.shape[0] ** -0.5, generator=generator)
        self.logit_scale.fill_(math.log(1.0 / 0.07))

    def encode_image(self, image):
        return self.visual(image)

    def encode_text(self, text):
        """text: (B, context_length) int token ids; EOS = the argmax id (the
        highest token)."""
        x = self.token_embedding(text).to(self.dtype)
        x = x + self.positional_embedding.to(x.dtype)
        for i in range(self.transformer_layers):
            x = getattr(self, f"text_block{i}")(x)
        x = self.ln_final(x)
        eos = text.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos]
        return pooled @ self.text_projection.to(pooled.dtype)

    def forward(self, image, text, gather=None):
        """Returns (logits_per_image, logits_per_text), fp32. ``gather``:
        applied to the normalised features of each tower before the logits
        (a trainer's data mesh: the global batch's features, so that the
        logits are global batch x global batch)."""
        img = self.encode_image(image).float()
        txt = self.encode_text(text).float()
        img = img / torch.linalg.vector_norm(img, dim=1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=1, keepdim=True)
        if gather is not None:
            img, txt = gather(img), gather(txt)
        logits_per_image = (self.logit_scale.exp() * img) @ txt.T
        return logits_per_image, logits_per_image.T


def clip_contrastive_loss(logits_per_image):
    """Symmetric InfoNCE over an (N, N) cosine-logit matrix."""
    n = logits_per_image.shape[0]
    labels = torch.arange(n, device=logits_per_image.device)
    li = -F.log_softmax(logits_per_image, dim=1)[labels, labels].mean()
    lt = -F.log_softmax(logits_per_image.T, dim=1)[labels, labels].mean()
    return 0.5 * (li + lt)


def siglip_loss(img_feats, txt_feats, temperature, bias):
    """SigLIP pairwise sigmoid loss (not in the reference, whose
    05_clip/model_siglip.py is a vision tower only)."""
    img = img_feats / torch.linalg.vector_norm(img_feats, dim=1, keepdim=True)
    txt = txt_feats / torch.linalg.vector_norm(txt_feats, dim=1, keepdim=True)
    logits = img @ txt.T * temperature + bias
    n = logits.shape[0]
    signs = 2.0 * torch.eye(n, device=logits.device) - 1.0
    return -F.logsigmoid(signs * logits).mean()
