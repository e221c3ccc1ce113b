"""TinyVLM: the trainable vision-language model (port of
``models/tiny_vlm.py``).

A SigLIP vision tower (:mod:`.siglip`) feeds projected patch tokens as a
prefix into a small causal transformer decoder; trained with next-token
cross entropy on captioned shapes, it captions an image by greedy decoding.
One causal attention runs over [image prefix | text] in every decoder block;
on the card, with at least 512 tokens, it takes the causal form of the flash
kernels. With a ``compute_dtype`` the parameters stay as stored and the
linears, the embedding and the residual stream run in that dtype; the
logits come from an fp32 head over fp32 activations.

Greedy decoding is a host loop over fixed-shape forwards: every step runs
the same (N + L)-token forward and writes the arg-max of position t into
slot t + 1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, Linear, SelfAttention
from .siglip import SiglipVisionConfig, SiglipVisionModel

TINY_VISION = SiglipVisionConfig(hidden_size=128, intermediate_size=256,
                                 num_hidden_layers=4, num_attention_heads=4,
                                 image_size=64, patch_size=8)


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ln1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, qkv_bias=True, causal=True,
                                  compute_dtype=compute_dtype)
        self.ln2 = LayerNorm(dim)
        self.fc1 = Linear(dim, 4 * dim, compute_dtype=compute_dtype)
        self.fc2 = Linear(4 * dim, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class TinyVLM(nn.Module):
    """images (B, S, S, 3) in [-1, 1] and tokens (B, L) -> text-position
    logits (B, L, vocab) in fp32: position t predicts token t + 1, and all
    positions attend to the whole image prefix. ``image_size`` sizes the
    tower's position table (default: ``vision_cfg.image_size``)."""

    def __init__(self, vocab_size: int, dim: int = 128, depth: int = 4,
                 num_heads: int = 4, max_text_len: int = 8,
                 vision_cfg: SiglipVisionConfig = TINY_VISION,
                 image_size: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.vocab_size, self.dim, self.depth = vocab_size, dim, depth
        self.max_text_len = max_text_len
        self.compute_dtype = compute_dtype
        self.vision = SiglipVisionModel(vision_cfg, image_size, compute_dtype)
        self.v_proj = Linear(vision_cfg.hidden_size, dim,
                             compute_dtype=compute_dtype)
        self.tok = nn.Embedding(vocab_size, dim)
        self.text_pos = nn.Parameter(torch.zeros(max_text_len, dim))
        for i in range(depth):
            self.add_module(f"block{i}",
                            DecoderBlock(dim, num_heads, compute_dtype))
        self.ln_f = LayerNorm(dim)
        self.head = Linear(dim, vocab_size)

    def forward(self, images, tokens):
        v = self.v_proj(self.vision(images))
        t = self.tok(tokens)
        if self.compute_dtype is not None:
            t = t.to(self.compute_dtype)
        t = t + self.text_pos[: t.shape[1]].to(t.dtype)
        h = torch.cat([v, t], dim=1)
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h)
        h = self.ln_f(h[:, v.shape[1]:])
        return F.linear(h.float(), self.head.weight.float(),
                        self.head.bias.float())


def as_tensor_on(x, device, dtype=None):
    """An array or a tensor as a tensor on ``device`` (in ``dtype``)."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device)


def vlm_loss(logits, tokens, pad_id: int = 0, answer_start: int = 0):
    """Next-token cross entropy over the targets that are not padding.
    ``answer_start``: the token index where supervised text begins (the
    question / answer boundary of VQA); targets before it are masked."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1]
    mask = (targets != pad_id).float()
    if answer_start > 1:
        pos = torch.arange(targets.shape[1], device=targets.device)
        mask = mask * (pos >= answer_start - 1).float()[None]
    ll = F.log_softmax(logits.float(), dim=-1)
    nll = -ll.gather(-1, targets[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


@torch.no_grad()
def greedy_decode(model: TinyVLM, images, bos_id: int = 1, max_len: int = 8,
                  prompt_ids=None):
    """Greedy generation: (B, max_len) int32 token ids on the model's
    device. ``images`` is an array or tensor (B, S, S, 3). ``prompt_ids``
    (B, P) or (P,): a fixed prefix (BOS + question for VQA); decoding fills
    slots P .. max_len - 1."""
    dev = next(model.parameters()).device
    images = as_tensor_on(images, dev, torch.float32)
    b = images.shape[0]
    tokens = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
    tokens[:, 0] = bos_id
    start = 0
    if prompt_ids is not None:
        prompt_ids = as_tensor_on(prompt_ids, dev, torch.int32)
        if prompt_ids.dim() == 1:
            prompt_ids = prompt_ids[None].expand(b, -1)
        start = prompt_ids.shape[1] - 1
        tokens[:, : prompt_ids.shape[1]] = prompt_ids
    was_training = model.training
    model.eval()
    for t in range(start, max_len - 1):
        logits = model(images, tokens)
        tokens[:, t + 1] = logits[:, t].argmax(dim=-1).to(torch.int32)
    model.train(was_training)
    return tokens
