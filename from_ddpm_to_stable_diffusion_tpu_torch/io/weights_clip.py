"""OpenAI-CLIP ViT-L/14 and SigLIP checkpoint importers, stage 05 (port of
``io/weights_clip.py``).

The reference's stage-05 check runs the pip ``clip`` package's pretrained
ViT-L/14 on a real image (05_clip/01_check.py:8-27); its from-scratch
modules (model_clip_vit.py, model_siglip.py) mirror the OpenAI / HF
checkpoint layouts. This module maps those layouts onto the port's towers
through the rule machinery of :mod:`.weights`, each config sniffed from
tensor shapes:

- :func:`import_openai_clip`: an OpenAI CLIP state dict (the pip ``clip``
  model's ``state_dict()``, or a safetensors export of it) ->
  ``models.clip.CLIP``'s ``state_dict`` and its arguments. OpenAI's
  ``in_proj_weight`` / ``in_proj_bias`` names are normalised to dotted form
  first (the rename the reference's ``make_compatible`` applies to the SD1
  CLIP, model_loader.py:7-32).
- :func:`import_siglip_vision`: an HF SigLIP checkpoint (``vision_model.*``
  keys) -> ``models.siglip.SiglipVisionModel``.
"""

from __future__ import annotations

from typing import Dict

import torch

from .weights import (Rules, _dense, _norm, _prefix, _self_attn, apply_rules,
                      load_safetensors_dict, load_torch_state_dict, t_conv,
                      t_none)
from .weights_sd3 import fuse_qkv


def _load_state(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return load_safetensors_dict(path)
    return load_torch_state_dict(path)


# --------------------------------------------------------------------------
# OpenAI CLIP (pip `clip` ViT-L/14 class)
# --------------------------------------------------------------------------
def normalize_openai_attn(state: Dict[str, torch.Tensor]):
    """in_proj_weight -> in_proj.weight (make_compatible's rename)."""
    for key in list(state):
        if key.endswith("in_proj_weight") or key.endswith("in_proj_bias"):
            state[key.replace("in_proj_", "in_proj.")] = state.pop(key)


def _resblock_rules(torch_p: str, flax_p: str) -> Rules:
    r: Rules = []
    r += _prefix(_norm("ln1"), f"{torch_p}.ln_1", flax_p)
    r += _self_attn(f"{torch_p}.attn", f"{flax_p}/attn", qkv_bias=True)
    r += _prefix(_norm("ln2"), f"{torch_p}.ln_2", flax_p)
    r += _prefix(_dense("fc"), f"{torch_p}.mlp.c_fc", flax_p)
    r += _prefix(_dense("proj"), f"{torch_p}.mlp.c_proj", flax_p)
    return r


def openai_clip_rules(vision_layers: int = 24,
                      text_layers: int = 12) -> Rules:
    """After :func:`normalize_openai_attn`."""
    r: Rules = [
        ("visual.conv1.weight", "visual/conv1/kernel", t_conv),
        ("visual.class_embedding", "visual/class_embedding", t_none),
        ("visual.positional_embedding", "visual/positional_embedding",
         t_none),
        # both sides apply x @ proj: no transpose (model_clip_vit.py:100)
        ("visual.proj", "visual/proj", t_none),
    ]
    r += _prefix(_norm("ln_pre"), "visual.ln_pre", "visual")
    for i in range(vision_layers):
        r += _resblock_rules(f"visual.transformer.resblocks.{i}",
                             f"visual/block{i}")
    r += _prefix(_norm("ln_post"), "visual.ln_post", "visual")

    r += [
        ("token_embedding.weight", "token_embedding/embedding", t_none),
        ("positional_embedding", "positional_embedding", t_none),
        ("text_projection", "text_projection", t_none),
        ("logit_scale", "logit_scale", t_none),
    ]
    for i in range(text_layers):
        r += _resblock_rules(f"transformer.resblocks.{i}", f"text_block{i}")
    r += _prefix(_norm("ln_final"), "ln_final", "")
    return r


def sniff_clip_config(state: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """``CLIP`` arguments from checkpoint shapes (sd3_infer.py:85-105
    idiom)."""
    vision_width, _, patch, _ = state["visual.conv1.weight"].shape
    grid_plus_1 = state["visual.positional_embedding"].shape[0]
    image_resolution = int(round((grid_plus_1 - 1) ** 0.5)) * patch
    vision_layers = 1 + max(
        int(k.split(".")[3]) for k in state
        if k.startswith("visual.transformer.resblocks."))
    text_layers = 1 + max(
        int(k.split(".")[2]) for k in state
        if k.startswith("transformer.resblocks."))
    vocab_size, transformer_width = state["token_embedding.weight"].shape
    return dict(
        embed_dim=state["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=patch,
        context_length=state["positional_embedding"].shape[0],
        vocab_size=vocab_size,
        transformer_width=transformer_width,
        transformer_heads=max(1, transformer_width // 64),
        transformer_layers=text_layers,
    )


def import_openai_clip(path: str):
    """Returns (``state_dict``, ``CLIP`` arguments)."""
    state = _load_state(path)
    # TorchScript archives carry scalar metadata tensors build_model deletes
    for meta in ("input_resolution", "context_length", "vocab_size"):
        state.pop(meta, None)
    normalize_openai_attn(state)
    cfg = sniff_clip_config(state)
    rules = openai_clip_rules(cfg["vision_layers"],
                              cfg["transformer_layers"])
    return apply_rules(state, rules), cfg


# --------------------------------------------------------------------------
# SigLIP vision tower (HF layout)
# --------------------------------------------------------------------------
def fuse_siglip_attn(state: Dict[str, torch.Tensor], num_layers: int,
                     prefix: str = "vision_model.encoder.layers"):
    for i in range(num_layers):
        p = f"{prefix}.{i}.self_attn"
        fuse_qkv(state, f"{p}.q_proj", f"{p}.k_proj", f"{p}.v_proj",
                 f"{p}.in_proj")


def siglip_vision_rules(num_layers: int = 12) -> Rules:
    """After :func:`fuse_siglip_attn`. Torch prefix ``vision_model.``."""
    r: Rules = []
    r += [("vision_model.embeddings.patch_embedding.weight",
           "patch_embedding/kernel", t_conv),
          ("vision_model.embeddings.patch_embedding.bias",
           "patch_embedding/bias", t_none),
          ("vision_model.embeddings.position_embedding.weight",
           "position_embedding", t_none)]
    for i in range(num_layers):
        p = f"vision_model.encoder.layers.{i}"
        f = f"layer{i}"
        r += _prefix(_norm("ln1"), f"{p}.layer_norm1", f)
        r += _self_attn(f"{p}.self_attn", f"{f}/attn", qkv_bias=True)
        r += _prefix(_norm("ln2"), f"{p}.layer_norm2", f)
        r += _prefix(_dense("fc1"), f"{p}.mlp.fc1", f)
        r += _prefix(_dense("fc2"), f"{p}.mlp.fc2", f)
    r += _prefix(_norm("post_ln"), "vision_model.post_layernorm", "")
    return r


def sniff_siglip_config(state: Dict[str, torch.Tensor]):
    """SiglipVisionConfig kwargs from checkpoint shapes."""
    hidden, _, patch, _ = state[
        "vision_model.embeddings.patch_embedding.weight"].shape
    n_pos = state[
        "vision_model.embeddings.position_embedding.weight"].shape[0]
    image_size = int(round(n_pos ** 0.5)) * patch
    layers = 1 + max(int(k.split(".")[3]) for k in state
                     if k.startswith("vision_model.encoder.layers."))
    inter = state["vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0]
    return dict(hidden_size=hidden, intermediate_size=inter,
                num_hidden_layers=layers,
                num_attention_heads=max(1, hidden // 64),
                image_size=image_size, patch_size=patch)


def import_siglip_vision(path: str):
    """Returns (``state_dict``, SiglipVisionConfig kwargs).

    The HF checkpoint's attention-pooling ``head`` (and any text tower) is
    ignored: the reference's SigLIP is vision-only (model_siglip.py:235).
    """
    state = _load_state(path)
    state = {k: v for k, v in state.items()
             if k.startswith("vision_model.")
             and not k.startswith("vision_model.head.")}
    cfg = sniff_siglip_config(state)
    fuse_siglip_attn(state, cfg["num_hidden_layers"])
    return apply_rules(state, siglip_vision_rules(cfg["num_hidden_layers"]),
                       strict=True), cfg
