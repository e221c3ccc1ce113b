"""SigLIP vision checkpoint importer (port of the SigLIP half of
``io/weights_clip.py``).

The reference's from-scratch SigLIP (model_siglip.py) mirrors the HF
checkpoint layout (``vision_model.*`` keys); :func:`import_siglip_vision`
maps it onto ``models.siglip.SiglipVisionModel`` through the rule machinery
of :mod:`.weights`, the tower's config sniffed from tensor shapes.

Not ported: ``import_openai_clip`` and its rules (queue A6 of ROADMAP.md),
which wait for a port of ``models/clip.py`` to load into.
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
