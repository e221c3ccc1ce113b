"""SD3 safetensors -> this package's ``state_dict``s, for the reference's
five model groups (port of ``io/weights_sd3.py``).

Torch key names follow the reference's module attribute paths, which is what
its ``load_into`` attribute-walk loader resolves against
(02_stable_diffusion-3/sd3_infer.py:20-44; modules in mmdit.py and
utils.py). Groups and their checkpoint prefixes:

- MMDiT:      ``model.diffusion_model.``          (sd3 ckpt)
- VAE:        ``first_stage_model.``              (sd3 ckpt)
- CLIP-L:     ``text_encoders.clip_l.transformer.`` (HF CLIPTextModel names)
- CLIP-G:     ``text_encoders.clip_g.transformer.``
- T5-XXL:     ``text_encoders.t5xxl.transformer.``

HF CLIP stores q/k/v as separate projections; the fused-QKV layers import
them via :func:`fuse_qkv` (row-concat in q|k|v order, the split
convention). The SD3 VAE mid-attention uses 1×1 convs for q/k/v/proj_out;
those squeeze to linear weights and fuse the same way. Every importer here
reads with ``strict=False``, as the JAX package does: keys no rule maps
(``position_ids``, ``logit_scale``, T5's ``shared.weight``, ...) are
ignored, and a rule's key missing from the file fails when the state is
loaded into its module.
"""

from __future__ import annotations

from typing import Dict

import torch

from .weights import (Rules, _conv, _dense, _dense_nobias, _norm, _prefix,
                      apply_rules, load_safetensors_dict, t_dense, t_none)


# --------------------------------------------------------------------------
# Fusions (state-dict preprocessing)
# --------------------------------------------------------------------------
def fuse_qkv(state: Dict[str, torch.Tensor], q: str, k: str, v: str,
             out_key: str, is_conv1x1: bool = False):
    """Concat separate q/k/v projections into one in_proj tensor in place."""
    if q + ".weight" not in state:
        return
    ws = [state.pop(p + ".weight") for p in (q, k, v)]
    if is_conv1x1:
        ws = [w[:, :, 0, 0] for w in ws]  # (O, I, 1, 1) -> (O, I)
    state[out_key + ".weight"] = torch.cat(ws, dim=0)
    if q + ".bias" in state:
        bs = [state.pop(p + ".bias") for p in (q, k, v)]
        state[out_key + ".bias"] = torch.cat(bs, dim=0)


def fuse_hf_clip_qkv(state: Dict[str, torch.Tensor], num_layers: int,
                     prefix: str = "text_model.encoder.layers"):
    for i in range(num_layers):
        p = f"{prefix}.{i}.self_attn"
        fuse_qkv(state, f"{p}.q_proj", f"{p}.k_proj", f"{p}.v_proj",
                 f"{p}.in_proj")


# --------------------------------------------------------------------------
# MMDiT
# --------------------------------------------------------------------------
def _dismantled_rules(torch_p: str, flax_p: str, pre_only: bool,
                      qk_norm: bool) -> Rules:
    r: Rules = []
    r += _prefix(_dense("qkv"), f"{torch_p}.attn.qkv", flax_p)
    if qk_norm:
        r += [(f"{torch_p}.attn.ln_q.weight", f"{flax_p}/ln_q/scale", t_none),
              (f"{torch_p}.attn.ln_k.weight", f"{flax_p}/ln_k/scale", t_none)]
    r += _prefix(_dense("adaLN"), f"{torch_p}.adaLN_modulation.1", flax_p)
    if not pre_only:
        r += _prefix(_dense("proj"), f"{torch_p}.attn.proj", flax_p)
        r += _prefix(_dense("mlp_fc1"), f"{torch_p}.mlp.fc1", flax_p)
        r += _prefix(_dense("mlp_fc2"), f"{torch_p}.mlp.fc2", flax_p)
    return r


def sd3_mmdit_rules(depth: int = 24, qk_norm: bool = False,
                    has_y: bool = True, has_context: bool = True) -> Rules:
    r: Rules = []
    r += _prefix(_conv("x_embedder"), "x_embedder.proj", "")
    r += [("pos_embed", "pos_embed", t_none)]
    r += _prefix(_dense("fc1"), "t_embedder.mlp.0", "t_embedder")
    r += _prefix(_dense("fc2"), "t_embedder.mlp.2", "t_embedder")
    if has_y:
        r += _prefix(_dense("fc1"), "y_embedder.mlp.0", "y_embedder")
        r += _prefix(_dense("fc2"), "y_embedder.mlp.2", "y_embedder")
    if has_context:
        r += _prefix(_dense("context_embedder"), "context_embedder", "")
    for i in range(depth):
        pre_only = i == depth - 1
        r += _dismantled_rules(f"joint_blocks.{i}.context_block",
                               f"joint_block{i}/context_block",
                               pre_only, qk_norm)
        r += _dismantled_rules(f"joint_blocks.{i}.x_block",
                               f"joint_block{i}/x_block", False, qk_norm)
    r += _prefix(_dense("final_adaLN"), "final_layer.adaLN_modulation.1", "")
    r += _prefix(_dense("final_linear"), "final_layer.linear", "")
    return r


# --------------------------------------------------------------------------
# CLIP text (HF layout)
# --------------------------------------------------------------------------
def hf_clip_text_rules(num_layers: int) -> Rules:
    """After :func:`fuse_hf_clip_qkv`. Torch prefix 'text_model.'."""
    r: Rules = [
        ("text_model.embeddings.token_embedding.weight",
         "token_embedding/embedding", t_none),
        ("text_model.embeddings.position_embedding.weight",
         "position_embedding", t_none),
    ]
    for i in range(num_layers):
        p = f"text_model.encoder.layers.{i}"
        f = f"layer{i}"
        r += _prefix(_norm("ln1"), f"{p}.layer_norm1", f)
        r += _prefix(_dense("qkv"), f"{p}.self_attn.in_proj", f"{f}/attn")
        r += _prefix(_dense("out"), f"{p}.self_attn.out_proj", f"{f}/attn")
        r += _prefix(_norm("ln2"), f"{p}.layer_norm2", f)
        r += _prefix(_dense("fc1"), f"{p}.mlp.fc1", f)
        r += _prefix(_dense("fc2"), f"{p}.mlp.fc2", f)
    r += _prefix(_norm("ln_final"), "text_model.final_layer_norm", "")
    r += [("text_projection.weight", "text_projection", t_dense)]
    return r


# --------------------------------------------------------------------------
# T5 encoder
# --------------------------------------------------------------------------
def sd3_t5_rules(num_layers: int = 24) -> Rules:
    """Torch prefix 'encoder.' (reference T5Stack attribute paths)."""
    r: Rules = [("encoder.embed_tokens.weight", "embed_tokens/embedding",
                 t_none)]
    for i in range(num_layers):
        p = f"encoder.block.{i}.layer"
        f = f"block{i}"
        r += _prefix(_dense_nobias("q"), f"{p}.0.SelfAttention.q", f"{f}/attn")
        r += _prefix(_dense_nobias("k"), f"{p}.0.SelfAttention.k", f"{f}/attn")
        r += _prefix(_dense_nobias("v"), f"{p}.0.SelfAttention.v", f"{f}/attn")
        r += _prefix(_dense_nobias("o"), f"{p}.0.SelfAttention.o", f"{f}/attn")
        if i == 0:
            r += [(f"{p}.0.SelfAttention.relative_attention_bias.weight",
                   f"{f}/attn/relative_attention_bias", t_none)]
        r += [(f"{p}.0.layer_norm.weight", f"{f}/ln1_scale", t_none)]
        r += _prefix(_dense_nobias("wi_0"), f"{p}.1.DenseReluDense.wi_0", f)
        r += _prefix(_dense_nobias("wi_1"), f"{p}.1.DenseReluDense.wi_1", f)
        r += _prefix(_dense_nobias("wo"), f"{p}.1.DenseReluDense.wo", f)
        r += [(f"{p}.1.layer_norm.weight", f"{f}/ln2_scale", t_none)]
    r += [("encoder.final_layer_norm.weight", "final_ln_scale", t_none)]
    return r


# --------------------------------------------------------------------------
# SD3 VAE
# --------------------------------------------------------------------------
def _sd3_res(torch_p: str, flax_p: str) -> Rules:
    r: Rules = []
    r += _prefix(_norm("norm1"), f"{torch_p}.norm1", flax_p)
    r += _prefix(_conv("conv1"), f"{torch_p}.conv1", flax_p)
    r += _prefix(_norm("norm2"), f"{torch_p}.norm2", flax_p)
    r += _prefix(_conv("conv2"), f"{torch_p}.conv2", flax_p)
    r += _prefix(_conv("skip"), f"{torch_p}.nin_shortcut", flax_p)
    return r


def _sd3_attn(torch_p: str, flax_p: str) -> Rules:
    """AttnBlock with 1×1-conv q/k/v fused by :func:`fuse_sd3_vae_attn`."""
    r: Rules = _prefix(_norm("norm"), f"{torch_p}.norm", flax_p)
    r += _prefix(_dense("qkv"), f"{torch_p}.in_proj", f"{flax_p}/attn")
    r += _prefix(_dense("out"), f"{torch_p}.proj_out_dense", f"{flax_p}/attn")
    return r


def fuse_sd3_vae_attn(state: Dict[str, torch.Tensor], torch_p: str):
    fuse_qkv(state, f"{torch_p}.q", f"{torch_p}.k", f"{torch_p}.v",
             f"{torch_p}.in_proj", is_conv1x1=True)
    w = state.pop(f"{torch_p}.proj_out.weight", None)
    if w is not None:
        state[f"{torch_p}.proj_out_dense.weight"] = w[:, :, 0, 0]
    b = state.pop(f"{torch_p}.proj_out.bias", None)
    if b is not None:
        state[f"{torch_p}.proj_out_dense.bias"] = b


def sd3_vae_encoder_rules(ch_mult=(1, 2, 4, 4), num_res_blocks=2) -> Rules:
    r: Rules = _prefix(_conv("conv_in"), "conv_in", "")
    for l in range(len(ch_mult)):
        for b in range(num_res_blocks):
            r += _sd3_res(f"down.{l}.block.{b}", f"down{l}_block{b}")
        if l != len(ch_mult) - 1:
            r += _prefix(_conv(f"down{l}_downsample"),
                         f"down.{l}.downsample.conv", "")
    r += _sd3_res("mid.block_1", "mid_block1")
    r += _sd3_attn("mid.attn_1", "mid_attn")
    r += _sd3_res("mid.block_2", "mid_block2")
    r += _prefix(_norm("norm_out"), "norm_out", "")
    r += _prefix(_conv("conv_out"), "conv_out", "")
    return r


def sd3_vae_decoder_rules(ch_mult=(1, 2, 4, 4), num_res_blocks=2) -> Rules:
    r: Rules = _prefix(_conv("conv_in"), "conv_in", "")
    r += _sd3_res("mid.block_1", "mid_block1")
    r += _sd3_attn("mid.attn_1", "mid_attn")
    r += _sd3_res("mid.block_2", "mid_block2")
    for l in reversed(range(len(ch_mult))):
        for b in range(num_res_blocks + 1):
            r += _sd3_res(f"up.{l}.block.{b}", f"up{l}_block{b}")
        if l != 0:
            r += _prefix(_conv(f"up{l}_upsample"), f"up.{l}.upsample.conv", "")
    r += _prefix(_norm("norm_out"), "norm_out", "")
    r += _prefix(_conv("conv_out"), "conv_out", "")
    return r


# --------------------------------------------------------------------------
# Top-level importers
# --------------------------------------------------------------------------
def import_sd3_checkpoint(path: str):
    """Read the main sd3 .safetensors: returns (MMDiT, VAE encoder, VAE
    decoder ``state_dict``s, the sniffed ``MMDiTConfig``). The tensors are
    views of the mapped file; nothing is read until they are used. The
    encoder's state is empty for a file without ``first_stage_model.
    encoder.*``."""
    from ..pipelines.sd3 import sniff_mmdit_config

    full = load_safetensors_dict(path)
    cfg = sniff_mmdit_config(full)
    dm = {k[len("model.diffusion_model."):]: v for k, v in full.items()
          if k.startswith("model.diffusion_model.")}
    mmdit = apply_rules(dm, sd3_mmdit_rules(cfg.depth,
                                            qk_norm=cfg.qk_norm is not None),
                        strict=False)
    vae = {k[len("first_stage_model."):]: v for k, v in full.items()
           if k.startswith("first_stage_model.")}
    enc = {k[len("encoder."):]: v for k, v in vae.items()
           if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in vae.items()
           if k.startswith("decoder.")}
    fuse_sd3_vae_attn(enc, "mid.attn_1")
    fuse_sd3_vae_attn(dec, "mid.attn_1")
    vae_enc = apply_rules(enc, sd3_vae_encoder_rules(), strict=False)
    vae_dec = apply_rules(dec, sd3_vae_decoder_rules(), strict=False)
    return mmdit, vae_enc, vae_dec, cfg


def import_clip_text(path: str, num_layers: int, prefix: str = ""):
    """An HF-layout CLIP text model (``prefix=`` selects it inside a file
    that holds more, e.g. ``text_encoders.clip_l.transformer.``)."""
    state = load_safetensors_dict(path, prefix)
    fuse_hf_clip_qkv(state, num_layers)
    return apply_rules(state, hf_clip_text_rules(num_layers), strict=False)


def import_t5(path: str, num_layers: int = 24, prefix: str = ""):
    state = load_safetensors_dict(path, prefix)
    return apply_rules(state, sd3_t5_rules(num_layers), strict=False)
