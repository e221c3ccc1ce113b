"""Checkpoint readers: the reference's .pt / .safetensors files -> this
package's ``state_dict``s (port of ``io/weights.py``).

The rule tables are the JAX package's, line for line: each rule maps a
checkpoint key to a Flax parameter path through a layout converter. The
port's modules are named after the Flax paths, so a path names a port
parameter through ``io/from_jax.py``'s renames (``kernel`` / ``scale`` /
``embedding`` -> ``weight``). The converters keep their JAX meaning (torch
layout -> Flax layout) as views, and :func:`apply_rules` turns a Flax
``kernel`` back to the torch layout as ``state_dict_from_jax`` does; so a
conv or linear weight reaches the port in the file's own layout, with no
copy. A leaf that is not a kernel keeps the Flax layout, as in the JAX tree
(CLIP's ``text_projection``, read through ``t_dense``, is (I, O)).

Tensors keep the file's dtype, as views of the file (``torch.load(mmap=
True)``, or an ``mmap`` of a .safetensors file). ``io/from_jax.py::
load_state_checked`` converts each once into a module's fp32 parameter
(exact from fp16 and bf16), and the bundles' inference cast then rounds
once to bf16, from the file's own value.

Not ported: ``t_conv_transpose`` (no rule uses it); the JAX package's g++
mmap reader (``io/native.py``) and its fallback to the ``safetensors``
package: here one reader parses the format itself.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from .from_jax import _RENAMES

Rules = List[Tuple[str, str, Callable]]


# --------------------------------------------------------------------------
# File readers
# --------------------------------------------------------------------------
def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a .pt checkpoint into {key: tensor} (memory-mapped, in the
    file's dtypes); a ``state_dict`` entry is unwrapped and anything that is
    not a tensor dropped."""
    state = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


_ST_DTYPE_NAMES = {
    "float64": "F64", "float32": "F32", "float16": "F16",
    "bfloat16": "BF16", "int64": "I64", "int32": "I32", "int16": "I16",
    "int8": "I8", "uint8": "U8", "bool": "BOOL",
}
_ST_DTYPES = {st: getattr(torch, name) for name, st in _ST_DTYPE_NAMES.items()}


def load_safetensors_dict(path: str,
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """Read a .safetensors file into {key: tensor}, optionally filtered and
    stripped by ``prefix``.

    The format: an 8-byte little-endian header length, a JSON header of
    {key: {dtype, shape, data_offsets}} (``__metadata__`` skipped), then the
    data, offsets counted from the header's end. The file is mapped once
    (copy-on-write) and each tensor is a view of its bytes; one whose start
    is not aligned to its element size is copied out. Unknown dtypes and
    ranges that overrun the file or disagree with the shape raise
    ``ValueError``."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, no safetensors header")
        (n,) = struct.unpack("<Q", f.read(8))
        if n > size - 8:
            raise ValueError(f"{path}: header of {n} bytes overruns the file "
                             f"({size} bytes)")
        header = json.loads(f.read(n))
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    data = torch.frombuffer(mapped, dtype=torch.uint8)
    base, room = 8 + n, size - 8 - n
    out = {}
    for key, info in header.items():
        if key == "__metadata__" or (prefix and not key.startswith(prefix)):
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{key}: unknown safetensors dtype "
                             f"{info['dtype']!r}")
        shape = [int(s) for s in info["shape"]]
        start, end = (int(o) for o in info["data_offsets"])
        nbytes = math.prod(shape) * dtype.itemsize
        if not 0 <= start <= end <= room or end - start != nbytes:
            raise ValueError(
                f"{key}: bytes [{start}, {end}) of a {room}-byte data "
                f"section for {info['dtype']} {shape} ({nbytes} bytes)")
        raw = data[base + start:base + end]
        if (base + start) % dtype.itemsize:
            raw = raw.clone()
        out[key[len(prefix):]] = raw.view(dtype).reshape(shape)
    return out


def save_safetensors_dict(tensors: Mapping[str, torch.Tensor], path: str,
                          metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {key: tensor} as a .safetensors file, keys sorted, header
    padded with spaces to 8 bytes. Tensors may lie on any device: each is
    copied to the host and written in turn, so the file is never whole in
    host memory."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    keys = sorted(tensors)
    offset = 0
    for k in keys:
        t = tensors[k]
        name = _ST_DTYPE_NAMES.get(str(t.dtype).removeprefix("torch."))
        if name is None:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors "
                             "encoding")
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": name, "shape": list(t.shape),
                     "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hj = json.dumps(header, separators=(",", ":")).encode()
    hj += b" " * ((8 - len(hj) % 8) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for k in keys:
            t = tensors[k].detach().to("cpu").contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy())


# --------------------------------------------------------------------------
# Tensor layout converters (torch -> Flax, as views)
# --------------------------------------------------------------------------
def t_conv(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)


def t_dense(w: torch.Tensor) -> torch.Tensor:
    return w.t()


def t_none(w: torch.Tensor) -> torch.Tensor:
    return w


# --------------------------------------------------------------------------
# Declarative mapping
# --------------------------------------------------------------------------
# Each rule: torch sub-key -> (flax sub-path, converter). 'W'/'B' denote
# torch 'weight'/'bias'.
def _norm(flax: str) -> Rules:
    return [("weight", f"{flax}/scale", t_none), ("bias", f"{flax}/bias", t_none)]


def _conv(flax: str) -> Rules:
    return [("weight", f"{flax}/kernel", t_conv), ("bias", f"{flax}/bias", t_none)]


def _dense(flax: str) -> Rules:
    return [("weight", f"{flax}/kernel", t_dense), ("bias", f"{flax}/bias", t_none)]


def _dense_nobias(flax: str) -> Rules:
    return [("weight", f"{flax}/kernel", t_dense)]


def _self_attn(torch_p: str, flax_p: str, qkv_bias: bool) -> Rules:
    rules = [(f"{torch_p}.in_proj.weight", f"{flax_p}/qkv/kernel", t_dense),
             (f"{torch_p}.out_proj.weight", f"{flax_p}/out/kernel", t_dense),
             (f"{torch_p}.out_proj.bias", f"{flax_p}/out/bias", t_none)]
    if qkv_bias:
        rules.append((f"{torch_p}.in_proj.bias", f"{flax_p}/qkv/bias", t_none))
    return rules


def _cross_attn(torch_p: str, flax_p: str) -> Rules:
    return [(f"{torch_p}.q_proj.weight", f"{flax_p}/q/kernel", t_dense),
            (f"{torch_p}.k_proj.weight", f"{flax_p}/k/kernel", t_dense),
            (f"{torch_p}.v_proj.weight", f"{flax_p}/v/kernel", t_dense),
            (f"{torch_p}.out_proj.weight", f"{flax_p}/out/kernel", t_dense),
            (f"{torch_p}.out_proj.bias", f"{flax_p}/out/bias", t_none)]


def _prefix(rules: Rules, torch_p: str, flax_p: str) -> Rules:
    return [(f"{torch_p}.{t}" if t else torch_p,
             f"{flax_p}/{f}" if f else flax_p, c) for t, f, c in rules]


def _unet_res(torch_p: str, flax_p: str) -> Rules:
    """SD1 UNet ResidualBlock (diffusion.py:20-50) field map."""
    out = []
    out += _prefix(_norm("norm1"), f"{torch_p}.groupnorm_feature", flax_p)
    out += _prefix(_conv("conv1"), f"{torch_p}.conv_feature", flax_p)
    out += _prefix(_dense("time_proj"), f"{torch_p}.linear_time", flax_p)
    out += _prefix(_norm("norm2"), f"{torch_p}.groupnorm_merged", flax_p)
    out += _prefix(_conv("conv2"), f"{torch_p}.conv_merged", flax_p)
    out += _prefix(_conv("skip"), f"{torch_p}.residual_layer", flax_p)
    return out


def _unet_att(torch_p: str, flax_p: str) -> Rules:
    """SD1 UNet AttentionBlock (diffusion.py:54-103) field map."""
    out = []
    out += _prefix(_norm("norm_in"), f"{torch_p}.groupnorm", flax_p)
    out += _prefix(_conv("proj_in"), f"{torch_p}.conv_input", flax_p)
    out += _prefix(_norm("norm1"), f"{torch_p}.layernorm_1", flax_p)
    out += _self_attn(f"{torch_p}.attention_1", f"{flax_p}/attn1",
                      qkv_bias=False)
    out += _prefix(_norm("norm2"), f"{torch_p}.layernorm_2", flax_p)
    out += _cross_attn(f"{torch_p}.attention_2", f"{flax_p}/attn2")
    out += _prefix(_norm("norm3"), f"{torch_p}.layernorm_3", flax_p)
    out += _prefix(_dense("geglu_in"), f"{torch_p}.linear_geglu_1", flax_p)
    out += _prefix(_dense("geglu_out"), f"{torch_p}.linear_geglu_2", flax_p)
    out += _prefix(_conv("proj_out"), f"{torch_p}.conv_output", flax_p)
    return out


def _vae_res(torch_p: str, flax_p: str) -> Rules:
    out = []
    out += _prefix(_norm("norm1"), f"{torch_p}.groupnorm_1", flax_p)
    out += _prefix(_conv("conv1"), f"{torch_p}.conv_1", flax_p)
    out += _prefix(_norm("norm2"), f"{torch_p}.groupnorm_2", flax_p)
    out += _prefix(_conv("conv2"), f"{torch_p}.conv_2", flax_p)
    out += _prefix(_conv("skip"), f"{torch_p}.residual_layer", flax_p)
    return out


def _vae_att(torch_p: str, flax_p: str) -> Rules:
    out = _prefix(_norm("norm"), f"{torch_p}.groupnorm", flax_p)
    out += _self_attn(f"{torch_p}.attention", f"{flax_p}/attn", qkv_bias=True)
    return out


def sd1_clip_rules() -> Rules:
    rules = [("embedding.token_embedding.weight",
              "token_embedding/embedding", t_none),
             ("embedding.position_value", "position_value", t_none)]
    for i in range(12):
        p, f = f"layers.{i}", f"layer{i}"
        rules += _prefix(_norm("ln1"), f"{p}.layernorm_1", f)
        rules += _self_attn(f"{p}.attention", f"{f}/attn", qkv_bias=True)
        rules += _prefix(_norm("ln2"), f"{p}.layernorm_2", f)
        rules += _prefix(_dense("fc1"), f"{p}.linear_1", f)
        rules += _prefix(_dense("fc2"), f"{p}.linear_2", f)
    rules += _prefix(_norm("ln_final"), "layernorm", "")
    return rules


def sd1_unet_rules() -> Rules:
    """Maps the reference Diffusion state dict (time_embedding/unet/final)."""
    r: Rules = []
    r += _prefix(_dense("time_fc1"), "time_embedding.linear_1", "")
    r += _prefix(_dense("time_fc2"), "time_embedding.linear_2", "")
    # encoders: (torch index, stage kind) per diffusion.py:133-146
    enc = [("0.0", "conv", "enc0_conv"), ("1.0", "res", "enc1_res"),
           ("1.1", "att", "enc1_att"), ("2.0", "res", "enc2_res"),
           ("2.1", "att", "enc2_att"), ("3.0", "conv", "enc3_down"),
           ("4.0", "res", "enc4_res"), ("4.1", "att", "enc4_att"),
           ("5.0", "res", "enc5_res"), ("5.1", "att", "enc5_att"),
           ("6.0", "conv", "enc6_down"), ("7.0", "res", "enc7_res"),
           ("7.1", "att", "enc7_att"), ("8.0", "res", "enc8_res"),
           ("8.1", "att", "enc8_att"), ("9.0", "conv", "enc9_down"),
           ("10.0", "res", "enc10_res"), ("11.0", "res", "enc11_res")]
    for idx, kind, name in enc:
        p = f"unet.encoders.{idx}"
        if kind == "conv":
            r += _prefix(_conv(name), p, "")
        elif kind == "res":
            r += _unet_res(p, name)
        else:
            r += _unet_att(p, name)
    mid = [("0", "res", "mid_res1"), ("1", "att", "mid_att"),
           ("2", "res", "mid_res2")]
    for idx, kind, name in mid:
        p = f"unet.bottleneck.{idx}"
        r += _unet_res(p, name) if kind == "res" else _unet_att(p, name)
    # decoders per diffusion.py:152-165 (upsample = .conv inside Upsample)
    dec = [("0.0", "res", "dec0_res"), ("1.0", "res", "dec1_res"),
           ("2.0", "res", "dec2_res"), ("2.1", "up", "dec2_up"),
           ("3.0", "res", "dec3_res"), ("3.1", "att", "dec3_att"),
           ("4.0", "res", "dec4_res"), ("4.1", "att", "dec4_att"),
           ("5.0", "res", "dec5_res"), ("5.1", "att", "dec5_att"),
           ("5.2", "up", "dec5_up"), ("6.0", "res", "dec6_res"),
           ("6.1", "att", "dec6_att"), ("7.0", "res", "dec7_res"),
           ("7.1", "att", "dec7_att"), ("8.0", "res", "dec8_res"),
           ("8.1", "att", "dec8_att"), ("8.2", "up", "dec8_up"),
           ("9.0", "res", "dec9_res"), ("9.1", "att", "dec9_att"),
           ("10.0", "res", "dec10_res"), ("10.1", "att", "dec10_att"),
           ("11.0", "res", "dec11_res"), ("11.1", "att", "dec11_att")]
    for idx, kind, name in dec:
        p = f"unet.decoders.{idx}"
        if kind == "res":
            r += _unet_res(p, name)
        elif kind == "att":
            r += _unet_att(p, name)
        else:
            r += _prefix(_conv("conv"), f"{p}.conv", name)
    r += _prefix(_norm("final_norm"), "final.groupnorm", "")
    r += _prefix(_conv("final_conv"), "final.conv", "")
    return r


def sd1_vae_encoder_rules() -> Rules:
    seq = [("0", "conv", "conv_in"), ("1", "res", "res0"), ("2", "res", "res1"),
           ("3", "conv", "down0"), ("4", "res", "res2"), ("5", "res", "res3"),
           ("6", "conv", "down1"), ("7", "res", "res4"), ("8", "res", "res5"),
           ("9", "conv", "down2"), ("10", "res", "res6"), ("11", "res", "res7"),
           ("12", "res", "res8"), ("13", "att", "mid_attn"),
           ("14", "res", "res9"), ("15", "norm", "norm_out"),
           ("17", "conv", "conv_out"), ("18", "conv", "conv_quant")]
    return _sequential_rules(seq)


def sd1_vae_decoder_rules() -> Rules:
    seq = [("0", "conv", "conv_in1"), ("1", "conv", "conv_in2"),
           ("2", "res", "res0"), ("3", "att", "mid_attn"),
           ("4", "res", "res1"), ("5", "res", "res2"), ("6", "res", "res3"),
           ("7", "res", "res4"), ("9", "conv", "up0_conv"),
           ("10", "res", "res5"), ("11", "res", "res6"), ("12", "res", "res7"),
           ("14", "conv", "up1_conv"), ("15", "res", "res8"),
           ("16", "res", "res9"), ("17", "res", "res10"),
           ("19", "conv", "up2_conv"), ("20", "res", "res11"),
           ("21", "res", "res12"), ("22", "res", "res13"),
           ("23", "norm", "norm_out"), ("25", "conv", "conv_out")]
    return _sequential_rules(seq)


def _sequential_rules(seq) -> Rules:
    r: Rules = []
    for idx, kind, name in seq:
        if kind == "conv":
            r += _prefix(_conv(name), idx, "")
        elif kind == "norm":
            r += _prefix(_norm(name), idx, "")
        elif kind == "res":
            r += _vae_res(idx, name)
        else:
            r += _vae_att(idx, name)
    return r


# --------------------------------------------------------------------------
# SDXL-VAE (diffusers AutoencoderKL): the SD1 VAE's architecture under
# another key layout (03_variational_autoencoder/01_check.py:20-41,
# 06_.../03_train_with_vae.py:69).
# --------------------------------------------------------------------------
def _diffusers_vae_res(torch_p: str, flax_p: str) -> Rules:
    out = []
    out += _prefix(_norm("norm1"), f"{torch_p}.norm1", flax_p)
    out += _prefix(_conv("conv1"), f"{torch_p}.conv1", flax_p)
    out += _prefix(_norm("norm2"), f"{torch_p}.norm2", flax_p)
    out += _prefix(_conv("conv2"), f"{torch_p}.conv2", flax_p)
    out += _prefix(_conv("skip"), f"{torch_p}.conv_shortcut", flax_p)
    return out


def _diffusers_vae_att(torch_p: str, flax_p: str) -> Rules:
    """to_q/to_k/to_v are fused by fuse_diffusers_vae_attn first."""
    return (_prefix(_norm("norm"), f"{torch_p}.group_norm", flax_p)
            + [(f"{torch_p}.qkv_fused.weight", f"{flax_p}/attn/qkv/kernel",
                t_dense),
               (f"{torch_p}.qkv_fused.bias", f"{flax_p}/attn/qkv/bias",
                t_none),
               (f"{torch_p}.to_out.0.weight", f"{flax_p}/attn/out/kernel",
                t_dense),
               (f"{torch_p}.to_out.0.bias", f"{flax_p}/attn/out/bias",
                t_none)])


def fuse_diffusers_vae_attn(state: Dict[str, torch.Tensor],
                            prefix: str) -> None:
    """Concat diffusers' separate to_q/to_k/to_v Linears into one fused
    qkv tensor in place (row order q|k|v, the split convention)."""
    for part in ("weight", "bias"):
        qs = [state.pop(f"{prefix}.to_{x}.{part}", None) for x in "qkv"]
        if qs[0] is not None:
            state[f"{prefix}.qkv_fused.{part}"] = torch.cat(qs, dim=0)


def sdxl_vae_encoder_rules() -> Rules:
    r: Rules = []
    r += _prefix(_conv("conv_in"), "encoder.conv_in", "")
    for level in range(4):
        for block in range(2):
            r += _diffusers_vae_res(
                f"encoder.down_blocks.{level}.resnets.{block}",
                f"res{2 * level + block}")
        if level < 3:
            r += _prefix(_conv(f"down{level}"),
                         f"encoder.down_blocks.{level}.downsamplers.0.conv",
                         "")
    r += _diffusers_vae_res("encoder.mid_block.resnets.0", "res8")
    r += _diffusers_vae_att("encoder.mid_block.attentions.0", "mid_attn")
    r += _diffusers_vae_res("encoder.mid_block.resnets.1", "res9")
    r += _prefix(_norm("norm_out"), "encoder.conv_norm_out", "")
    r += _prefix(_conv("conv_out"), "encoder.conv_out", "")
    r += _prefix(_conv("conv_quant"), "quant_conv", "")
    return r


def sdxl_vae_decoder_rules() -> Rules:
    r: Rules = []
    r += _prefix(_conv("conv_in1"), "post_quant_conv", "")
    r += _prefix(_conv("conv_in2"), "decoder.conv_in", "")
    r += _diffusers_vae_res("decoder.mid_block.resnets.0", "res0")
    r += _diffusers_vae_att("decoder.mid_block.attentions.0", "mid_attn")
    r += _diffusers_vae_res("decoder.mid_block.resnets.1", "res1")
    for level in range(4):
        for block in range(3):
            r += _diffusers_vae_res(
                f"decoder.up_blocks.{level}.resnets.{block}",
                f"res{2 + 3 * level + block}")
        if level < 3:
            r += _prefix(_conv(f"up{level}_conv"),
                         f"decoder.up_blocks.{level}.upsamplers.0.conv", "")
    r += _prefix(_norm("norm_out"), "decoder.conv_norm_out", "")
    r += _prefix(_conv("conv_out"), "decoder.conv_out", "")
    return r


def import_sdxl_vae(path: str):
    """A diffusers AutoencoderKL .safetensors (e.g. sdxl-vae) as the
    (``VAEEncoder``, ``VAEDecoder``) ``state_dict`` pair of ``models.sd1``.

    Scaling note: this module pair applies the SD1 latent scale 0.18215 on
    both sides (it cancels on encode→decode roundtrips); diffusers applies
    the SDXL factor 0.13025 externally. Latent-space consumers that need
    diffusers-exact latents must rescale by 0.13025/0.18215.
    """
    state = load_safetensors_dict(path)
    fuse_diffusers_vae_attn(state, "encoder.mid_block.attentions.0")
    fuse_diffusers_vae_attn(state, "decoder.mid_block.attentions.0")
    enc_keys = {k: v for k, v in state.items()
                if k.startswith(("encoder.", "quant_conv."))}
    dec_keys = {k: v for k, v in state.items()
                if k.startswith(("decoder.", "post_quant_conv."))}
    enc = apply_rules(enc_keys, sdxl_vae_encoder_rules())
    dec = apply_rules(dec_keys, sdxl_vae_decoder_rules())
    return enc, dec


# --------------------------------------------------------------------------
# Application
# --------------------------------------------------------------------------
def make_compatible(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Key renames of model_loader.make_compatible (model_loader.py:7-32)."""
    out = {}
    for k, v in state.items():
        k = k.replace("_proj_weight", "_proj.weight")
        k = k.replace("_proj_bias", "_proj.bias")
        out[k] = v
    return out


def port_key(flax_path: str) -> str:
    """The port parameter a Flax path names: 'a/b/kernel' -> 'a.b.weight'."""
    *path, leaf = [p for p in flax_path.split("/") if p]
    return ".".join(path + [_RENAMES.get(leaf, leaf)])


def apply_rules(state: Dict[str, torch.Tensor], rules: Rules,
                strict: bool = True) -> Dict[str, torch.Tensor]:
    """Build a port ``state_dict`` from a flat checkpoint state dict. A
    missing skip-projection key is optional; otherwise ``strict`` raises on a
    missing key and on a key no rule maps, and ``strict=False`` ignores
    both."""
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for torch_key, flax_path, conv in rules:
        if torch_key not in state:
            # optional keys: skip-projection convs absent when in==out ch
            if flax_path.endswith(("skip/kernel", "skip/bias")):
                continue
            if strict:
                raise KeyError(f"checkpoint missing key {torch_key!r}")
            continue
        used.add(torch_key)
        value = conv(state[torch_key])
        if flax_path.rsplit("/", 1)[-1] == "kernel":   # back to torch layout
            if value.dim() == 4:
                value = value.permute(3, 2, 0, 1)
            elif value.dim() == 2:
                value = value.t()
            else:
                raise ValueError(f"{flax_path}: {value.dim()}-D kernel")
        out[port_key(flax_path)] = value
    if strict:
        leftover = set(state) - used
        if leftover:
            raise KeyError(f"unmapped checkpoint keys: {sorted(leftover)[:8]}"
                           f" (+{max(0, len(leftover) - 8)} more)")
    return out


def import_sd1_clip(path: str) -> Dict[str, torch.Tensor]:
    return apply_rules(make_compatible(load_torch_state_dict(path)),
                       sd1_clip_rules())


def import_sd1_unet(path: str) -> Dict[str, torch.Tensor]:
    return apply_rules(make_compatible(load_torch_state_dict(path)),
                       sd1_unet_rules())


def import_sd1_vae_encoder(path: str) -> Dict[str, torch.Tensor]:
    return apply_rules(make_compatible(load_torch_state_dict(path)),
                       sd1_vae_encoder_rules())


def import_sd1_vae_decoder(path: str) -> Dict[str, torch.Tensor]:
    return apply_rules(make_compatible(load_torch_state_dict(path)),
                       sd1_vae_decoder_rules())
