"""Checkpoint readers, JAX package against the PyTorch port, on the CPU.

Each synthetic checkpoint is written once, from numpy seeds, in the
reference's layout (``torch.save`` for the SD1 .pt files, the
``safetensors`` package for the rest) and in F32, F16 or BF16. It then goes
through a JAX importer, whose Flax tree ``io/from_jax.py::
state_dict_from_jax`` turns into a ``state_dict``, and through the port's
importer: the two must be equal bit for bit (fp16 and bf16 widen to fp32
exactly, so every value is compared as the bits of its fp32 widening).
Widths are small; the SD1 VAEs, which have no width argument, are full.

The bundle entry points (``SD1Models.from_checkpoint_dir``,
``SD3Models.from_checkpoints``) run with the module classes and configs
shrunk in both packages' ``pipelines`` namespaces. Their parameters must
equal, bit for bit and dtype for dtype, the port's ``from_jax`` of the JAX
bundle's tree, in bf16 and in fp32; one fp32 MMDiT forward through both
agrees to rtol 1e-4 / atol 1e-4, the tolerance of
``tests/test_torch_sd3_pipeline.py`` (summation order).
"""

import functools
import importlib.util
import json
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import errors as flax_errors
from flax import traverse_util
from safetensors import safe_open
from safetensors.torch import save_file

from from_ddpm_to_stable_diffusion_tpu.io import weights as JW
from from_ddpm_to_stable_diffusion_tpu.io import weights_clip as JWC
from from_ddpm_to_stable_diffusion_tpu.io import weights_sd3 as JW3
from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.models import sd1 as jsd1
from from_ddpm_to_stable_diffusion_tpu.models import sd3_vae as jvae
from from_ddpm_to_stable_diffusion_tpu.models import siglip as jsig
from from_ddpm_to_stable_diffusion_tpu.models import text_encoders as jte
from from_ddpm_to_stable_diffusion_tpu.pipelines import sd1 as jpipe1
from from_ddpm_to_stable_diffusion_tpu.pipelines import sd3 as jpipe3
from from_ddpm_to_stable_diffusion_tpu_torch.io import weights as TW
from from_ddpm_to_stable_diffusion_tpu_torch.io import weights_clip as TWC
from from_ddpm_to_stable_diffusion_tpu_torch.io import weights_sd3 as TW3
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd1 as tsd1
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd3_vae as tvae
from from_ddpm_to_stable_diffusion_tpu_torch.models import (
    text_encoders as tte)
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd1 as tpipe1
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd3 as tpipe3

REPO = pathlib.Path(__file__).resolve().parents[1]
DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}
CLIP_L = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4)
CLIP_G = dict(vocab_size=64, hidden_size=48, num_layers=2, num_heads=4,
              hidden_act="gelu")
T5 = dict(vocab_size=50, d_model=32, d_ff=64, num_layers=2, num_heads=4)
MMDIT = dict(depth=2, pos_embed_max_size=8, adm_in_channels=32,
             context_dim=48)
SD3_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
SIGLIP = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=1, image_size=32, patch_size=8)


# --------------------------------------------------------------------------
# Synthetic files
# --------------------------------------------------------------------------
def _flax_shapes(model, *args):
    """{flax path: shape} of ``model``'s parameters (traced, not run)."""
    tree = jax.eval_shape(model.init, jax.random.key(0), *args)["params"]
    return {"/".join(k): tuple(v.shape)
            for k, v in traverse_util.flatten_dict(tree).items()}


def _file_state(rules, shapes, dtype, seed):
    """A checkpoint in the torch layout that ``rules`` read into a tree of
    ``shapes`` (the JAX package's rules and converters), values normal from
    a numpy seed with a standard deviation of fan-in^-1/2 for a tensor of
    two dimensions or more (a layer's init scale, which keeps a forward's
    activations in a trained model's range), stored in ``dtype``."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, path, conv in rules:
        path = "/".join(p for p in path.split("/") if p)
        if path not in shapes:
            continue            # an optional skip conv the model lacks
        s = shapes[path]
        if conv is JW.t_conv:
            s = (s[3], s[2], s[0], s[1])
        elif conv is JW.t_dense:
            s = (s[1], s[0])
        a = rng.standard_normal(s, dtype=np.float32)
        if a.ndim >= 2:
            a *= np.float32((a.size // s[0]) ** -0.5)
        state[key] = torch.from_numpy(a).to(DTYPES[dtype])
    return state


def _split(state, fused, parts, conv1x1=False):
    """Split a fused q|k|v projection into the three a published file
    holds (1x1 convs where ``conv1x1``)."""
    for leaf in ("weight", "bias"):
        t = state.pop(f"{fused}.{leaf}", None)
        if t is not None:
            for part, chunk in zip(parts, t.chunk(3)):
                chunk = chunk.contiguous()
                state[f"{part}.{leaf}"] = (chunk[:, :, None, None]
                                           if conv1x1 and leaf == "weight"
                                           else chunk)


def _bits(t):
    return t.detach().to(torch.float32).contiguous().view(torch.int32)


def _assert_same_state(got, want):
    """Same keys and shapes; every value equal in the bits of its fp32
    widening."""
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


def _from_jax(tree):
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))


SD1_MODELS = {
    "clip": (lambda: jsd1.CLIPText(vocab_size=64, embed_dim=64,
                                   num_layers=12, num_heads=4),
             lambda: (jnp.zeros((1, 77), jnp.int32),),
             JW.sd1_clip_rules, "import_sd1_clip"),
    "unet": (lambda: jsd1.SD1UNet(model_channels=32, context_dim=64,
                                  num_heads=4),
             lambda: (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 77, 64)),
                      jnp.zeros((1, 320))),
             JW.sd1_unet_rules, "import_sd1_unet"),
    "encoder": (jsd1.VAEEncoder,
                lambda: (jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 4, 4, 4))),
                JW.sd1_vae_encoder_rules, "import_sd1_vae_encoder"),
    "decoder": (jsd1.VAEDecoder, lambda: (jnp.zeros((1, 4, 4, 4)),),
                JW.sd1_vae_decoder_rules, "import_sd1_vae_decoder"),
}
SD1_FILES = {"clip": "clip", "unet": "diffusion", "encoder": "encoder",
             "decoder": "decoder"}


@functools.lru_cache(maxsize=None)
def _sd1_shapes(name):
    make, args, _, _ = SD1_MODELS[name]
    return _flax_shapes(make(), *args())


def _write_sd1(path, name, dtype, seed, wrap=False):
    """One reference .pt file: the attention projections under the
    ``*_proj_weight`` names ``make_compatible`` renames."""
    state = _file_state(SD1_MODELS[name][2](), _sd1_shapes(name), dtype, seed)
    state = {k.replace("_proj.weight", "_proj_weight")
              .replace("_proj.bias", "_proj_bias"): v
             for k, v in state.items()}
    if wrap:
        state = {"state_dict": state, "epoch": 3}
    torch.save(state, path)


@pytest.fixture(scope="module")
def sd1_dir(tmp_path_factory):
    """``<dir>/ckpt/{clip,diffusion,encoder,decoder}.pt`` in F32."""
    root = tmp_path_factory.mktemp("sd1")
    (root / "ckpt").mkdir()
    for i, (name, file) in enumerate(SD1_FILES.items()):
        _write_sd1(root / "ckpt" / f"{file}.pt", name, "f32", seed=10 + i)
    return root


def _sd3_main_state(dtype, qk_norm, seed, gain=None):
    """sd3.safetensors: the MMDiT under ``model.diffusion_model.``, the VAE
    under ``first_stage_model.`` with its attention as 1x1 convs, and keys
    no rule maps. ``gain`` plants every qk-norm gain."""
    cfg = jmm.MMDiTConfig(**MMDIT, qk_norm="rms" if qk_norm else None)
    shapes = _flax_shapes(jmm.MMDiT(cfg), jnp.zeros((1, 8, 8, 16)),
                          jnp.zeros((1,)), jnp.zeros((1, 32)),
                          jnp.zeros((1, 8, 48)))
    mmdit = _file_state(JW3.sd3_mmdit_rules(2, qk_norm), shapes, dtype, seed)
    if gain is not None:
        for k in mmdit:
            if ".ln_q." in k or ".ln_k." in k:
                mmdit[k] = torch.full_like(mmdit[k], gain)
    state = {f"model.diffusion_model.{k}": v for k, v in mmdit.items()}
    for side, model, args, rules in (
            ("encoder", jvae.SD3VAEEncoder(**SD3_VAE),
             (jnp.zeros((1, 16, 16, 3)),), JW3.sd3_vae_encoder_rules()),
            ("decoder", jvae.SD3VAEDecoder(**SD3_VAE),
             (jnp.zeros((1, 8, 8, 16)),), JW3.sd3_vae_decoder_rules())):
        part = _file_state(rules, _flax_shapes(model, *args), dtype,
                           seed + 1)
        _split(part, "mid.attn_1.in_proj",
               [f"mid.attn_1.{x}" for x in "qkv"], conv1x1=True)
        for leaf in ("weight", "bias"):
            t = part.pop(f"mid.attn_1.proj_out_dense.{leaf}")
            part[f"mid.attn_1.proj_out.{leaf}"] = (
                t[:, :, None, None] if leaf == "weight" else t)
        state.update({f"first_stage_model.{side}.{k}": v
                      for k, v in part.items()})
    state["model.diffusion_model.unmapped_extra"] = torch.zeros(3)
    state["cond_stage_model.ignored"] = torch.zeros(2)
    return state


def _clip_state(cfg, dtype, seed):
    """An HF CLIPTextModel file: q / k / v apart, plus ``position_ids`` and
    ``logit_scale``, which no rule maps."""
    shapes = _flax_shapes(jte.CLIPTextModel(jte.CLIPTextConfig(**cfg),
                                            intermediate_output=-2),
                          jnp.zeros((1, 77), jnp.int32))
    state = _file_state(JW3.hf_clip_text_rules(cfg["num_layers"]), shapes,
                        dtype, seed)
    for i in range(cfg["num_layers"]):
        p = f"text_model.encoder.layers.{i}.self_attn"
        _split(state, f"{p}.in_proj", [f"{p}.{x}_proj" for x in "qkv"])
    state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    state["logit_scale"] = torch.tensor(4.6)
    return state


def _t5_state(dtype, seed):
    """An HF T5 file: the encoder, plus ``shared.weight`` and a decoder
    block, which no rule maps."""
    shapes = _flax_shapes(jte.T5Encoder(jte.T5Config(**T5)),
                          jnp.zeros((1, 8), jnp.int32))
    state = _file_state(JW3.sd3_t5_rules(T5["num_layers"]), shapes, dtype,
                        seed)
    state["shared.weight"] = state["encoder.embed_tokens.weight"].clone()
    state["decoder.block.0.layer.0.SelfAttention.q.weight"] = torch.zeros(
        4, 4)
    return state


def _save(state, path):
    save_file({k: v.contiguous() for k, v in state.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def sd3_files(tmp_path_factory):
    """The SD3 file set in F16, the published dtype."""
    root = tmp_path_factory.mktemp("sd3")
    return dict(sd3=_save(_sd3_main_state("f16", False, 20),
                          root / "sd3.safetensors"),
                clip_l=_save(_clip_state(CLIP_L, "f16", 21),
                             root / "clip_l.safetensors"),
                clip_g=_save(_clip_state(CLIP_G, "f16", 22),
                             root / "clip_g.safetensors"),
                t5=_save(_t5_state("f16", 23), root / "t5.safetensors"))


# --------------------------------------------------------------------------
# The file readers
# --------------------------------------------------------------------------
def _every_dtype(rng):
    out = {}
    for name in TW._ST_DTYPE_NAMES:
        dt = getattr(torch, name)
        if dt.is_floating_point:
            t = torch.from_numpy(rng.standard_normal((3, 5))).to(dt)
        elif dt == torch.bool:
            t = torch.from_numpy(rng.integers(0, 2, (3, 5)).astype(bool))
        else:
            info = torch.iinfo(dt)
            t = torch.from_numpy(rng.integers(
                max(info.min, -1000), min(info.max, 1000), (3, 5))).to(dt)
        out[f"t_{name}"] = t
    # a 3-byte tensor first, so that the port writer's sorted layout puts
    # the tensors after it at unaligned offsets
    out["a_odd"] = torch.tensor([True, False, True])
    out["t_empty"] = torch.zeros((0, 3))
    out["t_scalar"] = torch.tensor(2.5, dtype=torch.float64)
    return out


def _read_with_safe_open(path, prefix=""):
    with safe_open(path, framework="pt") as f:
        return {k[len(prefix):]: f.get_tensor(k) for k in f.keys()
                if k.startswith(prefix)}


def _assert_equal_tensors(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("writer", ["port", "safetensors"])
def test_safetensors_reader_matches_safe_open(tmp_path, writer):
    """Every dtype of ``_ST_DTYPE_NAMES``, a zero-size tensor, a scalar,
    unaligned offsets, ``__metadata__`` and ``prefix``, against the
    ``safetensors`` package's reader."""
    tensors = _every_dtype(np.random.default_rng(0))
    tensors.update({"pre.x": torch.ones(2, 2), "pre.y": torch.arange(4)})
    path = str(tmp_path / "all.safetensors")
    meta = {"format": "pt", "note": "synthetic"}
    if writer == "port":
        TW.save_safetensors_dict(tensors, path, metadata=meta)
    else:
        save_file(tensors, path, metadata=meta)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == meta
    got = TW.load_safetensors_dict(path)
    _assert_equal_tensors(got, _read_with_safe_open(path))
    _assert_equal_tensors(got, tensors)
    _assert_equal_tensors(TW.load_safetensors_dict(path, prefix="pre."),
                          _read_with_safe_open(path, prefix="pre."))
    assert sorted(TW.load_safetensors_dict(path, prefix="pre.")) == ["x", "y"]


def test_safetensors_reader_raises_on_a_truncated_file(tmp_path):
    path = tmp_path / "t.safetensors"
    TW.save_safetensors_dict({"w": torch.ones(4, 4)}, str(path))
    data = path.read_bytes()
    path.write_bytes(data[:-1])
    with pytest.raises(ValueError, match="data section"):
        TW.load_safetensors_dict(str(path))
    with pytest.raises(Exception):
        _read_with_safe_open(str(path))
    path.write_bytes(data[:20])          # the header itself cut short
    with pytest.raises(ValueError, match="overruns"):
        TW.load_safetensors_dict(str(path))


def test_safetensors_reader_raises_on_an_unknown_dtype(tmp_path):
    header = json.dumps({"w": {"dtype": "Q7", "shape": [2],
                               "data_offsets": [0, 2]}}).encode()
    path = tmp_path / "q.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + b"\0\0")
    with pytest.raises(ValueError, match="unknown safetensors dtype"):
        TW.load_safetensors_dict(str(path))
    with pytest.raises(Exception):
        _read_with_safe_open(str(path))


def test_safetensors_writer_refuses_a_dtype_without_encoding(tmp_path):
    with pytest.raises(ValueError, match="no safetensors encoding"):
        TW.save_safetensors_dict({"c": torch.zeros(2, dtype=torch.cfloat)},
                                 str(tmp_path / "c.safetensors"))


def test_safetensors_writer_matches_the_jax_writer(tmp_path):
    """The port's writer and the JAX package's write the same bytes (numpy
    has no bf16, and the JAX writer stores a 0-d array as shape [1])."""
    rng = np.random.default_rng(1)
    tensors = {k: v for k, v in _every_dtype(rng).items()
               if v.dtype != torch.bfloat16 and v.dim() > 0}
    TW.save_safetensors_dict(tensors, str(tmp_path / "port.safetensors"),
                             metadata={"a": "1"})
    JW.save_safetensors_dict({k: v.numpy() for k, v in tensors.items()},
                             str(tmp_path / "jax.safetensors"),
                             metadata={"a": "1"})
    assert ((tmp_path / "port.safetensors").read_bytes()
            == (tmp_path / "jax.safetensors").read_bytes())


def test_torch_reader_keeps_the_file_dtype_and_maps_it(tmp_path):
    state = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.arange(4)}
    torch.save({"state_dict": state, "step": 7}, tmp_path / "c.pt")
    got = TW.load_torch_state_dict(str(tmp_path / "c.pt"))
    _assert_equal_tensors(got, state)


# --------------------------------------------------------------------------
# Rules and their application
# --------------------------------------------------------------------------
def _raised(fn):
    with pytest.raises(KeyError) as info:
        fn()
    return str(info.value)


def test_apply_rules_errors_match_jax():
    def both(state, rules, **kw):
        return (lambda: JW.apply_rules(
                    {k: v.numpy() for k, v in state.items()},
                    [(a, b, getattr(JW, c.__name__)) for a, b, c in rules],
                    **kw),
                lambda: TW.apply_rules(state, rules, **kw))

    rules = [("x.weight", "x/kernel", TW.t_dense),
             ("s.weight", "blk/skip/kernel", TW.t_conv)]
    w = torch.arange(6.0).reshape(2, 3)
    j, t = both({}, rules)                               # a missing key
    assert _raised(t) == _raised(j) == str(KeyError(
        "checkpoint missing key 'x.weight'"))
    j, t = both({"x.weight": w, "junk": w, "junk2": w}, rules)  # leftovers
    assert _raised(t) == _raised(j)
    assert "unmapped checkpoint keys: ['junk', 'junk2']" in _raised(t)
    for state in ({}, {"x.weight": w, "junk": w}):      # non-strict: neither
        j, t = both(state, rules, strict=False)
        assert sorted(t()) == sorted(_from_jax(j()))
    j, t = both({"x.weight": w}, rules)                 # skip is optional
    _assert_same_state(t(), _from_jax(j()))
    assert torch.equal(t()["x.weight"], w)              # the file's layout


def test_make_compatible_matches_jax():
    state = {"a.in_proj_weight": torch.zeros(1),
             "b.out_proj_bias": torch.zeros(1), "c.q_proj_weight":
             torch.zeros(1), "d.other": torch.zeros(1)}
    got = TW.make_compatible(state)
    assert sorted(got) == sorted(JW.make_compatible(state))
    assert set(got) == {"a.in_proj.weight", "b.out_proj.bias",
                        "c.q_proj.weight", "d.other"}


def test_port_key_follows_from_jax_renames():
    assert TW.port_key("layer0/attn/qkv/kernel") == "layer0.attn.qkv.weight"
    assert TW.port_key("/ln_final/scale") == "ln_final.weight"
    assert TW.port_key("token_embedding/embedding") == \
        "token_embedding.weight"
    assert TW.port_key("position_value") == "position_value"


# --------------------------------------------------------------------------
# The importers, one by one
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(SD1_MODELS))
def test_sd1_importer_matches_jax(tmp_path, name, dtype):
    """The four SD1 .pt importers; the F16 files wrap their tensors in a
    ``state_dict`` entry beside a non-tensor one."""
    path = str(tmp_path / f"{name}.pt")
    _write_sd1(path, name, dtype, seed=1, wrap=dtype == "f16")
    importer = SD1_MODELS[name][3]
    got = getattr(TW, importer)(path)
    _assert_same_state(got, _from_jax(getattr(JW, importer)(path)))
    assert {t.dtype for t in got.values()} == {DTYPES[dtype]}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sdxl_vae_importer_matches_jax(tmp_path, dtype):
    state = _file_state(JW.sdxl_vae_encoder_rules(), _sd1_shapes("encoder"),
                        dtype, seed=2)
    state.update(_file_state(JW.sdxl_vae_decoder_rules(),
                             _sd1_shapes("decoder"), dtype, seed=3))
    for side in ("encoder", "decoder"):
        p = f"{side}.mid_block.attentions.0"
        _split(state, f"{p}.qkv_fused", [f"{p}.to_{x}" for x in "qkv"])
    path = _save(state, tmp_path / "sdxl_vae.safetensors")
    (enc, dec), (jenc, jdec) = TW.import_sdxl_vae(path), \
        JW.import_sdxl_vae(path)
    _assert_same_state(enc, _from_jax(jenc))
    _assert_same_state(dec, _from_jax(jdec))
    assert set(enc) == set(tsd1.VAEEncoder().state_dict())
    assert set(dec) == set(tsd1.VAEDecoder().state_dict())


def _same_config(tcfg, jcfg):
    fields = ("patch_size", "in_channels", "depth", "adm_in_channels",
              "context_dim", "pos_embed_max_size", "qk_norm", "stability")
    assert {f: getattr(tcfg, f) for f in fields} == \
        {f: getattr(jcfg, f) for f in fields}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_sd3_checkpoint_importer_matches_jax(tmp_path, qk_norm, dtype):
    path = _save(_sd3_main_state(dtype, qk_norm, seed=4),
                 tmp_path / "sd3.safetensors")
    got, want = TW3.import_sd3_checkpoint(path), \
        JW3.import_sd3_checkpoint(path)
    for t_state, j_tree in zip(got[:3], want[:3]):
        _assert_same_state(t_state, _from_jax(j_tree))
    _same_config(got[3], want[3])
    assert got[3].qk_norm == ("rms" if qk_norm else None)
    assert set(got[2]) == set(tvae.SD3VAEDecoder(**SD3_VAE).state_dict())
    assert set(got[0]) == set(tmm.MMDiT(got[3]).state_dict())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("prefix", ["", "text_encoders.clip_l.transformer."],
                         ids=["alone", "prefixed"])
def test_clip_text_importer_matches_jax(tmp_path, prefix, dtype):
    state = {prefix + k: v for k, v in _clip_state(CLIP_L, dtype, 5).items()}
    if prefix:       # a file that holds more than this encoder
        state.update({f"text_encoders.t5xxl.transformer.{k}": v
                      for k, v in _t5_state(dtype, 6).items()})
    path = _save(state, tmp_path / "clip.safetensors")
    got = TW3.import_clip_text(path, 2, prefix=prefix)
    _assert_same_state(got, _from_jax(JW3.import_clip_text(path, 2,
                                                            prefix=prefix)))
    assert set(got) == set(tte.CLIPTextModel(tte.CLIPTextConfig(**CLIP_L))
                           .state_dict())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_t5_importer_matches_jax(tmp_path, dtype):
    path = _save(_t5_state(dtype, 7), tmp_path / "t5.safetensors")
    got = TW3.import_t5(path, 2)
    _assert_same_state(got, _from_jax(JW3.import_t5(path, 2)))
    assert set(got) == set(tte.T5Encoder(tte.T5Config(**T5)).state_dict())


@pytest.mark.parametrize("dtype,fmt", [("f32", "safetensors"),
                                       ("f16", "safetensors"),
                                       ("bf16", "safetensors"), ("f32", "pt")])
def test_siglip_importer_matches_jax(tmp_path, dtype, fmt):
    from from_ddpm_to_stable_diffusion_tpu_torch.models import siglip as tsig

    shapes = _flax_shapes(jsig.SiglipVisionModel(
        jsig.SiglipVisionConfig(**SIGLIP)), jnp.zeros((1, 32, 32, 3)))
    state = _file_state(JWC.siglip_vision_rules(2), shapes, dtype, seed=8)
    for i in range(2):
        p = f"vision_model.encoder.layers.{i}.self_attn"
        _split(state, f"{p}.in_proj", [f"{p}.{x}_proj" for x in "qkv"])
    state["vision_model.head.probe"] = torch.zeros(1, 1, 64)
    state["text_model.embeddings.token_embedding.weight"] = torch.zeros(4, 8)
    path = str(tmp_path / f"siglip.{fmt}")
    if fmt == "pt":
        torch.save(state, path)
    else:
        _save(state, path)
    (got, cfg), (want, jcfg) = TWC.import_siglip_vision(path), \
        JWC.import_siglip_vision(path)
    _assert_same_state(got, _from_jax(want))
    assert cfg == jcfg == SIGLIP
    assert set(got) == set(tsig.SiglipVisionModel(
        tsig.SiglipVisionConfig(**cfg)).state_dict())


@pytest.mark.parametrize("pos", [True, False], ids=["pos_embed", "no_pos"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_sniff_mmdit_config_matches_jax(qk_norm, pos):
    state = _sd3_main_state("f32", qk_norm, seed=9)
    if not pos:
        del state["model.diffusion_model.pos_embed"]
    got = tpipe3.sniff_mmdit_config(state)
    _same_config(got, jpipe3.sniff_mmdit_config(state))
    assert (got.depth, got.adm_in_channels, got.context_dim,
            got.pos_embed_max_size) == (2, 32, 48, 8 if pos else 192)


# --------------------------------------------------------------------------
# The bundle entry points
# --------------------------------------------------------------------------
@pytest.fixture
def small_sd1(monkeypatch):
    """Both packages' SD1 pipelines build the small CLIP and UNet of the
    synthetic files (the VAEs are full)."""
    for mod, models in ((jpipe1, jsd1), (tpipe1, tsd1)):
        monkeypatch.setattr(mod, "CLIPText", functools.partial(
            models.CLIPText, vocab_size=64, embed_dim=64, num_heads=4))
        monkeypatch.setattr(mod, "SD1UNet", functools.partial(
            models.SD1UNet, model_channels=32, context_dim=64, num_heads=4))


@pytest.fixture
def small_sd3(monkeypatch):
    """Both packages' SD3 pipelines build the small text encoders and VAE
    of the synthetic files."""
    for mod, te, vae in ((jpipe3, jte, jvae), (tpipe3, tte, tvae)):
        monkeypatch.setattr(mod, "CLIP_L_CONFIG", te.CLIPTextConfig(**CLIP_L))
        monkeypatch.setattr(mod, "CLIP_G_CONFIG", te.CLIPTextConfig(**CLIP_G))
        monkeypatch.setattr(mod, "T5Config",
                            functools.partial(te.T5Config, **T5))
        monkeypatch.setattr(mod, "SD3VAEDecoder",
                            functools.partial(vae.SD3VAEDecoder, **SD3_VAE))
        monkeypatch.setattr(mod, "SD3VAEEncoder",
                            functools.partial(vae.SD3VAEEncoder, **SD3_VAE))


def _assert_same_bundle(got, want, groups):
    for g in groups:
        a, b = getattr(got, g).state_dict(), getattr(want, g).state_dict()
        assert sorted(a) == sorted(b), g
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].device == b[k].device, k
            assert torch.equal(a[k], b[k]), (g, k)


SD1_GROUPS = ("clip", "unet", "encoder", "decoder")
SD3_GROUPS = ("mmdit", "vae_encoder", "vae_decoder", "clip_l", "clip_g",
              "t5")


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_from_checkpoint_dir_matches_jax(sd1_dir, small_sd1, dtype):
    got = tpipe1.SD1Models.from_checkpoint_dir(str(sd1_dir), dtype,
                                               device="cpu")
    jbundle = jpipe1.SD1Models.from_checkpoint_dir(str(sd1_dir), dtype)
    want = tpipe1.SD1Models.from_jax(jbundle.params, device="cpu",
                                     dtype=dtype, clip_heads=4, unet_heads=4)
    _assert_same_bundle(got, want, SD1_GROUPS)
    norm = got.unet.enc1_res.norm1.weight
    conv = got.unet.enc1_res.conv1.weight
    assert norm.dtype == torch.float32
    assert conv.dtype == (torch.bfloat16 if dtype == "bf16"
                          else torch.float32)


def _sd3_forward_inputs():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((1, 8, 8, 16), dtype=np.float32),
            np.array([500.0], np.float32),
            rng.standard_normal((1, 32), dtype=np.float32),
            rng.standard_normal((1, 8, 48), dtype=np.float32))


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_from_checkpoints_matches_jax(sd3_files, small_sd3, dtype):
    f = sd3_files
    got = tpipe3.SD3Models.from_checkpoints(f["sd3"], f["clip_l"],
                                            f["clip_g"], f["t5"], dtype,
                                            device="cpu")
    jbundle = jpipe3.SD3Models.from_checkpoints(f["sd3"], f["clip_l"],
                                                f["clip_g"], f["t5"], dtype)
    config = tmm.MMDiTConfig(**MMDIT)
    assert got.mmdit.config == config
    want = tpipe3.SD3Models.from_jax(
        jbundle.params, device="cpu", dtype=dtype, mmdit_config=config,
        clip_l_cfg=tte.CLIPTextConfig(**CLIP_L),
        clip_g_cfg=tte.CLIPTextConfig(**CLIP_G),
        t5_config=tte.T5Config(**T5))
    _assert_same_bundle(got, want, SD3_GROUPS)
    if dtype == "fp32":
        x, t, y, ctx = _sd3_forward_inputs()
        with torch.inference_mode():
            out = got.mmdit(*(torch.from_numpy(a) for a in (x, t, y, ctx)))
        ref = jbundle.mmdit.apply({"params": jbundle.params["mmdit"]},
                                  x, t, y, ctx)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_from_checkpoints_without_t5_and_without_a_clip(sd3_files,
                                                        small_sd3):
    f = sd3_files
    got = tpipe3.SD3Models.from_checkpoints(f["sd3"], f["clip_l"],
                                            f["clip_g"], device="cpu")
    jbundle = jpipe3.SD3Models.from_checkpoints(f["sd3"], f["clip_l"],
                                                f["clip_g"])
    assert got.t5 is None and jbundle.t5 is None
    # the JAX bundle without CLIP-G loads and fails at get_cond; the port
    # refuses at load, naming the missing argument
    jbundle = jpipe3.SD3Models.from_checkpoints(f["sd3"], f["clip_l"])
    assert "clip_g" not in jbundle.params
    with pytest.raises(ValueError, match="clip_g_path"):
        tpipe3.SD3Models.from_checkpoints(f["sd3"], f["clip_l"],
                                          device="cpu")
    with pytest.raises(ValueError, match="clip_l_path"):
        tpipe3.SD3Models.from_checkpoints(f["sd3"], clip_g_path=f["clip_g"],
                                          device="cpu")


def test_from_checkpoints_reads_one_file_at_a_time(sd3_files, small_sd3,
                                                   monkeypatch):
    """Each group goes to the device before the next file is read: when T5
    is read, no earlier file is still mapped into the process."""
    f = sd3_files
    mapped = []

    def import_t5(*args, **kw):
        with open("/proc/self/maps") as fh:
            maps = fh.read()
        mapped.extend(name for name in ("sd3", "clip_l", "clip_g")
                      if f[name] in maps)
        return TW3.import_t5(*args, **kw)

    monkeypatch.setattr(tpipe3, "import_t5", import_t5)
    got = tpipe3.SD3Models.from_checkpoints(f["sd3"], f["clip_l"],
                                            f["clip_g"], f["t5"],
                                            device="cpu")
    assert got.t5 is not None and mapped == []


def test_a_missing_rule_key_fails(tmp_path, sd3_files, small_sd3):
    """``strict=False`` ignores keys no rule maps, never a rule's key the
    file lacks: the port refuses it at load, the JAX package at apply."""
    state = _sd3_main_state("f16", False, 20)
    del state["model.diffusion_model.joint_blocks.0.x_block.mlp.fc1.weight"]
    path = _save(state, tmp_path / "sd3.safetensors")
    f = sd3_files
    with pytest.raises(ValueError, match="without a checkpoint tensor"):
        tpipe3.SD3Models.from_checkpoints(path, f["clip_l"], f["clip_g"],
                                          device="cpu")
    jbundle = jpipe3.SD3Models.from_checkpoints(path, f["clip_l"],
                                                f["clip_g"], dtype="fp32")
    with pytest.raises(flax_errors.ScopeParamNotFoundError):
        jbundle.mmdit.apply({"params": jbundle.params["mmdit"]},
                            *_sd3_forward_inputs())


@pytest.mark.parametrize("gain,stability", [(3.0, "online"),
                                            (1.0, "bounded")])
def test_qk_norm_certificate_matches_jax(tmp_path, sd3_files, small_sd3,
                                         capsys, gain, stability):
    """A gain of 3 bounds the logits at 8 · 3 · 3 = 72, over the budget of
    70: both packages switch to the online softmax and say so; a gain of 1
    (bound 8) keeps the bounded one."""
    path = _save(_sd3_main_state("f16", True, 24, gain=gain),
                 tmp_path / "sd3.safetensors")
    f = sd3_files
    got = tpipe3.SD3Models.from_checkpoints(path, f["clip_l"], f["clip_g"],
                                            device="cpu")
    port_out = capsys.readouterr().out
    jbundle = jpipe3.SD3Models.from_checkpoints(path, f["clip_l"],
                                                f["clip_g"])
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    assert ("online softmax" in port_out) == (stability == "online")
    jstab = jbundle.mmdit.config.stability or "bounded"
    assert jstab == stability
    assert (got.mmdit.config.stability or "bounded") == stability
    assert {b.stability for b in got.mmdit.modules()
            if isinstance(b, tmm.JointBlock)} == {stability}
    assert got.mmdit.config.qk_norm == "rms"


# --------------------------------------------------------------------------
# chip_smoke.py's writers, which the card's checkpoint phase runs
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_sd1_writer_round_trips(tmp_path, sd1_dir, small_sd1,
                                           chip_smoke):
    src = tpipe1.SD1Models.from_checkpoint_dir(str(sd1_dir), "bf16",
                                               device="cpu")
    nbytes = chip_smoke.write_sd1_checkpoint(src, str(tmp_path),
                                             torch.float32)
    assert nbytes == sum(p.stat().st_size
                         for p in (tmp_path / "ckpt").iterdir())
    keys = torch.load(tmp_path / "ckpt" / "clip.pt", mmap=True).keys()
    assert "layers.0.attention.in_proj_weight" in keys
    got = tpipe1.SD1Models.from_checkpoint_dir(str(tmp_path), "bf16",
                                               device="cpu")
    _assert_same_bundle(got, src, SD1_GROUPS)
    assert chip_smoke.same_parameters("sd1", [
        (g, getattr(got, g), getattr(src, g)) for g in SD1_GROUPS]) > 0
    assert not chip_smoke.FAILURES


def test_chip_smoke_sd3_writer_round_trips(tmp_path, sd3_files, small_sd3,
                                           chip_smoke):
    f = sd3_files
    src = tpipe3.SD3Models.from_checkpoints(f["sd3"], f["clip_l"],
                                            f["clip_g"], f["t5"], "bf16",
                                            device="cpu")
    paths, nbytes = chip_smoke.write_sd3_checkpoints(src, str(tmp_path))
    assert sorted(paths) == ["clip_g", "clip_l", "sd3", "t5xxl"]
    assert nbytes == sum(pathlib.Path(p).stat().st_size
                         for p in paths.values())
    with safe_open(paths["clip_l"], framework="pt") as fh:
        assert "text_model.encoder.layers.0.self_attn.q_proj.weight" in \
            fh.keys()
    with safe_open(paths["sd3"], framework="pt") as fh:
        for side in ("encoder", "decoder"):
            assert fh.get_tensor(
                f"first_stage_model.{side}.mid.attn_1.q.weight").dim() == 4
    assert src.vae_encoder is not None
    got = tpipe3.SD3Models.from_checkpoints(
        paths["sd3"], paths["clip_l"], paths["clip_g"], paths["t5xxl"],
        "bf16", device="cpu")
    assert got.mmdit.config == src.mmdit.config
    _assert_same_bundle(got, src, SD3_GROUPS)
    assert not chip_smoke.FAILURES
