"""Tensor parallelism of the port (``parallel/sharding.py``) against the JAX
package's, on the CPU. The JAX side runs its own TP on the virtual CPU
devices of ``tests/conftest.py`` (params placed by its ``apply_tp``, GSPMD
inserting the collectives); the port runs mesh form (a), the host device
repeated (``build_mesh({"model": n}, ["cpu"] * n)``), each module computing
Megatron's block shard by shard.

- The rules: the port's ``tp_shardings`` gives the JAX ``tp_shardings``
  spec for every leaf of small SD1UNet, SD1 CLIP, SD1 VAE encoder and
  decoder, MMDiT (depth 2), CLIP-L / CLIP-G and T5 trees, float and W8A8,
  at n = 2 and 4; ``tp_layout`` (what ``apply_tp`` does with a port module)
  gives the same specs except the leaves it holds whole, named in
  ``HELD_WHOLE``: the one-head VAE attentions, whose heads do not divide.
- Heads: shard j of a fused q|k|v weight holds heads [jH/n, (j+1)H/n) of
  each of q, k and v, and of GEGLU's z | gate the matching halves; a
  contiguous chunk of the fused weight would cross them.
- The TP forwards at n = 2 and 4 against the JAX forwards on a {"model": 2}
  mesh, fp32: relative L2 within 1e-5.
- ``SD1Generator(mesh=)`` and ``SD3Inferencer(mesh=)``, small and fed the
  JAX draws, against the JAX generators with a mesh: uint8 images within
  one level.
- W8A8 under TP: the row-parallel int32 accumulators equal the unsharded
  ones exactly (and so does the layer's output, bit for bit), column and
  row layers at n = 2 and 4; the int8 MMDiT under TP within JAX's own
  bound (``tests/test_quantize.py``: atol 0.05) of the JAX int8 MMDiT on a
  {"data": 2, "model": 4} mesh.
"""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.io import tokenizer as jtok
from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.models import sd1 as jsd1
from from_ddpm_to_stable_diffusion_tpu.models import text_encoders as jte
from from_ddpm_to_stable_diffusion_tpu.ops import quantize as jq
from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh as jmesh
from from_ddpm_to_stable_diffusion_tpu.parallel import sharding as jsh
from from_ddpm_to_stable_diffusion_tpu.pipelines import sd1 as jpipe
from from_ddpm_to_stable_diffusion_tpu.pipelines import sd3 as jpipe3
from from_ddpm_to_stable_diffusion_tpu_torch.io import tokenizer as ttok
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params)
from from_ddpm_to_stable_diffusion_tpu_torch.models import layers as tl
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd1 as tsd1
from from_ddpm_to_stable_diffusion_tpu_torch.models import (
    text_encoders as tte)
from from_ddpm_to_stable_diffusion_tpu_torch.ops import quantize as tq
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import sharding as tsh
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd1 as tpipe
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines import sd3 as tpipe3
from tests.test_torch_models import jax_random_params
from tests.test_torch_sd1_full import WORDS
from tests.test_torch_sd1_full import _jax_draws as sd1_draws
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def cpu_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return build_mesh(shape, ["cpu"] * n)


CLIP_L = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4)
CLIP_G = dict(vocab_size=64, hidden_size=80, num_layers=2, num_heads=4,
              hidden_act="gelu")
T5_KW = dict(vocab_size=100, d_model=64, d_ff=128, num_layers=2, num_heads=4)
MMDIT_KW = dict(depth=2, pos_embed_max_size=8)
TOKENS = np.random.default_rng(3).integers(1, 64, (2, 77)).astype(np.int32)
T5_TOKENS = np.random.default_rng(4).integers(1, 100, (2, 16)).astype(
    np.int32)

# name: (JAX module, port module, inputs)
MODELS = {
    "sd1_unet": lambda: (jsd1.SD1UNet(model_channels=32, num_heads=4),
                         tsd1.SD1UNet(model_channels=32, num_heads=4),
                         (_rand((2, 8, 8, 4), 1), _rand((2, 77, 768), 2),
                          _rand((2, 320), 3))),
    "sd1_clip": lambda: (jsd1.CLIPText(vocab_size=64, num_layers=2,
                                       num_heads=4, embed_dim=64),
                         tsd1.CLIPText(vocab_size=64, num_layers=2,
                                       num_heads=4, embed_dim=64),
                         (TOKENS,)),
    "mmdit": lambda: (jmm.MMDiT(jmm.MMDiTConfig(**MMDIT_KW)),
                      tmm.MMDiT(tmm.MMDiTConfig(**MMDIT_KW)),
                      (_rand((2, 8, 8, 16), 4),
                       np.asarray([100.0, 700.0], np.float32),
                       _rand((2, 2048), 5), _rand((2, 10, 4096), 6, 0.5))),
    "clip_l": lambda: (jte.CLIPTextModel(jte.CLIPTextConfig(**CLIP_L), -2),
                       tte.CLIPTextModel(tte.CLIPTextConfig(**CLIP_L), -2),
                       (TOKENS,)),
    "clip_g": lambda: (jte.CLIPTextModel(jte.CLIPTextConfig(**CLIP_G), -2),
                       tte.CLIPTextModel(tte.CLIPTextConfig(**CLIP_G), -2),
                       (TOKENS,)),
    "t5": lambda: (jte.T5Encoder(jte.T5Config(**T5_KW)),
                   tte.T5Encoder(tte.T5Config(**T5_KW)), (T5_TOKENS,)),
    "vae_decoder": lambda: (jsd1.VAEDecoder(), tsd1.VAEDecoder(),
                            (_rand((1, 4, 4, 4), 7),)),
    "vae_encoder": lambda: (jsd1.VAEEncoder(), tsd1.VAEEncoder(),
                            (_rand((1, 32, 32, 3), 8),
                             _rand((1, 4, 4, 4), 9))),
}
# the leaves the JAX rules shard and the port holds whole, because their
# module's heads do not divide by the axis (GSPMD may split a head, a split
# by heads cannot): the one-head mid attention of the SD1 VAE (JAX
# models/sd1.py, head dim 512), and at n = 4 the joint blocks of the depth-2
# MMDiT, which has 2 heads (the embedders and final_adaLN still shard)
VAE_ATTN = {"mid_attn.attn.qkv.weight", "mid_attn.attn.qkv.bias",
            "mid_attn.attn.out.weight"}


def held_whole(name, n, jspecs):
    if name.startswith("vae"):
        return VAE_ATTN
    if name == "mmdit" and n == 4:
        return {k for k, v in jspecs.items() if v and "_block." in k}
    return set()


def _jnp(a):
    return jnp.asarray(a)


def _torch(a):
    a = np.array(a)
    return torch.from_numpy(a).long() if np.issubdtype(
        a.dtype, np.integer) else torch.from_numpy(a)


def _sd_name(path: str, quantized: bool) -> str:
    """The port's ``state_dict`` name of a Flax leaf path (io/from_jax.py's
    renames; a QuantDense's q and scale keep theirs)."""
    *parent, leaf = path.split("/")
    if not (quantized and leaf in ("q", "scale")):
        leaf = {"kernel": "weight", "scale": "weight",
                "embedding": "weight"}.get(leaf, leaf)
    return ".".join(parent + [leaf])


def _jax_specs(tree, n):
    mesh = jmesh({"model": n}, jax.devices()[:n])
    shard = jsh.tp_shardings(tree, mesh)
    quantized = {jsh._path_str(k).rsplit("/", 1)[0] for k, _ in
                 jax.tree_util.tree_flatten_with_path(tree)[0]
                 if jsh._path_str(k).endswith("/q")}
    return {_sd_name(jsh._path_str(k), jsh._path_str(k).rsplit("/", 1)[0]
                     in quantized): tuple(s.spec)
            for k, s in jax.tree_util.tree_flatten_with_path(shard)[0]}


def _flat_specs(tree):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{key}/{k}": s for k, s in _flat_specs(v).items()})
        else:
            out[key] = v
    return out


@pytest.fixture(scope="module", params=list(MODELS))
def model_case(request):
    jmod, tmod, inputs = MODELS[request.param]()
    shapes = jax.eval_shape(jmod.init, jax.random.key(0),
                            *(_jnp(a) for a in inputs))["params"]
    return request.param, jmod, tmod, inputs, shapes


@pytest.mark.parametrize("n", [2, 4])
def test_tp_rules_are_the_jax_rules_leaf_by_leaf(model_case, n):
    name, _, tmod, _, shapes = model_case
    mesh = jmesh({"model": n}, jax.devices()[:n])
    want = {jsh._path_str(k): tuple(s.spec) for k, s in
            jax.tree_util.tree_flatten_with_path(
                jsh.tp_shardings(shapes, mesh))[0]}
    got = _flat_specs(tsh.tp_shardings(shapes, {"model": n}))
    assert got == want
    assert any(want.values()), name
    # what apply_tp does with the port module: the JAX specs by state_dict
    # name, but for the leaves named as held whole
    jspecs = _jax_specs(shapes, n)
    layout = tsh.tp_layout(tmod, n)
    assert set(layout) == set(jspecs)
    differ = {k for k in jspecs if layout[k] != jspecs[k]}
    assert differ == held_whole(name, n, jspecs), sorted(differ)
    assert all(layout[k] == () for k in differ)


@pytest.mark.parametrize("name", ["mmdit", "t5", "sd1_unet"])
def test_tp_rules_of_the_int8_trees(name):
    jmod, tmod, inputs = MODELS[name]()
    params = jax_random_params(jmod, *(_jnp(a) for a in inputs), seed=7)
    qparams = jax.jit(jq.quantize_tree)(params)
    port = load_jax_params(tmod, params)
    tq.quantize_module(port)
    for n in (2, 4):
        jspecs = _jax_specs(qparams, n)
        layout = tsh.tp_layout(port, n)
        assert set(layout) == set(jspecs)
        differ = {k for k in jspecs if layout[k] != jspecs[k]}
        assert differ == held_whole(name, n, jspecs), sorted(differ)
        assert n == 4 or any(k.endswith(".q") and v
                             for k, v in layout.items())


def test_tp_spec_for_path_cases_of_the_jax_tests():
    """``tests/test_sd1_tp.py`` and ``tests/test_quantize.py``'s cases."""
    cases = {"enc1_att/attn1/qkv/kernel": (None, "model"),
             "enc1_att/attn1/out/kernel": ("model", None),
             "enc1_att/geglu_in/kernel": (None, "model"),
             "enc1_att/geglu_out/kernel": ("model", None),
             "enc1_res/conv1/kernel": (),
             "joint_block0/x_block/qkv/q": (None, "model"),
             "joint_block0/x_block/qkv/scale": ("model",),
             "joint_block0/x_block/proj/q": ("model", None),
             "joint_block0/x_block/proj/scale": (),
             "joint_block0/x_block/ln_q/scale": ()}
    for path, spec in cases.items():
        assert tsh.tp_spec_for_path(path) == spec == tuple(
            jsh.tp_spec_for_path(path)), path


@pytest.mark.parametrize("n", [2, 4])
def test_fused_projections_split_by_heads(n):
    """Rows tagged by their index: shard j of the q|k|v weight holds rows
    g*C + [jC/n, (j+1)C/n) of each group g (its heads of q, of k and of v),
    in form (b)'s slice and in form (a)'s views alike; of GEGLU's z | gate
    the matching halves. A contiguous chunk of the fused weight would not."""
    c, heads = 32, 8
    attn = tl.SelfAttention(c, heads)
    block = tl.TransformerBlock(c, 16, heads)
    for layer, groups, width in ((attn.qkv, 3, c), (block.geglu_in, 2,
                                                    4 * c)):
        with torch.no_grad():
            layer.weight.copy_(torch.arange(groups * width).float()[:, None]
                               .expand_as(layer.weight))
        owner = attn if layer is attn.qkv else block
        name = "qkv" if layer is attn.qkv else "geglu_in"
        role = tsh.tp_roles(owner, n)[f"{name}.weight"]
        assert role == ("column", groups, 0)
        comm = cpu_mesh({"model": n}).comm("model")
        views = tsh._column_parts(layer, comm, groups)
        per = width // n
        for j in range(n):
            want = torch.cat([torch.arange(g * width + j * per,
                                           g * width + (j + 1) * per)
                              for g in range(groups)]).float()
            got = tsh.tp_slice(layer.weight, role, j, n)[:, 0]
            assert torch.equal(got, want), (name, j)
            assert torch.equal(torch.cat([w for w, _ in views[j]])[:, 0],
                               want)
            chunk = layer.weight.chunk(n, 0)[j][:, 0]
            assert not torch.equal(chunk, want)
        if layer is attn.qkv:   # each shard's rows are whole heads
            d = c // heads
            for j in range(n):
                rows = tsh.tp_slice(layer.weight, role, j, n)[:, 0].long()
                head_ids = {int(r) % c // d for r in rows}
                assert head_ids == set(range(j * heads // n,
                                             (j + 1) * heads // n))


@pytest.mark.parametrize("name", [m for m in MODELS
                                  if not m.startswith("vae")])
def test_tp_forwards_match_the_jax_tp_forwards(name):
    jmod, tmod, inputs = MODELS[name]()
    params = jax_random_params(jmod, *(_jnp(a) for a in inputs), seed=11)
    mesh = jmesh({"model": 2}, jax.devices()[:2])
    want = jax.jit(jmod.apply)({"params": jsh.apply_tp(params, mesh)},
                               *(_jnp(a) for a in inputs))
    want = want[0] if isinstance(want, tuple) else want
    load_jax_params(tmod, params).eval()
    for n in (2, 4):
        port = tsh.apply_tp(copy.deepcopy(tmod), cpu_mesh({"model": n}))
        switched = [m.tp.n for m in port.modules()
                    if getattr(m, "tp", None) is not None]
        assert switched and set(switched) == {n}
        with torch.no_grad():
            got = port(*(_torch(a) for a in inputs))
        got = got[0] if isinstance(got, tuple) else got
        assert _rel_l2(got.numpy(), want) <= 1e-5, (name, n)


# ------------------------------------------------------------ serving
H = W = 64


def test_sd1_generator_over_a_model_mesh_matches_jax():
    """SD1Generator(mesh=) of both packages on one tree (a UNet of width 32
    and 4 heads, a 768-wide CLIP layer, the VAE), k-LMS with CFG and a
    tokenizer, 4 steps at 64^2, the JAX draws fed to the port: uint8 within
    one level; the port's bundle really switched (every UNet attention on
    its shards, the VAE's held whole)."""
    vocab, merges = jtok.build_simple_vocab(WORDS)
    clip = jsd1.CLIPText(vocab_size=len(vocab), num_layers=1, num_heads=4,
                         embed_dim=768)
    unet = jsd1.SD1UNet(model_channels=32, num_heads=4)
    decoder = jsd1.VAEDecoder()
    params = {
        "clip": jax_random_params(clip, jnp.zeros((1, 77), jnp.int32),
                                  seed=1),
        "unet": jax_random_params(unet, jnp.zeros((1, 8, 8, 4)),
                                  jnp.zeros((1, 77, 768)),
                                  jnp.zeros((1, 320)), seed=2),
        "decoder": jax_random_params(decoder, jnp.zeros((1, 8, 8, 4)),
                                     seed=3),
    }
    models = tpipe.SD1Models.from_jax(params, device="cpu", clip_heads=4,
                                      unet_heads=4)
    jmodels = types.SimpleNamespace(clip=clip, unet=unet, decoder=decoder,
                                    encoder=None, params=dict(params))
    kw = dict(sampler="k_lms", n_inference_steps=4, height=H, width=W)
    want = jpipe.SD1Generator(
        jmodels, tokenizer=jtok.CLIPTokenizer(vocab, merges),
        mesh=jmesh({"model": 2}, jax.devices()[:2]), **kw)(
            ["photo of a cat"], seed=5)
    gen = tpipe.SD1Generator(
        models, tokenizer=ttok.CLIPTokenizer(*ttok.build_simple_vocab(WORDS)),
        mesh=cpu_mesh({"model": 2}), **kw)
    assert gen.mesh.shape == {"model": 2}
    assert models.unet.enc1_att.attn1.tp.n == 2
    assert models.clip.layer0.attn.tp.n == 2
    assert models.decoder.mid_attn.attn.tp is None
    got = gen(["photo of a cat"], seed=5, **sd1_draws(5, 1))
    assert got.shape == want.shape == (1, H, W, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_sd3_inferencer_over_a_model_mesh_matches_jax():
    """SD3Inferencer(mesh=) of both packages on the reduced bundle of
    ``tests/test_torch_sd3_serving.py`` (depth-2 MMDiT, 2-layer CLIPs at
    768 / 1280, a 1-layer T5 at 4096, 4 heads each), 4 steps at 64^2, CFG
    5, the JAX noise fed to the port: uint8 within one level; and the
    same within one level of it over a ring MMDiT on its own {"seq": 2}
    mesh, each head shard's ring over seq (the command line alone keeps
    --tp and --sp apart, as the JAX one does)."""
    from tests.test_torch_sd3_serving import (CLIP_TOKENS, KW, LATENT,
                                              _jax_models, _jax_noise,
                                              _port_models)

    jmodels = _jax_models()
    tmodels = _port_models(jmodels.params)
    want = jpipe3.SD3Inferencer(
        jmodels, shift=3.0, decode_mode="whole",
        mesh=jmesh({"model": 2}, jax.devices()[:2])).gen_image(
            CLIP_TOKENS, seed=2, **KW)
    inf = tpipe3.SD3Inferencer(tmodels, shift=3.0,
                               mesh=cpu_mesh({"model": 2}))
    assert tmodels.t5.block0.attn.tp.n == 2
    assert tmodels.mmdit.joint_block0.x_block.tp.n == 2
    got = inf.gen_image(CLIP_TOKENS, noise=_jax_noise(2, (1, *LATENT)),
                        **KW)
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    ring = tpipe3.SD3Models(**{f.name: getattr(tmodels, f.name) for f in
                               dataclasses.fields(tmodels)})
    ring.mmdit = copy.deepcopy(tmodels.mmdit).set_attention(
        "ring", cpu_mesh({"seq": 2}))
    composed = tpipe3.SD3Inferencer(ring, mesh=cpu_mesh({"model": 2}))
    blk = ring.mmdit.joint_block0
    assert blk.x_block.tp.n == 2 and blk.mesh.shape == {"seq": 2}
    got = composed.gen_image(CLIP_TOKENS, noise=_jax_noise(2, (1, *LATENT)),
                             **KW)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


# ------------------------------------------------------------ W8A8
@pytest.mark.parametrize("n", [2, 4])
def test_int8_row_accumulators_exact_under_tp(n):
    """A row-parallel QuantLinear: the int32 accumulators summed over the
    shards equal the unsharded product's bit for bit (the per-token abs-max
    reduced with max first), and so does the output; a column-parallel one's
    gathered output too."""
    rng = np.random.default_rng(n)
    lin = torch.nn.Linear(64, 48)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(rng.standard_normal((48, 64))))
        lin.bias.copy_(torch.from_numpy(rng.standard_normal(48)))
    q = tq.QuantLinear.from_linear(lin)
    x = torch.from_numpy(_rand((3, 5, 64), n + 10))
    comm = cpu_mesh({"model": n}).comm("model")
    acc, scale = tsh.row_int8_accumulators(q, comm.local_shards(x, 2), comm)
    xq, xs = tq.quantize_rows(x)
    whole = tq.int8_matmul(xq.reshape(-1, 64), q.q.t()).reshape(3, 5, 48)
    assert acc.dtype == torch.int32 and torch.equal(acc, whole)
    assert torch.equal(scale, xs)
    assert torch.equal(tsh.row_replicated(q, x, comm), q(x))
    col = torch.cat(tsh.column(q, x, comm), -1)
    assert torch.equal(col, q(x))


def test_int8_mmdit_under_tp_matches_jax():
    """``tests/test_quantize.py::test_int8_tp_sharded_mmdit_matches_single_
    device`` for the port: the int8 MMDiT (depth 2, 2 heads) carried from
    JAX's ``quantize_tree``, under TP at n = 2, against the JAX int8 MMDiT
    on a {"data": 2, "model": 4} mesh, within its atol 0.05 and
    correlation 0.9999."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = jmm.MMDiTConfig(depth=2, pos_embed_max_size=8)
    x = np.asarray(jax.random.normal(jax.random.key(0), (2, 8, 8, 16)))
    t = np.asarray([100.0, 500.0], np.float32)
    y = np.asarray(jax.random.normal(jax.random.key(1), (2, 2048)))
    ctx = np.asarray(jax.random.normal(jax.random.key(2), (2, 154, 4096)))
    base = jmm.MMDiT(cfg)
    params = jq.quantize_tree(base.init(jax.random.key(3), x, t, y,
                                        ctx)["params"])
    mesh = jmesh({"data": 2, "model": 4}, jax.devices()[:8])
    sharded = jax.tree_util.tree_map(jax.device_put, params,
                                     jsh.tp_shardings(params, mesh))
    model = jmm.MMDiT(dataclasses.replace(cfg, int8_mm=True))
    want = np.asarray(jax.jit(lambda p, x: model.apply(
        {"params": p}, x, t, y, ctx))(sharded, jax.device_put(
            x, NamedSharding(mesh, P("data")))))
    port = load_jax_params(tmm.MMDiT(tmm.MMDiTConfig(
        depth=2, pos_embed_max_size=8, int8_mm=True)), params).eval()
    tsh.apply_tp(port, cpu_mesh({"model": 2}))
    assert isinstance(port.joint_block0.x_block.proj, tq.QuantLinear)
    with torch.no_grad():
        got = port(*(_torch(a) for a in (x, t, y, ctx))).numpy()
    np.testing.assert_allclose(got, want, atol=0.05)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
