"""The port's W8A8 int8 path (``ops/quantize.py``) against the JAX package's,
on the CPU.

- ``quantize_per_channel`` and the per-token activation quantization: ``q``,
  ``scale``, ``xq``, ``xs`` bit-identical to JAX on the same fp32 or bf16
  inputs, JAX run as it serves, under ``jax.jit`` (``quantize_int8`` and the
  int8 forwards), where XLA multiplies by the fp32 reciprocal of 127; run
  op by op it divides, and ``scale`` may differ in its last bit.
- ``int8_dot``: the int32 accumulators identical to
  ``jax.lax.dot_general(..., preferred_element_type=int32)``; the fp32
  output within 1e-6 relative (the dequantization is the same three fp32
  operations in the same order).
- ``QuantLinear`` against ``QuantDense`` on the same parameters: fp32 within
  1e-6 relative, bf16 within one bf16 ulp.
- ``quantize_module`` converts exactly the layers ``quantize_tree``
  converts (the JAX regex on the Flax paths) on a small MMDiT, T5 and
  SD1UNet, and gives the same ``q`` / ``scale`` bits.
- The int8 forwards of those three against JAX's with the quantized
  weights carried across, fp32 compute: relative L2 <= 2e-3, or three times
  the JAX forward's own movement when its float input moves by 1e-6
  relative, whichever is larger. Upstream summation-order differences
  (~1e-6 relative between XLA and PyTorch on the CPU) flip the odd
  activation rounding by one int8 step, and a deep random-weight network
  carries those flips on: the SD1 UNet's int8 forward moves 1.2e-2 under
  such a perturbation of its own input in JAX alone. One of its
  TransformerBlocks, where no flip happens, is held to 2e-3 by itself.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import layers as jl
from from_ddpm_to_stable_diffusion_tpu.models import mmdit as jmm
from from_ddpm_to_stable_diffusion_tpu.models import sd1 as jsd1
from from_ddpm_to_stable_diffusion_tpu.models import text_encoders as jte
from from_ddpm_to_stable_diffusion_tpu.ops import quantize as jq
from from_ddpm_to_stable_diffusion_tpu.parallel.sharding import _path_str
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params)
from from_ddpm_to_stable_diffusion_tpu_torch.models import layers as tl
from from_ddpm_to_stable_diffusion_tpu_torch.models import mmdit as tmm
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd1 as tsd1
from from_ddpm_to_stable_diffusion_tpu_torch.models import (
    text_encoders as tte)
from from_ddpm_to_stable_diffusion_tpu_torch.ops import quantize as tq
from from_ddpm_to_stable_diffusion_tpu_torch.utils.dtypes import (
    cast_params_for_inference)
from tests.test_torch_models import jax_random_params

F32, BF16 = torch.float32, torch.bfloat16


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jnp(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == BF16 else jnp.float32)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_quantize_per_channel_matches_jax_bit_for_bit(dtype):
    w = _rand((96, 40), 0)
    w[:, 3] = 0.0                       # an all-zero channel: the 1e-8 floor
    w[5, 7] = 40.0                      # an outlier
    w[::7] *= 1e-3
    jw = _jnp(w, dtype)
    tw = torch.from_numpy(w).to(dtype)
    jquant = jax.jit(jq.quantize_per_channel, static_argnums=1)
    want_q, want_s = jquant(jw, 0)
    got_q, got_s = tq.quantize_per_channel(tw, axis=0)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # a PyTorch (N, K) weight, contracted over axis 1: the same bits
    got_qt, got_st = tq.quantize_per_channel(tw.t().contiguous(), axis=1)
    np.testing.assert_array_equal(got_qt.t().numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_s))
    # round half to even, as jnp.round: 2.5 / 127-steps land on .5 exactly
    half = np.asarray([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32).T
    got_q, _ = tq.quantize_per_channel(torch.from_numpy(half), axis=0)
    want_q, _ = jquant(jnp.asarray(half), 0)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_q[:, 0].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_int8_dot_matches_jax(dtype):
    x = _rand((3, 19, 64), 1) * np.linspace(0.01, 10, 64, dtype=np.float32)
    x[0, 4] = 0.0                       # a zero row: xs at its floor
    w = _rand((64, 48), 2)
    jx, tx = _jnp(x, dtype), torch.from_numpy(x).to(dtype)
    q, scale = jax.jit(jq.quantize_per_channel)(jnp.asarray(w))
    tq_, tscale = (torch.from_numpy(np.array(q)),
                   torch.from_numpy(np.array(scale)))
    # the activation quantization and the int32 accumulators: identical
    @jax.jit
    def jax_rows(x):
        xf = x.astype(jnp.float32)
        xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True),
                         1e-8) / 127.0
        return jnp.round(xf / xs).astype(jnp.int8), xs

    want_xq, xs = jax_rows(jx)
    want_acc = jax.lax.dot_general(want_xq, q, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    got_xq, got_xs = tq.quantize_rows(tx)
    np.testing.assert_array_equal(got_xq.numpy(), np.asarray(want_xq))
    np.testing.assert_array_equal(got_xs.numpy(), np.asarray(xs))
    got_acc = tq.int8_matmul(got_xq.reshape(-1, 64), tq_)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.reshape(3, 19, 48).numpy(),
                                  np.asarray(want_acc))
    # the dequantized output
    want = np.asarray(jax.jit(jq.int8_dot)(jx, q, scale).astype(jnp.float32))
    got = tq.int8_dot(tx, tq_, tscale)
    assert got.dtype == dtype
    if dtype == F32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=0)
    # q read through a transposed view (QuantLinear's (N, K) buffer)
    got_t = tq.int8_dot(tx, tq_.t().contiguous().t(), tscale)
    torch.testing.assert_close(got_t, got, rtol=0, atol=0)


def test_int8_matmul_checks_its_operands():
    a = torch.ones(4, 8, dtype=torch.int8)
    with pytest.raises(TypeError):
        tq.int8_matmul(a.float(), a.t())
    with pytest.raises(ValueError, match="inner"):
        tq.int8_matmul(a, a)
    # the CPU product takes any shape, exactly: K * 127^2 at the edge
    big = torch.full((2, 4096), 127, dtype=torch.int8)
    out = tq.int8_matmul(big, -big.t())
    assert (out == -4096 * 127 * 127).all()


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["fp32", "bf16"])
def test_quant_linear_matches_quant_dense(dtype, bias):
    x = _rand((2, 7, 32), 3)
    w, b = _rand((32, 24), 4), _rand((24,), 5)
    q, scale = jax.jit(jq.quantize_per_channel)(jnp.asarray(w))
    params = {"q": q, "scale": scale}
    if bias:
        params["bias"] = jnp.asarray(b)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = jax.jit(jq.QuantDense(24, use_bias=bias, dtype=jdt).apply)(
        {"params": params}, jnp.asarray(x))
    lin = load_jax_params(tq.QuantLinear(32, 24, bias=bias), params)
    assert lin.q.shape == (24, 32) and lin.q.dtype == torch.int8
    cast_params_for_inference(lin, dtype)
    assert lin.compute_dtype == dtype and lin.scale.dtype == F32
    with torch.no_grad():
        got = lin(torch.from_numpy(x))
    assert got.dtype == dtype
    tol = 1e-6 if dtype == F32 else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol * np.abs(np.asarray(want,
                                                            np.float32)).max())
    # the same layer quantized from a port Linear on the spot
    plain = tl.Linear(32, 24, bias=bias)
    plain.weight.data = torch.from_numpy(w.T.copy())
    if bias:
        plain.bias.data = torch.from_numpy(b)
    made = tq.QuantLinear.from_linear(plain)
    assert torch.equal(made.q, lin.q) and torch.equal(made.scale, lin.scale)
    assert tq.dense_cls(True) is tq.QuantLinear
    assert tq.dense_cls(False) is tl.Linear


def test_default_targets_are_the_jax_regex():
    assert tq.DEFAULT_TARGETS.pattern == jq.DEFAULT_TARGETS.pattern
    for path, hit in (("enc1_res/time_proj/kernel", False),
                      ("joint_block0/x_block/moe/router/kernel", False),
                      ("joint_block0/x_block/proj/kernel", True),
                      ("mid_att/attn1/out/kernel", True),
                      ("block0/attn/q/kernel", True),
                      ("final_linear/kernel", False),
                      ("joint_block3/context_block/adaLN/kernel", False)):
        assert bool(tq.DEFAULT_TARGETS.search(path)) == hit, path
        assert bool(jq.DEFAULT_TARGETS.search(path)) == hit, path


# ---------------------------------------------------------------- modules
TOKENS = np.random.default_rng(6).integers(0, 100, (2, 11)).astype(np.int32)
MMDIT_KW = dict(depth=2, pos_embed_max_size=16, adm_in_channels=32,
                context_dim=48)
MMDIT_INPUTS = (_rand((2, 8, 12, 16), 10),
                np.asarray([999.0, 371.5], np.float32), _rand((2, 32), 11),
                _rand((2, 10, 48), 12))
T5_KW = dict(vocab_size=100, d_model=64, d_ff=128, num_layers=2, num_heads=4)
UNET_INPUTS = (_rand((2, 8, 8, 4), 8), _rand((2, 77, 768), 13),
               _rand((2, 320), 9))


def _case(name):
    """(JAX fp32 module, its int8 twin, port module factory taking
    ``int8_mm``, inputs)."""
    if name == "mmdit":
        jcfg = jmm.MMDiTConfig(**MMDIT_KW)
        return (jmm.MMDiT(jcfg),
                jmm.MMDiT(dataclasses.replace(jcfg, int8_mm=True)),
                lambda i8: tmm.MMDiT(tmm.MMDiTConfig(**MMDIT_KW,
                                                     int8_mm=i8)),
                MMDIT_INPUTS)
    if name == "t5":
        return (jte.T5Encoder(jte.T5Config(**T5_KW)),
                jte.T5Encoder(jte.T5Config(**T5_KW, int8_mm=True)),
                lambda i8: tte.T5Encoder(tte.T5Config(**T5_KW, int8_mm=i8)),
                (TOKENS,))
    return (jsd1.SD1UNet(model_channels=32, num_heads=4),
            jsd1.SD1UNet(model_channels=32, num_heads=4, int8_mm=True),
            lambda i8: tsd1.SD1UNet(model_channels=32, num_heads=4,
                                    int8_mm=i8),
            UNET_INPUTS)


def _torch_inputs(inputs):
    return [torch.from_numpy(np.array(a)).long()
            if np.issubdtype(a.dtype, np.integer)
            else torch.from_numpy(np.array(a)) for a in inputs]


def _quantized_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_path_str(k).rsplit("/", 1)[0] for k, _ in flat
            if _path_str(k).endswith("/q")}


@pytest.fixture(scope="module", params=["mmdit", "t5", "sd1_unet"])
def case(request):
    jmod, jint8, make, inputs = _case(request.param)
    params = jax_random_params(jmod, *(jnp.asarray(a) for a in inputs),
                               seed=7)
    qparams = jax.jit(jq.quantize_tree)(params)
    return request.param, jmod, jint8, make, inputs, params, qparams


def test_quantize_module_converts_what_quantize_tree_converts(case):
    name, _, _, make, _, params, qparams = case
    port = load_jax_params(make(False), params)
    converted = tq.quantize_module(port)
    want = _quantized_paths(qparams)
    assert {tq.flax_kernel_path(n).rsplit("/", 1)[0]
            for n in converted} == want
    assert want and all(isinstance(port.get_submodule(n), tq.QuantLinear)
                        for n in converted)
    # and nothing else: every other linear keeps its float weight
    for n, m in port.named_modules():
        if isinstance(m, torch.nn.Linear):
            assert not re.search(tq.DEFAULT_TARGETS,
                                 tq.flax_kernel_path(n)), n
    if name == "sd1_unet":
        assert isinstance(port.enc1_res.time_proj, torch.nn.Linear)
        assert not port.int8_mm
    # the same q / scale bits as the JAX tree, and the same state names as
    # the module built with int8_mm=True
    carried = load_jax_params(make(True), qparams)
    own, other = port.state_dict(), carried.state_dict()
    assert set(own) == set(other)
    for key in own:
        assert own[key].dtype == other[key].dtype, key
        assert torch.equal(own[key], other[key]), key


def test_int8_forward_matches_jax(case):
    name, _, jint8, make, inputs, _, qparams = case
    apply = jax.jit(jint8.apply)
    want = apply({"params": qparams}, *(jnp.asarray(a) for a in inputs))
    jitter = 0.0
    if np.issubdtype(inputs[0].dtype, np.floating):
        moved = apply({"params": qparams},
                      jnp.asarray(inputs[0] * np.float32(1 + 1e-6)),
                      *(jnp.asarray(a) for a in inputs[1:]))
        jitter = _rel_l2(moved, want)
    port = load_jax_params(make(True), qparams).eval()
    with torch.no_grad():
        got = port(*_torch_inputs(inputs))
    assert tuple(got.shape) == want.shape
    err = _rel_l2(got.numpy(), want)
    assert err <= max(2e-3, 3 * jitter), (name, err, jitter)


def test_int8_transformer_block_matches_jax():
    """One SD1 TransformerBlock (self- and cross-attention, GEGLU, all
    int8), the UNet's quantized unit, to 2e-3 on its own."""
    x, ctx = _rand((2, 8, 8, 64), 7), _rand((2, 77, 768), 13)
    params = jax_random_params(jl.TransformerBlock(num_heads=4),
                               jnp.asarray(x), jnp.asarray(ctx), seed=7)
    qparams = jax.jit(jq.quantize_tree)(params)
    want = jl.TransformerBlock(num_heads=4, int8_mm=True).apply(
        {"params": qparams}, jnp.asarray(x), jnp.asarray(ctx))
    port = load_jax_params(tl.TransformerBlock(64, 768, 4, int8_mm=True),
                           qparams)
    assert isinstance(port.attn2.k, tq.QuantLinear)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ctx))
    assert _rel_l2(got.numpy() - x, np.asarray(want) - x) <= 2e-3


def test_quantized_forward_stays_near_the_float_one(case):
    """A sanity bound, not a quality claim: W8A8 with per-channel and
    per-token scales keeps these random-weight forwards within 5e-2
    relative L2 of the fp32 forward."""
    _, _, _, make, inputs, params, _ = case
    port = load_jax_params(make(False), params).eval()
    with torch.no_grad():
        ref = port(*_torch_inputs(inputs))
        tq.quantize_module(port)
        got = port(*_torch_inputs(inputs))
    err = _rel_l2(got.numpy(), ref.numpy())
    assert 0 < err <= 5e-2
