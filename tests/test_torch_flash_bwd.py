"""Parity of the port's attention and GroupNorm gradients with the JAX
package's, on the CPU in fp32.

Flash attention: ``torch.autograd`` through the port's ``flash_attention``
on CPU tensors runs its plain backward (the CUDA kernels' oracle); the JAX
side is ``jax.grad`` of ``flash_attention(..., interpret=True)``, which runs
the Pallas ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` in interpret mode, and
the scanned XLA backward ``_vjp_bwd_xla``. Tolerance: atol 1e-4, rtol 1e-4
(fp32 sums over up to 256 keys taken in another order and block split).

GroupNorm: the port's autograd backward against the JAX ``_fused_bwd``
called directly (the same one-pass formulas: atol 2e-5) and against
``jax.grad`` of ``_group_norm_xla`` (two-pass statistics, whose gradient
differs from the one-pass recomputation in the last fp32 bits: atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from from_ddpm_to_stable_diffusion_tpu.ops import groupnorm as jgn
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as tgn

ATOL = RTOL = 1e-4


def _rand(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


FLASH_CASES = [(1, 2, 256, 256, 64), (1, 1, 200, 130, 32)]


@pytest.fixture(scope="module", params=FLASH_CASES, ids=str)
def flash_case(request):
    """Inputs, the upstream gradient, and the port's (dq, dk, dv)."""
    b, h, lq, lk, d = request.param
    q, k, v = (_rand((b, h, n, d), s, 0.7)
               for s, n in ((0, lq), (1, lk), (2, lk)))
    g = _rand((b, h, lq, d), 3)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*ts)
    out.backward(torch.from_numpy(g))
    return (q, k, v, g), [t.grad.numpy() for t in ts], out.detach().numpy()


def test_flash_grads_match_pallas_interpret(flash_case):
    (q, k, v, g), got, out = flash_case

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, block_q=128, block_k=128,
                                   interpret=True)

    jout, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out, np.asarray(jout), atol=ATOL, rtol=RTOL)
    for name, a, w in zip("qkv", got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


def test_flash_grads_match_xla_backward(flash_case):
    """One key block (block_k >= Lk): with several, ``_vjp_bwd_xla``
    reassembles dk and dv with ``moveaxis(blocks, 0, 3)``, which interleaves
    the key blocks (a fault of the JAX package, recorded in ROADMAP.md)."""
    (q, k, v, g), got, _ = flash_case
    scale = q.shape[-1] ** -0.5
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jfa._flash_fwd(jq, jk, jv, None, None, False, scale, 128, 128,
                              interpret=True)
    want = jfa._vjp_bwd_xla(False, scale, 128, 256,
                            (jq, jk, jv, None, None, out, lse),
                            jnp.asarray(g))[:3]
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


def test_flash_bwd_plain_takes_saved_residuals():
    """The plain backward from (out, lse) equals autograd of the plain
    softmax attention, and the Function saves what it needs."""
    q, k, v = (_rand((2, 2, 70, 16), s, 0.7) for s in (10, 11, 12))
    g = _rand((2, 2, 70, 16), 13)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    s = torch.matmul(ts[0], ts[1].transpose(-1, -2)) * 16 ** -0.5
    torch.matmul(torch.softmax(s, -1), ts[2]).backward(torch.from_numpy(g))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = tfa.flash_attention_plain(tq, tk, tv)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, out, lse,
                                        torch.from_numpy(g))
    for a, t in zip(got, ts):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_flash_backward_refuses_what_it_does_not_take():
    q = torch.zeros(1, 1, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_cuda(q, q, q, q, torch.zeros(1, 1, 64), q)
    n = (tfa.flash_attention_bwd_dq_cuda.launches,
         tfa.flash_attention_bwd_dkv_cuda.launches)
    x = torch.zeros(1, 1, 64, 128, requires_grad=True)
    tfa.flash_attention(x, x, x).sum().backward()
    assert (tfa.flash_attention_bwd_dq_cuda.launches,
            tfa.flash_attention_bwd_dkv_cuda.launches) == n


# ------------------------------------------------------------- GroupNorm
GN_CASES = [((2, 6, 5, 64), 8), ((2, 4, 4, 128), 32)]


def _gn_inputs(shape, seed):
    c = shape[-1]
    return (_rand(shape, seed, 2.0, 0.5), _rand((c,), seed + 1, 0.3, 1.0),
            _rand((c,), seed + 2, 0.2), _rand(shape, seed + 3))


def _port_gn_grads(x, s, b, dy, groups, act):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, s, b)]
    tgn.group_norm(*ts[:1], groups, *ts[1:], 1e-5, act).backward(
        torch.from_numpy(dy))
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("shape,groups", GN_CASES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_backward_matches_fused_bwd(shape, groups, act):
    x, s, b, dy = _gn_inputs(shape, 20)
    got = _port_gn_grads(x, s, b, dy, groups, act)
    want = jgn._fused_bwd(groups, 1e-5, act, tuple(map(jnp.asarray,
                                                       (x, s, b))),
                          jnp.asarray(dy))
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a, np.asarray(w), atol=2e-5, rtol=1e-5,
                                   err_msg=name)
    direct = tgn.group_norm_bwd_plain(*map(torch.from_numpy, (x, s, b, dy)),
                                      groups, 1e-5, act)
    for a, d in zip(got, direct):
        np.testing.assert_array_equal(a, d.numpy())


@pytest.mark.parametrize("shape,groups", GN_CASES)
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_backward_matches_jax_grad(shape, groups, act):
    x, s, b, dy = _gn_inputs(shape, 30)
    got = _port_gn_grads(x, s, b, dy, groups, act)
    _, vjp = jax.vjp(lambda x, s, b: jgn._group_norm_xla(x, groups, s, b,
                                                         1e-5, act),
                     *map(jnp.asarray, (x, s, b)))
    for name, a, w in zip(("dx", "dscale", "dbias"), got,
                          vjp(jnp.asarray(dy))):
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_group_norm_bf16_backward_keeps_dtypes():
    x, s, b, dy = _gn_inputs((2, 4, 4, 64), 40)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (s, b))
    tgn.group_norm(xt, 32, st, bt, 1e-5, "silu").backward(
        torch.from_numpy(dy).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    assert st.grad.dtype == bt.grad.dtype == torch.float32
    want = jgn._fused_bwd(32, 1e-5, "silu",
                          (jnp.asarray(x, jnp.bfloat16), jnp.asarray(s),
                           jnp.asarray(b)), jnp.asarray(dy, jnp.bfloat16))
    # bf16 x and dy: dx rounds to bf16 (rtol 1.6e-2 = two bf16 ulps);
    # dscale and dbias are fp32 sums of the same bf16 products
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(want[0], np.float32),
                               atol=1.6e-2, rtol=1.6e-2)
    for a, w in zip((st.grad, bt.grad), want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=1e-4)
