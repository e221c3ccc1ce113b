"""Parity of the port's sequence-parallel attention (``parallel/
ring_attention.py``) with the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices (``devices8``), the port on
one-process meshes of the host device repeated (mesh form (a)). Inputs are
numpy draws from a seed, fp32.

- The ring forward at n = 2, 4 and 8, non-causal, causal (zig-zag) and with
  a ragged ``kv_valid_len``: the port's ``impl="flash"`` (the plain version
  of K5 under the real hop offsets, n² calls, each checked) and
  ``impl="xla"`` against JAX ``impl="xla"``, within 2e-5 as
  ``tests/test_ring_attention.py``.
- The ring gradients (dq, dk, dv) of the port's flash ring (plain K6 / K7
  under the merged lse, n² calls each) and of its xla ring against JAX's
  custom VJP (the Pallas kernels in interpret mode), within 1e-4 as
  ``test_ring_flash_grads``.
- ``zigzag_order`` equal to JAX's; Ulysses with and without
  ``kv_valid_len`` within 2e-5; a head count that does not divide raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh as jmesh
from from_ddpm_to_stable_diffusion_tpu.parallel import ring_attention as jring
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import (
    ring_attention as tring)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

FORMS = {"plain": {}, "causal": {"causal": True},
         "ragged": {"kv_valid_len": 50}}


def _qkv(b=1, h=2, l=64, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, l, d)).astype(np.float32)
            for _ in range(3)]


def _cpu_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return build_mesh(shape, [torch.device("cpu")] * n)


class _Calls:
    """Counts the calls of a plain kernel version and keeps the offsets."""

    def __init__(self, monkeypatch, name):
        self.offsets = []
        real = getattr(tfa, name)

        def counted(*a, **kw):
            self.offsets.append((a[-2].tolist(), a[-1].tolist()))
            return real(*a, **kw)

        monkeypatch.setattr(tfa, name, counted)


def _hop_offsets(n, l, causal):
    """The (q offsets, kv offsets) pairs of every hop of every shard, in
    the port's order: shard by shard at hop h (the offsets of JAX
    ``_chunk_offsets``)."""
    l_local, half = l // n, l // (2 * n)
    offs = lambda s: ([s * half, (2 * n - 1 - s) * half] if causal
                      else [s * l_local, 0])
    return [(offs(me), offs((me - h) % n)) for h in range(n)
            for me in range(n)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_forward_matches_jax(devices8, monkeypatch, n):
    q, k, v = _qkv(seed=n)
    mesh = jmesh({"seq": n}, devices8[:n])
    want = jax.jit(lambda q, k, v: [
        jring.ring_attention(q, k, v, mesh, impl="xla", **kw)
        for kw in FORMS.values()])(q, k, v)
    tmesh = _cpu_mesh({"seq": n})
    for (name, kw), w in zip(FORMS.items(), want):
        rows = kw.get("kv_valid_len", 64)
        calls = _Calls(monkeypatch, "flash_attention_pos_plain")
        for impl in ("flash", "xla"):
            got = tring.ring_attention(*map(torch.from_numpy, (q, k, v)),
                                       tmesh, impl=impl, **kw)
            np.testing.assert_allclose(got.numpy()[:, :, :rows],
                                       np.asarray(w)[:, :, :rows],
                                       atol=2e-5, err_msg=f"{name} {impl}")
        assert calls.offsets == _hop_offsets(n, 64, name == "causal"), name


@pytest.mark.parametrize("n, form", [(2, "ragged"), (4, "causal"),
                                     (8, "plain")])
def test_ring_gradients_match_jax_custom_vjp(devices8, monkeypatch, n,
                                             form):
    kw = FORMS[form]
    q, k, v = _qkv(l=64, seed=20 + n)
    cot = np.random.default_rng(25).standard_normal(q.shape).astype(
        np.float32)
    mesh = jmesh({"seq": n}, devices8[:n])
    f = lambda q, k, v: (jring.ring_attention(
        q, k, v, mesh, impl="flash", interpret=True, **kw) * cot).sum()
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    tmesh = _cpu_mesh({"seq": n})
    for impl in ("flash", "xla"):
        dq = _Calls(monkeypatch, "flash_bwd_pos_plain")
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = tring.ring_attention(*xs, tmesh, impl=impl, **kw)
        (out * torch.from_numpy(cot)).sum().backward()
        for name, x, w in zip("qkv", xs, want):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                       atol=1e-4, err_msg=f"d{name} {impl}")
        # the flash ring's backward: n hops of K6 + K7 per shard
        assert len(dq.offsets) == (n * n if impl == "flash" else 0)


@pytest.mark.parametrize("l, n", [(64, 4), (32, 2), (128, 8), (48, 3)])
def test_zigzag_order_matches_jax(l, n):
    perm, inv = tring.zigzag_order(l, n)
    jperm, jinv = jring.zigzag_order(l, n)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def test_ring_rejects_lengths_that_do_not_divide():
    q, k, v = map(torch.from_numpy, _qkv(l=60))
    with pytest.raises(ValueError, match="multiple"):
        tring.ring_attention(q, k, v, _cpu_mesh({"seq": 8}))
    with pytest.raises(ValueError, match="2\\*8"):
        tring.ring_attention(*map(torch.from_numpy, _qkv(l=72)),
                             _cpu_mesh({"seq": 8}), causal=True)


def test_ulysses_matches_jax(devices8):
    q, k, v = _qkv(h=4, seed=6)
    mesh = jmesh({"seq": 4}, devices8[:4])
    want = jax.jit(lambda q, k, v: [
        jring.ulysses_attention(q, k, v, mesh, kv_valid_len=valid)
        for valid in (None, 50)])(q, k, v)
    tmesh = _cpu_mesh({"seq": 4})
    for valid, w in zip((None, 50), want):
        got = tring.ulysses_attention(*map(torch.from_numpy, (q, k, v)),
                                      tmesh, kv_valid_len=valid)
        rows = valid or 64
        np.testing.assert_allclose(got.numpy()[:, :, :rows],
                                   np.asarray(w)[:, :, :rows], atol=2e-5)


def test_ulysses_gradients_match_jax(devices8):
    q, k, v = _qkv(h=4, l=32, seed=7)
    mesh = jmesh({"seq": 2}, devices8[:2])
    f = lambda q, k, v: jnp.sum(jring.ulysses_attention(
        q, k, v, mesh, kv_valid_len=30) ** 2)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tring.ulysses_attention(*xs, _cpu_mesh({"seq": 2}), kv_valid_len=30)
     ** 2).sum().backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=1e-4)


def test_ulysses_rejects_bad_head_count():
    q, k, v = map(torch.from_numpy, _qkv(h=4))
    with pytest.raises(ValueError, match="heads 4"):
        tring.ulysses_attention(q, k, v, _cpu_mesh({"seq": 8}))
