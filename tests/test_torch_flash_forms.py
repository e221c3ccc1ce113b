"""The flash forms the port's kernels take in fp32 and at every head dim:
the port's plain versions (the CUDA kernels' oracle on the card) against the
Pallas kernels of the JAX package run in interpret mode, at the cases of
``tests/test_flash_attention.py`` that the other parity files do not hold
already, and the segment-id tile ranges the wrapper builds for the fp32
kernels against a brute-force count of the visible pairs.

Already held elsewhere: a bias at head dim 64 in three broadcast shapes,
segment ids with a bias and their gradients, causal with segment ids
(``tests/test_torch_flash_masks.py``); ``flash_attention_pos`` with two
segments at head dim 32 (``tests/test_torch_sd3_ops.py``); the joint
attention online and bounded at head dim 32 (the same file). Added here:
the fp32 bias at head dim 128 (``test_flash_matches_xla``'s bias case), the
bias gradients with dbias at the three bias shapes of
``test_flash_bias_grads_pallas``, and ``test_bounded_stability_matches_online``
at head dims 32 and 128 (bounded against the Pallas kernels, online and
bounded, forward, lse, fully masked rows and the joint attention's
gradients).

Tolerances, the JAX tests' own: outputs and lse to 5e-5 absolute (fp32 sums
in another order and block split); gradients to 3e-4 absolute and 1e-3
relative.

The fp32 kernels walk segment-id tiles of their own sizes (the resident
forward 128 or 64 queries by 64 or 32 keys, the streaming one 64 by 64, the
backward's one-block and two-block kernels theirs): a tile range built at
another size would skip tiles that hold visible pairs, silently. The tile
test walks, for each fp32 kernel at each of its widths, the tile pairs the
ranges and bounds admit and counts the visible pairs in them: every visible
pair of a ragged packing must be in one.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

OUT_ATOL = 5e-5
GRAD_ATOL, GRAD_RTOL = 3e-4, 1e-3


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jax_flash(q, k, v, bias):
    return jfa.flash_attention(q, k, v, bias=bias, block_q=128, block_k=128,
                               interpret=True)


# ------------------------------------------------------------ fp32 bias
def test_fp32_bias_at_head_dim_128_matches_pallas():
    """``test_flash_matches_xla``'s bias case, (1, 2, 128, 256, 128) with a
    (1, 2, 128, 256) bias, forward and gradients (dbias too)."""
    q, k, v = (_rand((1, 2, n, 128), s) for s, n in ((0, 128), (1, 256),
                                                      (2, 256)))
    bias = _rand((1, 2, 128, 256), 3, 0.5)
    g = _rand((1, 2, 128, 128), 4)
    jout, vjp = jax.vjp(_jax_flash, *map(jnp.asarray, (q, k, v, bias)))
    jgrads = vjp(jnp.asarray(g))
    tin = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    tout = tfa.flash_attention(*tin[:3], bias=tin[3])
    tout.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=OUT_ATOL, rtol=0)
    for t, w in zip(tin, jgrads):
        assert t.grad.shape == w.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("bias_shape", [(1, 2, 128, 128), (2, 2, 128, 128),
                                        (1, 1, 128, 128)])
def test_fp32_bias_grads_over_broadcast_shapes_match_pallas(bias_shape):
    """``test_flash_bias_grads_pallas``: dq, dk, dv and dbias, the latter
    summed over the bias's broadcast axes, against the Pallas backward."""
    q, k, v = (_rand((2, 2, 128, 64), s) for s in (20, 21, 22))
    bias = _rand(bias_shape, 23, 0.5)
    cot = _rand((2, 2, 128, 64), 24)

    def f(q, k, v, bias):
        return (_jax_flash(q, k, v, bias) * cot).sum()

    jgrads = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                    (q, k, v, bias)))
    tin = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    (tfa.flash_attention(*tin[:3], bias=tin[3])
     * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(tin, jgrads):
        assert t.grad.shape == w.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


# ------------------------------------------- the bounded softmax at 32, 128
@pytest.mark.parametrize("d", [32, 128])
def test_bounded_stability_matches_pallas(d):
    """``test_bounded_stability_matches_online``: flash_attention_pos with
    valid_len 200 of 256 keys, online and bounded, against the Pallas
    kernels (out and lse); a fully masked row keeps lse <= -1e30; the joint
    attention's gradients, bounded, against the Pallas ones."""
    l = 256
    q, k, v = (_rand((1, 2, l, d), 90 + i, 0.5) for i in range(3))
    kw = dict(block_q=128, block_k=128, interpret=True)
    jz, tz = jnp.zeros((2,), jnp.int32), torch.zeros(2, dtype=torch.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for stability in ("online", "bounded"):
        want, want_lse = jfa.flash_attention_pos(
            *map(jnp.asarray, (q, k, v)), jz, jz, valid_len=200,
            stability=stability, **kw)
        got, got_lse = tfa.flash_attention_pos(tq, tk, tv, tz, tz,
                                               valid_len=200,
                                               stability=stability)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=OUT_ATOL, rtol=0)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                                   atol=OUT_ATOL, rtol=0)
    out, lse = tfa.flash_attention_pos(tq, tk, tv, tz, tz, valid_len=0,
                                       stability="bounded")
    assert float(lse.max()) <= tfa.NEG_INF and not out.any()

    cot = _rand((1, 2, l, d), 95)
    xs = [_rand((1, 2, l, d), 96 + i, 0.5) for i in range(3)]
    args = (q, k, v, *xs)

    def f(*a):
        oc, ox = jfa.joint_flash_attention(*a, d ** -0.5, 128, 128, True,
                                           "bounded")
        return (oc * cot).sum() + (ox * cot).sum()

    want = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    tin = [torch.from_numpy(a).requires_grad_() for a in args]
    oc, ox = tfa.joint_flash_attention(*tin, d ** -0.5, "bounded")
    tc = torch.from_numpy(cot)
    ((oc * tc).sum() + (ox * tc).sum()).backward()
    for t, w in zip(tin, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


# ------------------------------------------------ the fp32 segment tiles
def _ragged_ids(b, n, seed):
    """(B, n) int32: each row packs a different number of sorted ragged
    sequences, cut at random places, and ends in a padding run of id -1."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(b):
        n_seq = 3 + 2 * i
        pad = int(rng.integers(0, 40))
        cuts = np.sort(rng.choice(np.arange(1, n - pad - 1), n_seq - 1,
                                  replace=False))
        ids = np.repeat(np.arange(n_seq), np.diff(
            np.concatenate([[0], cuts, [n - pad]])))
        rows.append(np.concatenate([ids, np.full(pad, -1)]))
    return torch.from_numpy(np.stack(rows).astype(np.int32))


# (kernel, padded head dim d): every width the fp32 ANY forms run at
F32_TILE_CASES = [(kern, d) for kern in ("k1", "k3", "k4")
                  for d in (8, 32, 40, 64, 96, 128, 136, 160, 192, 224, 256)]


@pytest.mark.parametrize("kernel,d", F32_TILE_CASES)
def test_fp32_segment_tiles_cover_every_visible_pair(kernel, d):
    """The ranges and bounds built at ``_f32_tiles(kernel, d)``, walked as
    the fp32 kernel walks them (the loop range [lo, hi] of the axis its grid
    runs over, then the overlap of the two tiles' id ranges), admit tile
    pairs that hold every visible pair, counted by brute force."""
    b, lq, lk = 3, 611, 437
    q_ids, kv_ids = _ragged_ids(b, lq, 7), _ragged_ids(b, lk, 8)
    # ids past the shorter axis: the keys are a prefix of the same packing
    kv_ids = torch.where(kv_ids >= 0, kv_ids, -2)
    q = torch.zeros(b, 1, lq, d)
    bq, bk = tfa._f32_tiles(kernel, d)
    over = "k" if kernel == "k4" else "q"
    _, _, q_bounds, kv_bounds, lo, hi = tfa._seg_kernel_args(
        (q_ids, kv_ids), q, lk, (bq, bk), over)
    same = (q_ids[:, :, None] == kv_ids[:, None, :]).numpy()
    n_q, n_k = -(-lq // bq), -(-lk // bk)
    walked = 0
    for bi in range(b):
        for qi in range(n_q):
            for ki in range(n_k):
                self_, other = (qi, ki) if over == "q" else (ki, qi)
                if not lo[bi, self_] <= other <= hi[bi, self_]:
                    continue
                qb, kb = q_bounds[bi, qi], kv_bounds[bi, ki]
                if qb[0] <= kb[1] and kb[0] <= qb[1]:
                    walked += int(same[bi, qi * bq:(qi + 1) * bq,
                                       ki * bk:(ki + 1) * bk].sum())
    assert walked == int(same.sum()) > 0


def _csrc(name):
    return " ".join((_build.CSRC / name).read_text().split())


def test_fp32_tile_function_is_the_kernels_tiles():
    """``_f32_tiles`` states the tiles of the kernels' Cfgs: the rules in
    the fp32 sources, and the width each form runs at (the head dim rounded
    up to 32)."""
    fwd = _csrc("fp32/flash_f32_fwd.cuh")
    for rule in ("kCons = DP <= 128 ? 2 : 1", "kBQ = 64 * kCons",
                 "kBK = DP >= 80 ? 32 : 64",
                 "#define FDSD_F32_FWD_MASK_WIDTHS(X) X(32) X(64) X(96) "
                 "X(128) X(160)"):
        assert rule in fwd, rule
    assert "static constexpr int kBQ = 64, kBK = 64, kHalf" in _csrc(
        "fp32/flash_f32_fwd_wide.cuh")
    bwd = _csrc("fp32/flash_f32_bwd.cuh")
    for rule in ("kCons = DP <= 64 ? 2 : 1", "kBQ = 64 * kCons, kBK = 32",
                 "kBKey = 64 * kCons", "kBQ = DP <= 64 ? 32 : 16",
                 "kBQ = 64, kBK = DP <= 192 ? 32 : 16", "kBKey = 64;",
                 "kBQ = DP <= 160 ? 32 : 16",
                 "X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256)"):
        assert rule in bwd, rule
    assert re.search(r"return run_masks<decltype\(dp\)::value>\(false",
                     _csrc("fp32/flash_f32_fwd.cu"))
    want = {("k1", 8): (128, 64), ("k1", 64): (128, 64),
            ("k1", 96): (128, 32), ("k1", 160): (64, 32),
            ("k1", 192): (64, 64), ("k3", 64): (128, 32),
            ("k3", 128): (64, 32), ("k3", 192): (64, 32),
            ("k3", 224): (64, 16), ("k4", 64): (32, 128),
            ("k4", 96): (16, 64), ("k4", 160): (32, 64),
            ("k4", 256): (16, 64)}
    for (kern, d), tiles in want.items():
        assert tfa._f32_tiles(kern, d) == tiles, (kern, d)
