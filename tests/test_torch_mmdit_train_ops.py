"""Parity of the position-masked flash backward and the joint attention's
gradients with the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both frameworks. The JAX side
runs its Pallas kernels (``_bwd_dq_kernel_pos``, ``_bwd_dkv_kernel_pos``) in
interpret mode; the port runs its plain PyTorch versions (its CUDA kernels
take CUDA tensors only). The global lse and delta are made once, by the
port's plain forward, and handed to both.

Tolerances. fp32: each gradient to atol 2e-5 of its largest magnitude plus
rtol 1e-4 (block-wise against whole-row summation order, as the forward's
fp32 tolerance). bf16: 2e-2 of the largest magnitude, five bf16 ulps (both
sides round P and dS to bf16 before their products, and their outputs; a few
roundings flip). The joint attention's gradients in fp32 against ``jax.grad``
through the JAX ``joint_flash_attention`` and against autograd through the
port's plain attention over the concatenated sequence: the same fp32 bound
(the partials are rounded to the input dtype and summed in fp32 on both
sides, exactly in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as tattn
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _i32(*xs):
    return np.asarray(xs, np.int32)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(a)).to(dtype)
            if np.asarray(a).dtype.kind == "f" else torch.from_numpy(a)
            for a in arrays]


def _close(got, want, rel, rtol=0.0):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel * max(np.abs(want).max(), 1e-3))


def _global_stats(q, kv_blocks, g, q_off, kv_offs, **kw):
    """lse of ``q`` over all ``kv_blocks`` and delta = Σ dO·out with the
    merged output, by the port's plain forward (fp32 tensors in, numpy
    out)."""
    out, lse = tfa.flash_attention_pos_plain(q, *kv_blocks[0], q_off,
                                             kv_offs[0], **kw)
    for (k, v), ko in zip(kv_blocks[1:], kv_offs[1:]):
        out, lse = tfa.merge_attention_partials(
            out, lse, *tfa.flash_attention_pos_plain(q, k, v, q_off, ko, **kw))
    return lse.numpy(), (g.float() * out.float()).sum(-1).numpy()


def _compare_bwd(q, k, v, g, lse, delta, q_off, kv_off, dtype="float32",
                 **kw):
    """flash_bwd_pos of the port (plain, CPU) against the Pallas kernels in
    interpret mode on the same numpy inputs."""
    jdt = jnp.dtype(dtype)
    want = jfa.flash_bwd_pos(
        *(jnp.asarray(a, jdt) for a in (q, k, v, g)), jnp.asarray(lse),
        jnp.asarray(delta), jnp.asarray(q_off), jnp.asarray(kv_off),
        block_q=128, block_k=128, interpret=True, **kw)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = _t(q, k, v, g, dtype=tdt)
    got = tfa.flash_bwd_pos(tq, tk, tv, tg, *_t(lse, delta, q_off, kv_off),
                            **kw)
    rel, rtol = (2e-5, 1e-4) if dtype == "float32" else (2e-2, 0.0)
    for a, w, x in zip(got, want, (tq, tk, tv)):
        assert a.dtype == tdt and a.shape == x.shape
        _close(a, w, rel, rtol)
    return got


# ------------------------------------------- flash_bwd_pos, one key block
@pytest.mark.parametrize("lq,lk,d", [(154, 154, 64), (154, 256, 64),
                                     (256, 154, 64), (130, 200, 128)])
def test_flash_bwd_pos_ragged_lengths_match_jax(lq, lk, d):
    """SD3's 154-token context stream and a ragged x stream, offsets 0, no
    mask, head dims 64 and 128; also equal to the unmasked plain backward."""
    q, g = _rand((2, 2, lq, d), 1, 0.7), _rand((2, 2, lq, d), 2)
    k, v = _rand((2, 2, lk, d), 3, 0.7), _rand((2, 2, lk, d), 4)
    z = _i32(0, 0)
    tq, tk, tv, tg, tz = _t(q, k, v, g, z)
    lse, delta = _global_stats(tq, [(tk, tv)], tg, tz, [tz])
    got = _compare_bwd(q, k, v, g, lse, delta, z, z)
    out, lse1 = tfa.flash_attention_plain(tq, tk, tv)
    for a, w in zip(got, tfa.flash_attention_bwd_plain(tq, tk, tv, out, lse1,
                                                       tg)):
        _close(a, w.numpy(), 2e-5, 1e-4)


@pytest.mark.parametrize("causal,valid_len", [(True, None), (False, 200),
                                              (True, 200)])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_bwd_pos_two_segments_match_jax(causal, valid_len, d):
    """The zig-zag chunk layout of the forward's test: local blocks made of
    global chunks [256, 320) + [448, 512) and [64, 128) + [384, 448)."""
    q, g = _rand((1, 2, 128, d), 10, 0.7), _rand((1, 2, 128, d), 11)
    k, v = _rand((1, 2, 128, d), 12, 0.7), _rand((1, 2, 128, d), 13)
    q_off, kv_off = _i32(256, 448), _i32(64, 384)
    kw = dict(causal=causal, valid_len=valid_len, seg_q=64, seg_k=64)
    tq, tk, tv, tg, tqo, tko = _t(q, k, v, g, q_off, kv_off)
    lse, delta = _global_stats(tq, [(tk, tv)], tg, tqo, [tko], **kw)
    assert (lse > -1e29).all()
    _compare_bwd(q, k, v, g, lse, delta, q_off, kv_off, **kw)


def test_flash_bwd_pos_bf16_matches_jax():
    q, g = _rand((1, 2, 154, 64), 20, 0.7), _rand((1, 2, 154, 64), 21)
    k, v = _rand((1, 2, 200, 64), 22, 0.7), _rand((1, 2, 200, 64), 23)
    z = _i32(0, 0)
    bf = torch.bfloat16
    tq, tk, tv, tg = _t(q, k, v, g, dtype=bf)
    (tz,) = _t(z)
    lse, delta = _global_stats(tq, [(tk, tv)], tg, tz, [tz])
    _compare_bwd(q, k, v, g, lse, delta, z, z, dtype="bfloat16")


# ------------------------------ under a lse that is global over two blocks
@pytest.mark.parametrize("causal,valid_len", [(True, None), (True, 450),
                                              (False, 0)])
def test_flash_bwd_pos_global_lse_and_masked_rows(causal, valid_len):
    """Two key blocks at different positions. Causal: the first q segment
    sees a key only in the first block (masked in one partial only);
    valid_len = 0: no row sees a key anywhere (lse = -1e30, where
    exp(s - lse) overflows): finite gradients, zero where nothing is
    visible, on both sides; the partial dq of the two blocks add up to the
    gradient of attention over both."""
    lq, lk, d = 200, 170, 64
    q, g = _rand((1, 2, lq, d), 30, 0.7), _rand((1, 2, lq, d), 31)
    blocks = [(_rand((1, 2, lk, d), 32 + 2 * i, 0.7),
               _rand((1, 2, lk, d), 33 + 2 * i)) for i in range(2)]
    q_off, kv_offs = _i32(128, 640), [_i32(0, 100), _i32(400, 900)]
    kw = dict(causal=causal, valid_len=valid_len, seg_q=128, seg_k=100)
    tq, tg, tqo = _t(q, g, q_off)
    tblocks = [tuple(_t(k, v)) for k, v in blocks]
    tkos = [_t(ko)[0] for ko in kv_offs]
    lse, delta = _global_stats(tq, tblocks, tg, tqo, tkos, **kw)
    seen = lse > -1e29
    if valid_len == 0:
        assert not seen.any()
    else:
        assert seen.all()
        _, lse2 = tfa.flash_attention_pos_plain(tq, *tblocks[1], tqo, tkos[1],
                                                **kw)
        assert not (lse2.numpy() > -1e29)[:, :, :128].any()
    dq_sum = 0.0
    for (k, v), ko in zip(blocks, kv_offs):
        dq, dk, dv = _compare_bwd(q, k, v, g, lse, delta, q_off, ko, **kw)
        dq_sum = dq_sum + dq
        if valid_len == 0:
            assert not (dq.any() or dk.any() or dv.any())
    if valid_len == 0:
        return
    # against autograd through explicit masked attention over both blocks
    qa = tq.clone().requires_grad_()
    pos = lambda n, off, seg: tfa._positions(n, off, seg)
    col = torch.cat([pos(lk, ko, 100) for ko in tkos])
    vis = col[None, :] <= pos(lq, tqo, 128)[:, None]
    if valid_len is not None:
        vis &= (col < valid_len)[None, :]
    kk = torch.cat([b[0] for b in tblocks], dim=2)
    vv = torch.cat([b[1] for b in tblocks], dim=2)
    s = (qa @ kk.transpose(-1, -2)) * d ** -0.5
    out = torch.softmax(s.masked_fill(~vis, float("-inf")), -1) @ vv
    (want,) = torch.autograd.grad(out, qa, tg)
    _close(dq_sum, want.numpy(), 2e-5, 1e-4)


def test_pos_backward_wrappers_take_only_cuda_tensors():
    """On the CPU the public entry runs the plain version; the kernel
    entries refuse and their counters stay put."""
    q = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
    st = torch.zeros(1, 1, 64)
    z = torch.zeros(2, dtype=torch.int32)
    n = (tfa.flash_bwd_pos_dq_cuda.launches,
         tfa.flash_bwd_pos_dkv_cuda.launches)
    got = tfa.flash_bwd_pos(q, q, q, q, st, st, z, z)
    assert all(a.dtype == torch.bfloat16 and a.shape == q.shape for a in got)
    with pytest.raises(ValueError):
        tfa.flash_bwd_pos_dq_cuda(q, q, q, q, st, st, z, z)
    with pytest.raises(ValueError):
        tfa.flash_bwd_pos_dkv_cuda(q, q, q, q, st, st, z, z)
    assert n == (tfa.flash_bwd_pos_dq_cuda.launches,
                 tfa.flash_bwd_pos_dkv_cuda.launches)


# --------------------------------------- gradients of the joint attention
@pytest.mark.parametrize("stability", ["online", "bounded"])
@pytest.mark.parametrize("lc,lx", [(26, 256), (154, 300)])
def test_joint_flash_attention_gradients_match_jax(stability, lc, lx):
    """d/d(q, k, v of both streams) of Σ out·g: the port's autograd Function
    (plain versions on the CPU) against ``jax.grad`` through the JAX
    package's custom VJP (Pallas kernels in interpret mode) and against
    autograd through plain attention over the concatenated sequence."""
    b, h, d = 2, 2, 32
    arrays = ([_rand((b, h, lc, d), 40 + i, 0.7) for i in range(3)]
              + [_rand((b, h, lx, d), 44 + i, 0.7) for i in range(3)])
    g_c, g_x = _rand((b, h, lc, d), 48), _rand((b, h, lx, d), 49)

    def jloss(*ts):
        o_c, o_x = jfa.joint_flash_attention(*ts, d ** -0.5, 128, 128, True,
                                             stability)
        return jnp.sum(o_c * g_c) + jnp.sum(o_x * g_x)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, arrays))
    ts = [t.requires_grad_() for t in _t(*arrays)]
    o_c, o_x = tfa.joint_flash_attention(*ts, d ** -0.5, stability)
    tg_c, tg_x = _t(g_c, g_x)
    got = torch.autograd.grad((o_c, o_x), ts, (tg_c, tg_x))
    q, k, v = (torch.cat(ab, dim=2) for ab in zip(ts[:3], ts[3:]))
    ref = torch.autograd.grad(tattn.plain_attention(q, k, v), ts,
                              torch.cat([tg_c, tg_x], dim=2))
    for a, w, r in zip(got, want, ref):
        _close(a, w, 2e-5, 1e-4)
        _close(a, r.numpy(), 2e-5, 1e-4)


def test_joint_attention_blhd_gradients_through_dispatch():
    """(B, L, H, D) triples that are views of fused (B, L, 3, H, D)
    projections, as the MMDiT passes them: on the CPU the dispatch takes the
    concatenated plain attention; the Function gives the same gradients."""
    b, h, d, lc, lx = 1, 2, 16, 10, 40
    fused = [t.requires_grad_() for t in _t(_rand((b, lc, 3, h, d), 60, 0.7),
                                            _rand((b, lx, 3, h, d), 61, 0.7))]
    ctx, x = ([f[:, :, i] for i in range(3)] for f in fused)
    g_c, g_x = _t(_rand((b, lc, h, d), 62), _rand((b, lx, h, d), 63))
    want = torch.autograd.grad(tattn.joint_attention_blhd(ctx, x), fused,
                               (g_c, g_x))
    o_c, o_x = tfa.joint_flash_attention(
        *(a.transpose(1, 2) for a in (*ctx, *x)))
    got = torch.autograd.grad((o_c.transpose(1, 2), o_x.transpose(1, 2)),
                              fused, (g_c, g_x))
    for a, w in zip(got, want):
        _close(a, w.numpy(), 2e-5, 1e-4)


def test_joint_flash_attention_bf16_gradients_are_finite_and_close():
    """bf16 through the Function on the CPU against fp32 plain attention
    over the concatenated sequence: 4e-2 of each gradient's largest
    magnitude (bf16 forward outputs, bf16 P and dS, two bf16 partials
    summed and rounded again)."""
    b, h, d, lc, lx = 1, 2, 64, 20, 150
    arrays = ([_rand((b, h, lc, d), 70 + i, 0.7) for i in range(3)]
              + [_rand((b, h, lx, d), 74 + i, 0.7) for i in range(3)])
    g_c, g_x = _rand((b, h, lc, d), 78), _rand((b, h, lx, d), 79)
    bf = torch.bfloat16
    ts = [t.requires_grad_() for t in _t(*arrays, dtype=bf)]
    o_c, o_x = tfa.joint_flash_attention(*ts)
    assert o_c.dtype == bf
    got = torch.autograd.grad((o_c, o_x), ts, tuple(_t(g_c, g_x, dtype=bf)))
    fs = [t.detach().float().requires_grad_() for t in ts]
    q, k, v = (torch.cat(ab, dim=2) for ab in zip(fs[:3], fs[3:]))
    gg = torch.cat(_t(g_c, g_x, dtype=bf), dim=2).float()
    ref = torch.autograd.grad(tattn.plain_attention(q, k, v), fs, gg)
    for a, r in zip(got, ref):
        assert a.dtype == bf
        _close(a, r.numpy(), 4e-2)
