"""The causal, bias and segment-id forms of the port's ``flash_attention``
against the Pallas kernels of the JAX package run in interpret mode
(``_fwd_kernel``, ``_bwd_dq_kernel`` with its dbias tiles,
``_bwd_dkv_kernel``), on the CPU, where the port runs its plain versions:
the CUDA kernels' oracle.

Never against ``_vjp_bwd_xla``, whose dk and dv are wrong for more than one
key block (ROADMAP.md, queue C). The same inputs, from a numpy seed, go to
both; the JAX side runs at block 128 so that the cases span several blocks.

Tolerances. fp32: outputs (of order 1) to 2e-5 absolute; gradients to 1e-4
absolute and relative (fp32 sums over up to 768 keys taken in another order
and block split, as ``tests/test_torch_flash_bwd.py``). bf16: outputs to
2e-2 absolute, gradients to 2e-2 of each gradient's largest magnitude (five
bf16 ulps: both sides round P and dS to bf16 before their products).

Rows that see no key: the port gives out = 0 where the Pallas online body
gives the mean of the visited v (a masked logit there is exp(-1e30 - max)
with max = -1e30, so every visited key weighs 1); both backward passes give
such a row no gradient. The tests hold each side to its own contract on
those rows and compare everything else.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.ops import attention as jattn
from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as tattn
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _ids(kind, b, lq, lk):
    """(q_ids, kv_ids) int32 numpy, or None."""
    if kind is None:
        return None
    iq, ik = np.arange(lq), np.arange(lk)
    if kind == "two":            # 70 + the rest, as the JAX tests pack them
        f = lambda i: (i >= 70).astype(np.int32)
    elif kind == "many":         # short segments, boundaries off the blocks
        f = lambda i: (i // 96).astype(np.int32)
    elif kind == "ragged":       # per-example lengths through a padding id
        lens_q = [lq - 28 - 23 * i for i in range(b)]
        lens_k = [lk - 28 - 23 * i for i in range(b)]
        return (np.stack([np.where(iq < n, 0, -1) for n in lens_q]).astype(
                    np.int32),
                np.stack([np.where(ik < n, 0, -1) for n in lens_k]).astype(
                    np.int32))
    elif kind == "no key":       # segment 9 has queries and no key
        q = np.where(iq % 37 == 5, 9, iq // 100).astype(np.int32)
        return (np.broadcast_to(q, (b, lq)).copy(),
                np.broadcast_to((ik // 100).astype(np.int32), (b, lk)).copy())
    return (np.broadcast_to(f(iq), (b, lq)).copy(),
            np.broadcast_to(f(ik), (b, lk)).copy())


# name: (b, h, lq, lk, d, causal, bias shape's (B, H) or None, ids, dtype)
CASES = {
    "causal": (1, 2, 256, 256, 64, True, None, None, "fp32"),
    "causal_ragged_584": (1, 2, 584, 584, 64, True, None, None, "fp32"),
    "causal_lq_gt_lk": (1, 2, 300, 130, 32, True, None, None, "fp32"),
    "causal_lq_lt_lk": (1, 2, 130, 300, 32, True, None, None, "fp32"),
    "bias_11": (2, 2, 128, 256, 64, False, (1, 1), None, "fp32"),
    "bias_1h": (2, 2, 128, 256, 64, False, (1, 2), None, "fp32"),
    "bias_bh": (2, 2, 128, 256, 64, False, (2, 2), None, "fp32"),
    "bias_causal_ragged": (1, 2, 200, 200, 32, True, (1, 2), None, "fp32"),
    "segments": (1, 2, 128, 128, 32, False, None, "two", "fp32"),
    "segments_causal": (1, 2, 128, 128, 32, True, None, "two", "fp32"),
    "segments_bias": (1, 2, 128, 128, 32, False, (1, 2), "two", "fp32"),
    "segments_bias_causal": (2, 2, 300, 300, 32, True, (1, 1), "many", "fp32"),
    "many_segments": (1, 2, 768, 768, 32, False, None, "many", "fp32"),
    "many_segments_causal": (1, 2, 768, 768, 32, True, None, "many", "fp32"),
    "ragged_padding_ids": (2, 2, 128, 128, 32, False, None, "ragged", "fp32"),
    "row_without_key": (1, 2, 300, 300, 32, False, None, "no key", "fp32"),
    "row_without_key_causal": (1, 2, 300, 300, 32, True, None, "no key",
                               "fp32"),
    "causal_bf16": (1, 2, 256, 256, 64, True, None, None, "bf16"),
    "bias_segments_bf16": (1, 2, 256, 256, 64, False, (1, 2), "many", "bf16"),
}


@functools.lru_cache(maxsize=None)
def _both(name):
    """Forward and gradients of one case from both packages."""
    b, h, lq, lk, d, causal, bias_bh, kind, dtype = CASES[name]
    q, k, v = (_rand((b, h, n, d), s, 0.7)
               for s, n in ((0, lq), (1, lk), (2, lk)))
    g = _rand((b, h, lq, d), 3)
    bias = None if bias_bh is None else _rand((*bias_bh, lq, lk), 4, 0.5)
    ids = _ids(kind, b, lq, lk)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32

    jin = [jnp.asarray(a, jdt) for a in (q, k, v)]
    jbias = None if bias is None else jnp.asarray(bias)
    jids = None if ids is None else tuple(map(jnp.asarray, ids))

    def f(q, k, v, bias):
        return jfa.flash_attention(q, k, v, bias=bias, segment_ids=jids,
                                   causal=causal, block_q=128, block_k=128,
                                   interpret=True)

    jout, vjp = jax.vjp(f, *jin, jbias)
    jgrads = vjp(jnp.asarray(g, jdt))

    tin = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    tbias = None if bias is None else torch.from_numpy(bias).requires_grad_()
    tids = None if ids is None else tuple(map(torch.from_numpy, ids))
    tout = tfa.flash_attention(*tin, bias=tbias, segment_ids=tids,
                               causal=causal)
    tout.backward(torch.from_numpy(g).to(tdt))
    tgrads = [t.grad for t in tin] + ([] if bias is None else [tbias.grad])

    blank = np.zeros((b, lq), bool)
    if ids is not None:
        same = ids[0][:, :, None] == ids[1][:, None, :]
        if causal:
            same = same & np.tril(np.ones((lq, lk), bool))
        blank = ~same.any(-1)
    to_np = lambda a: np.asarray(a, np.float32)
    return dict(
        out=(tout.detach().float().numpy(), to_np(jout)),
        grads=[(a.float().numpy(), to_np(w)) for a, w in zip(tgrads, jgrads)],
        grad_dtypes=[(a.dtype, w.dtype) for a, w in zip(tgrads, jgrads)],
        blank=blank, v=v, bias=bias, dtype=dtype)


@pytest.mark.parametrize("name", CASES)
def test_flash_masks_forward_matches_pallas(name):
    r = _both(name)
    got, want = r["out"]
    blank = np.broadcast_to(r["blank"][:, None, :], got.shape[:3])
    atol = 2e-5 if r["dtype"] == "fp32" else 2e-2
    np.testing.assert_allclose(got[~blank], want[~blank], rtol=0, atol=atol)
    assert np.isfinite(got).all()
    if "without_key" in name:
        assert blank.sum() > 0
        assert not got[blank].any()           # the port: 0
        assert np.abs(want[blank]).max() > 0  # Pallas: a mean of visited v
    else:
        assert blank.sum() == 0    # padded queries see the padded keys


@pytest.mark.parametrize("name", CASES)
def test_flash_masks_backward_matches_pallas(name):
    r = _both(name)
    assert len(r["grads"]) == (3 if r["bias"] is None else 4)
    for what, (got, want), (tdt, jdt) in zip(("dq", "dk", "dv", "dbias"),
                                             r["grads"], r["grad_dtypes"]):
        assert got.shape == want.shape, what
        assert str(tdt).split(".")[-1] == jnp.dtype(jdt).name, what
        if r["dtype"] == "fp32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                       err_msg=what)
        else:
            np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                                       atol=2e-2 * np.abs(want).max())
    if "without_key" in name:      # such a row gets no gradient, either side
        dq_t, dq_j = r["grads"][0]
        blank = np.broadcast_to(r["blank"][:, None, :], dq_t.shape[:3])
        assert not dq_t[blank].any() and not dq_j[blank].any()
    if name == "segments_bias":    # dbias is zero across segments
        db = r["grads"][3][0]
        assert not db[0, :, :70, 70:].any() and not db[0, :, 70:, :70].any()
        assert db[0, :, :70, :70].any()


def test_causal_is_top_left_in_flash_and_bottom_right_in_plain():
    """The flash path counts rows and columns from 0 (col <= row); the plain
    dispatch path aligns the diagonal to the bottom right, in both packages.
    They agree only for Lq = Lk."""
    q, k, v = (torch.from_numpy(_rand((1, 1, n, 16), s))
               for s, n in ((0, 6), (1, 9), (2, 9)))
    flash, _ = tfa.flash_attention_plain(q, k, v, causal=True)
    plain = tattn.plain_attention(q, k, v, causal=True)
    first_key_only = v[:, :, :1].expand(-1, -1, 1, -1)
    torch.testing.assert_close(flash[:, :, :1], first_key_only)
    assert (flash - plain).abs().max() > 1e-3
    want = jattn._xla_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                None, True, 0.25)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=2e-5)
    sq = tfa.flash_attention_plain(q, k[:, :, :6], v[:, :, :6], causal=True)[0]
    torch.testing.assert_close(
        sq, tattn.plain_attention(q, k[:, :, :6], v[:, :, :6], causal=True))


@pytest.mark.parametrize("form", ["causal", "bias", "segments"])
def test_dispatch_over_512_tokens_takes_the_flash_path(monkeypatch, form):
    """``dot_product_attention`` with a mask over >= 512 tokens reaches
    ``flash_attention`` and no longer raises (on CPU tensors the flash path
    runs its plain version; the dispatch rule is forced here, since it asks
    for a CUDA tensor)."""
    monkeypatch.setattr(tattn, "_flash_eligible", lambda q, k: True)
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    q, k, v = (torch.from_numpy(_rand((1, 2, 520, 16), s)) for s in range(3))
    ids = torch.from_numpy(np.arange(520, dtype=np.int32)[None] // 130)
    kw = dict(causal=dict(causal=True),
              bias=dict(bias=torch.from_numpy(_rand((1, 2, 520, 520), 5))),
              segments=dict(segment_ids=(ids, ids), seg_max_kv_blocks=1))[form]
    out = tattn.dot_product_attention(q, k, v, **kw)
    assert len(calls) == 1 and out.shape == q.shape
    monkeypatch.undo()
    same = ids[:, None, :, None] == ids[:, None, None, :]
    ref = tattn.dot_product_attention(q, k, v, **{
        n: a for n, a in kw.items() if n != "seg_max_kv_blocks"})
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-5)
    if form == "segments":         # and the plain branch is the JAX one
        want = jattn.dot_product_attention(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)), use_flash=False,
            segment_ids=(jnp.asarray(ids.numpy()),) * 2)
        np.testing.assert_allclose(ref.numpy(), np.asarray(want), atol=2e-5)
        assert bool(same.any())


@pytest.mark.parametrize("case", ["undersized", "with_bias", "covers"])
def test_seg_hint_validation_matches_jax(case):
    """``seg_max_kv_blocks`` is in units of the JAX package's key block
    (1024 here): one segment over 2048 tokens overlaps 2 of them."""
    l, d = 2048, 32
    q = _rand((1, 1, l, d), 0)
    ids = np.zeros((1, l), np.int32)
    bias = _rand((1, 1, l, l), 1) if case == "with_bias" else None
    hint = dict(undersized=1, with_bias=2, covers=2)[case]
    tq = torch.from_numpy(q)
    tids = (torch.from_numpy(ids),) * 2
    call = lambda: tfa.flash_attention(
        tq, tq, tq, bias=None if bias is None else torch.from_numpy(bias),
        segment_ids=tids, seg_max_kv_blocks=hint)
    if case == "covers":
        ref = tfa.flash_attention(tq, tq, tq, segment_ids=tids)
        torch.testing.assert_close(call(), ref, rtol=0, atol=0)
        return
    jq = jnp.asarray(q)
    with pytest.raises(ValueError) as jax_err:
        jfa.flash_attention(jq, jq, jq, bias=None if bias is None
                            else jnp.asarray(bias),
                            segment_ids=(jnp.asarray(ids),) * 2,
                            interpret=True, seg_max_kv_blocks=hint)
    with pytest.raises(ValueError) as port_err:
        call()
    assert str(port_err.value) == str(jax_err.value)
    assert ("seg_max_kv_blocks" if case == "undersized" else "bias") in str(
        port_err.value)


def test_seg_tile_bounds_and_ranges_match_jax():
    """Per-tile [min, max] ids and the first / last overlapping tile, at the
    kernels' tile sizes, against the JAX helpers at the same sizes."""
    q_ids = np.concatenate([np.zeros(192, np.int32), np.ones(64, np.int32),
                            np.full(44, 3, np.int32)])[None]
    kv_ids = q_ids[:, :248]
    for bq, bk in (tfa._FWD_TILES, tfa._DQ_TILES, tfa._DKV_TILES, (128, 128)):
        jargs = jfa._seg_inputs((jnp.asarray(q_ids), jnp.asarray(kv_ids)),
                                1, 2, 300, 248, bq, bk)
        tq = tfa._seg_bounds(torch.from_numpy(q_ids), bq)
        tk = tfa._seg_bounds(torch.from_numpy(kv_ids), bk)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jargs[2]))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jargs[3]))
        for a, w in zip(tfa._seg_block_ranges(tq, tk),
                        jfa._seg_block_ranges(jargs[2], jargs[3])):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    assert tfa._jax_blocks(2048, 2048, 32) == (1024, 1024)
    assert tfa._jax_blocks(584, 584, 64) == (384, 640)
    assert tfa._jax_blocks(4096, 4096, 512) == (512, 512)


def test_masked_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 1, 64, 64)
    with pytest.raises(ValueError, match="segment_ids"):
        tfa._check_segment_ids((torch.zeros(1, 63), torch.zeros(1, 64)), 1,
                               64, 64, q.device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_cuda(q, q, q, causal=True)
    n = tfa.flash_attention_cuda.launches
    tfa.flash_attention(q, q, q, causal=True)      # CPU: the plain version
    assert tfa.flash_attention_cuda.launches == n
    # every mask form at every head dim up to 512, K1 and the backward (the
    # position-masked kernels up to 256)
    assert (tfa._MAX_HEAD_DIM, tfa._MAX_WIDE) == (256, 512)
    for route, wide in ((tfa.k1_route, "d512"), (tfa.k3_route, "wide"),
                        (tfa.k4_route, "wide")):
        assert route(torch.bfloat16, 96, True, True, True) == "sm90"
        assert route(torch.bfloat16, 320, True, True, True) == wide
        with pytest.raises(NotImplementedError, match="1 to 512"):
            route(torch.bfloat16, 520, True, True, True)
