"""K5, K6 and K7 at head dims 257 to 512, on the CPU.

- The routes: on a CUDA tensor K5 (``k5_route``) takes every head dim from
  257 to 512 in every position form (causal, ``valid_len``, two segments on
  a side, the bounded softmax) on K1's wide kernel ("d512" in bf16), K6 and
  K7 (``k6_route``, ``k7_route``) on the wide backward kernel ("wide"),
  "fp32" in fp32; above 512 each raises, naming its entry point.
- The wrapper's scratch: above 256 ``flash_attention_pos_cuda`` splits the
  keys as K1 does (``k1_d512_splits``) and sizes the bf16 kernel's partials
  (``_d512_work``) and the fp32 workspace (``f32_forward_work``) for the
  split count it hands the C entry, whose signature it calls with; the C
  sources hold the position forms (the bf16 entry ``fdsd_flash_fwd_pos``
  sending d > 256 to K1's wide kernel, the fp32 bounded form at 384 and
  512). The
  C entries are not called here: the wrapper runs on CPU tensors with the
  library, the SM count and the stream stubbed.
- The plain K5 and K6 / K7 (the kernels' oracle on the card) against the
  JAX Pallas kernels in interpret mode (``flash_attention_pos`` and
  ``flash_bwd_pos``, ``interpret=True``: ``_fwd_kernel_pos``,
  ``_bwd_dq_kernel_pos``, ``_bwd_dkv_kernel_pos``, whose blocks are cut to
  512 above 256) at head dims 300, 384 and 512, lengths 200 x 264 over two
  offset segments a side, in the forms online, bounded with ``valid_len``,
  causal with ``valid_len``, and causal over two interleaved segments; fp32,
  atol = rtol = 1e-5. A row that sees no key is left out of the ``out``
  comparison: there the Pallas online body returns the mean of the values
  it visited and the port 0, the divergence ``ROADMAP.md`` records (queue
  C); lse (-1e30 in both) and the gradients are compared on every row.
- ``joint_flash_attention``'s forward and gradients at heads of 384 (online
  and bounded) against the JAX ``joint_flash_attention(interpret=True)``
  and its custom VJP; ``ring_attention`` at head dim 384 over 2 shards of
  the host device, ragged (``kv_valid_len``) and causal (zig-zag: two
  segments a side), forward against the JAX xla ring and gradients against
  the JAX flash ring's custom VJP in interpret mode on 2 virtual devices
  (``devices8``), as ``tests/test_torch_ring.py`` does at 16.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from from_ddpm_to_stable_diffusion_tpu.parallel import build_mesh as jmesh
from from_ddpm_to_stable_diffusion_tpu.parallel import ring_attention as jring
from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
from from_ddpm_to_stable_diffusion_tpu_torch.parallel import (
    ring_attention as tring)
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

BF16, F32 = torch.bfloat16, torch.float32
# (causal, valid_len, two segments, bounded), as tests/test_torch_pos_sm90.py
FORMS = [(c, v, s, b) for c in (False, True) for v in (False, True)
         for s in (False, True) for b in (False, True)]
WIDE_DIMS = (264, 300, 384, 512)
ATOL = RTOL = 1e-5
ROUTES = [(tfa.k5_route, "flash_attention_pos_cuda", "d512"),
          (tfa.k6_route, "flash_bwd_pos_dq_cuda", "wide"),
          (tfa.k7_route, "flash_bwd_pos_dkv_cuda", "wide")]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _source(name):
    return (_build.CSRC / name).read_text()


# ------------------------------------------------------------------ routes
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("route,entry,wide", ROUTES, ids=["K5", "K6", "K7"])
def test_routes_take_257_to_512_in_every_form(route, entry, wide, d, dtype):
    want = "fp32" if dtype == F32 else wide
    for form in FORMS:
        # the backward is one function for both softmaxes: no bounded flag
        args = form if route is tfa.k5_route else form[:3]
        assert route(dtype, d, *args) == want, form
    assert route(dtype, 256) == ("fp32" if dtype == F32 else "sm90")


@pytest.mark.parametrize("route,entry,wide", ROUTES, ids=["K5", "K6", "K7"])
def test_routes_above_512_raise_naming_the_entry_point(route, entry, wide):
    for dtype in (BF16, F32):
        for d in (513, 520, 768, 1024):
            with pytest.raises(NotImplementedError,
                               match=f"head dim {d}: {entry} takes head "
                                     "dims 1 to 512"):
                route(dtype, d)


def test_the_position_forms_are_in_the_sources():
    """K5 above 256 has its own bf16 entry on K1's kernel (the position
    predicate and the bounded flag in its ANY form, no new instantiation)
    and the fp32 streaming kernel's bounded form at 384 and 512; K6 / K7
    route above 256 to the wide backward kernel, which takes PosArgs and
    judges each tile pair by pos_pair in a walk both blocks of its cluster
    pair take alike; the fp32 streaming backward, a cluster pair too, reads
    the offsets, segments and valid_len of p.pos through tile_pair /
    pos_sees."""
    k1 = _source("flash_attention.cu")
    assert "cudaError_t fwd_pos(" in k1
    entry = _source("flash_attention_sm90.cu").split(
        'extern "C" int fdsd_flash_fwd_pos(')[1]
    assert "if (d > 256)" in entry and "d512::fwd_pos(" in entry
    assert "pos_pair(p.pos, q_lo, q_hi, k_lo, k_hi)" in k1
    assert "const bool bounded = ANY && p.bounded != 0;" in k1
    wide = _source("flash_attention_wide_bwd_sm90.cuh")
    assert "PosArgs pos;" in wide and "pos_pair(p.pos" in wide
    walk = "for (int ct = visible(ct_begin); ct < ct_end; ct = visible(ct + 1))"
    for text in (wide, _source("fp32/flash_f32_bwd_stream.cuh")):
        assert "__cluster_dims__(2, 1, 1)" in text and walk in text
    for src in ("flash_attention_dq_sm90.cu", "flash_attention_bwd_sm90.cu"):
        text = _source(src)
        entry = text.split('extern "C" int fdsd_flash_bwd_pos_')[1]
        assert "if (d > 256)" in entry and "kw::launch_wide(" in entry, src
    f32 = _source("fp32/flash_f32_fwd_wide.cuh")
    assert "flash_fwd_f32_wide_kernel<DP, kWideBounded>" in f32.split(
        "cudaError_t launch_wide_k1(")[1]
    stream = _source("fp32/flash_f32_bwd_stream.cuh")
    assert "tile_pair(p, offs, masked" in stream and "pos_sees(" in stream
    for entry in ("fdsd_flash_bwd_pos_dq_f32(", "fdsd_flash_bwd_pos_dkv_f32("):
        body = _source("fp32/flash_f32_bwd.cu").split(entry)[1].split(
            "\n}\n")[0]
        assert "d > 256" not in body, entry


# ------------------------------------------------- the wrapper's scratch
@pytest.mark.parametrize("d", [300, 512])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("lq,lk,splits", [(130, 700, 4), (64, 130, 3),
                                          (2304, 128, 1)])
def test_k5_wrapper_sizes_its_scratch_for_the_key_splits(monkeypatch, dtype,
                                                         d, lq, lk, splits):
    """Above 256 the K5 wrapper splits the keys as K1 does on a card of 132
    SMs, sizes the bf16 partials (splits, B·H·Lq, DP + 1) or the fp32
    workspace (the split terms, then the partials) for that count, passes
    the same count to the C entry of its route and counts the launch there;
    one split takes no bf16 scratch."""
    b, h = 1, 2
    assert tfa.k1_d512_splits(b, h, lq, lk, 132) == splits
    made, calls = [], []
    for name in ("_d512_work", "_f32_work"):
        real = getattr(tfa, name)

        def record(*a, _real=real, _name=name):
            w = _real(*a)
            made.append((_name, None if w is None else w.numel()))
            return w
        monkeypatch.setattr(tfa, name, record)

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    monkeypatch.setattr(tfa, "_check_qkv", lambda q, k, v, fn: (
        *q.shape[:3], k.shape[2], q.shape[3]))
    monkeypatch.setattr(tfa, "_sm_count", lambda device: 132)
    monkeypatch.setattr(tfa, "_stream", lambda q: None)
    monkeypatch.setattr(tfa, "_pos_entry", lambda q, name: entry(
        name + ("_f32" if q.dtype == F32 else "")))
    fn = tfa.flash_attention_pos_cuda
    monkeypatch.setattr(fn, "launches", 0)
    for counter in ("dtypes", "routes", "head_dims"):
        monkeypatch.setattr(fn, counter, collections.Counter())
    q = torch.zeros(b, h, lq, d, dtype=dtype)
    k = torch.zeros(b, h, lk, d, dtype=dtype)
    off = torch.zeros(2, dtype=torch.int32)
    out, lse = fn(q, k, k, off, off, causal=True, valid_len=lk - 3,
                  stability="bounded")
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    (name, args), = calls
    sigs = {**_build._SIGNATURES, **_build._SIGNATURES_FP32}
    assert len(args) == len(sigs[name])
    assert args[-2] == splits        # the split count, before the stream
    if dtype == F32:
        assert name == "fdsd_flash_fwd_pos_f32"
        # the split terms at the head dim the wrapper pads to 8
        assert made == [("_f32_work", tfa.f32_forward_work(
            b, h, lq, lk, -(-d // 8) * 8, splits))]
    else:
        assert name == "fdsd_flash_fwd_pos"
        part = splits * b * h * lq * (tfa._wide_width(d) + 1)
        assert made == [("_d512_work", part if splits > 1 else None)]
        assert (args[7] is None) == (splits == 1)
    route = "fp32" if dtype == F32 else "d512"
    assert fn.routes == {route: 1} and fn.head_dims == {d: 1}


# ------------------------------------------- plain versions against Pallas
PALLAS_DIMS = (300, 384, 512)
# form -> keywords of flash_attention_pos (offsets and segments of each
# side: q (0, 120) cut at 100, k (30, 140) cut at 120, interleaving)
PALLAS_FORMS = {
    "online": dict(),
    "bounded": dict(valid_len=230, stability="bounded"),
    "causal_valid_len": dict(causal=True, valid_len=250),
    "causal_two_segments": dict(causal=True),
}
LQ, LK, SEG_Q, SEG_K = 200, 264, 100, 120
Q_OFF, K_OFF = (0, 120), (30, 140)


@functools.lru_cache(maxsize=None)
def _pallas_case(d, form):
    """q, k, v, dO at (1, 1, 200, 264, d) through the Pallas position
    kernels in interpret mode and the port's plain versions: (out, lse) of
    both, and the gradients of both under the Pallas forward's lse and
    delta = Σ dO·out."""
    kw = dict(PALLAS_FORMS[form], seg_q=SEG_Q, seg_k=SEG_K)
    q = _rand((1, 1, LQ, d), 0, 0.7)
    k, v = (_rand((1, 1, LK, d), s, 0.7) for s in (1, 2))
    g = _rand((1, 1, LQ, d), 3)
    jin = [jnp.asarray(a) for a in (q, k, v)]
    jq, jk = (jnp.asarray(o, jnp.int32) for o in (Q_OFF, K_OFF))
    jout, jlse = jfa.flash_attention_pos(*jin, jq, jk, interpret=True, **kw)
    delta = (np.asarray(jout, np.float64) * g).sum(-1).astype(np.float32)
    bkw = {key: val for key, val in kw.items() if key != "stability"}
    jgrads = jfa.flash_bwd_pos(*jin, jnp.asarray(g), jlse,
                               jnp.asarray(delta), jq, jk, interpret=True,
                               **bkw)
    tin = [torch.from_numpy(a) for a in (q, k, v)]
    tq, tk = (torch.tensor(o, dtype=torch.int32) for o in (Q_OFF, K_OFF))
    tout, tlse = tfa.flash_attention_pos(*tin, tq, tk, **kw)
    tgrads = tfa.flash_bwd_pos(*tin, torch.from_numpy(g),
                               torch.from_numpy(np.array(jlse)),
                               torch.from_numpy(delta), tq, tk, **bkw)
    seen = np.asarray(jlse) > -1e29
    return dict(out=(tout.numpy()[seen], np.asarray(jout)[seen]),
                lse=(tlse.numpy(), np.asarray(jlse)),
                grads=[(a.numpy(), np.asarray(w))
                       for a, w in zip(tgrads, jgrads)],
                blank=(~seen).sum(), blank_out=tout.numpy()[~seen])


@pytest.mark.parametrize("form", sorted(PALLAS_FORMS))
@pytest.mark.parametrize("d", PALLAS_DIMS)
def test_plain_forward_matches_pallas_interpret(d, form):
    """K5's plain version against ``flash_attention_pos`` in interpret mode
    (``_fwd_kernel_pos`` at blocks of 256): out over the rows that see a
    key, lse over every row; a row that sees no key gives out = 0 in the
    port (rows at positions 0 - 29 under causal)."""
    case = _pallas_case(d, form)
    for name in ("out", "lse"):
        got, want = case[name]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    assert case["blank"] == (30 if PALLAS_FORMS[form].get("causal") else 0)
    assert not case["blank_out"].any()


@pytest.mark.parametrize("form", sorted(PALLAS_FORMS))
@pytest.mark.parametrize("d", PALLAS_DIMS)
def test_plain_backward_matches_pallas_interpret(d, form):
    """K6's and K7's plain version against ``flash_bwd_pos`` in interpret
    mode (``_bwd_dq_kernel_pos``, ``_bwd_dkv_kernel_pos``) under the same
    global lse and delta, rows that see no key included."""
    for name, (got, want) in zip(("dq", "dk", "dv"),
                                 _pallas_case(d, form)["grads"]):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


# ------------------------------------------------- the joint attention
@pytest.mark.parametrize("stability", ["online", "bounded"])
def test_joint_attention_at_heads_of_384_matches_pallas(stability):
    """``joint_flash_attention`` over [context | x] at heads of 384 (1, 2
    heads, 40 context and 136 x tokens): both outputs and the six
    gradients against the JAX joint attention (four ``flash_attention_pos``
    in interpret mode merged by lse; its custom VJP, four
    ``flash_bwd_pos``), fp32."""
    d, lc, lx = 384, 40, 136
    args = [_rand((1, 2, n, d), 60 + i, 0.7)
            for i, n in enumerate((lc, lc, lc, lx, lx, lx))]
    cots = (_rand((1, 2, lc, d), 70), _rand((1, 2, lx, d), 71))

    def f(*a):
        oc, ox = jfa.joint_flash_attention(*a, d ** -0.5, 128, 128, True,
                                           stability)
        return (oc * cots[0]).sum() + (ox * cots[1]).sum(), (oc, ox)

    (_, (joc, jox)), jgrads = jax.value_and_grad(
        f, argnums=tuple(range(6)), has_aux=True)(*map(jnp.asarray, args))
    tin = [torch.from_numpy(a).requires_grad_() for a in args]
    oc, ox = tfa.joint_flash_attention(*tin, d ** -0.5, stability)
    ((oc * torch.from_numpy(cots[0])).sum()
     + (ox * torch.from_numpy(cots[1])).sum()).backward()
    for got, want in ((oc, joc), (ox, jox)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
    for i, (t, w) in enumerate(zip(tin, jgrads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=f"input {i}")


# ------------------------------------------------------------- the ring
RING_FORMS = {"ragged": dict(kv_valid_len=50), "causal": dict(causal=True)}


@pytest.mark.parametrize("form", sorted(RING_FORMS))
def test_ring_at_head_dim_384_matches_jax(devices8, form):
    """``ring_attention`` at (1, 2, 64, 384) over 2 shards of the host
    device (the plain K5 per hop, K6 / K7 under the merged lse): forward
    against the JAX xla ring (2e-5, as ``tests/test_torch_ring.py``),
    gradients against the JAX flash ring's custom VJP in interpret mode
    (1e-4), on 2 virtual devices."""
    kw = RING_FORMS[form]
    n, d = 2, 384
    q, k, v = (_rand((1, 2, 64, d), 80 + i, 0.7) for i in range(3))
    cot = _rand((1, 2, 64, d), 85)
    mesh = jmesh({"seq": n}, devices8[:n])
    want = jax.jit(lambda q, k, v: jring.ring_attention(
        q, k, v, mesh, impl="xla", **kw))(q, k, v)
    f = lambda q, k, v: (jring.ring_attention(
        q, k, v, mesh, impl="flash", interpret=True, **kw) * cot).sum()
    jgrads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    tmesh = build_mesh({"seq": n}, [torch.device("cpu")] * n)
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tring.ring_attention(*xs, tmesh, impl="flash", **kw)
    rows = kw.get("kv_valid_len", 64)
    np.testing.assert_allclose(out.detach().numpy()[:, :, :rows],
                               np.asarray(want)[:, :, :rows], atol=2e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, x, w in zip("qkv", xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=f"d{name}")
