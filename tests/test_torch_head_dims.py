"""K1, K3 and K4 at every head dim from 1 to 256, on the CPU.

- The routes: on a CUDA tensor K1 (``k1_route``), K3 (``k3_route``) and K4
  (``k4_route``) take every head dim from 1 to 256 in every mask form, in
  bf16 and in fp32, as K5 / K6 / K7 do (and up to 512:
  ``tests/test_torch_wide_heads.py``, ``tests/test_torch_wide_pos.py``);
  every route above 512 still raises, naming the entry point.
- The tiles: the segment-id tiles the wrappers build at each width are the
  kernels' own (the Cfg rules of ``csrc/flash_attention*_sm90.cuh``), and
  every width's tiles fit in an H100 block's shared memory, the fp32 K1's
  streaming kernel above 160 (``csrc/fp32/flash_f32_fwd_wide.cuh``) too.
- The padding of a head dim that is not a multiple of 8 (zero columns, the
  original scale, the outputs cut back) is exact: on the plain versions the
  padded call equals the unpadded one, forward and backward.
- The plain K1, K3 and K4 (the kernels' oracle on the card) against the JAX
  Pallas kernels in interpret mode at head dims 24, 96, 160, 192 and 256,
  and causal at 192, lengths 256 x 200 in blocks of 128 (several tiles, a
  ragged one), fp32:
  atol = rtol = 1e-4, as ``tests/test_torch_flash_bwd.py`` (fp32 sums over
  up to 256 keys taken in another order and block split).
- tiny-SD at ``channel: 96`` (heads of 96 and 192 at its attention levels):
  ``DDPMTrainer`` train steps and ``ddpm_sample`` against the JAX trainer,
  fed the JAX step's own draws, in fp32 and in bf16. Tolerances as
  ``tests/test_torch_grad_accum.py`` (fp32: loss 1e-5 relative, parameters
  within 1e-5 but for 1 element in 10^4) and ``tests/test_torch_mmdit_
  trainer.py`` (bf16: loss 2e-2 relative, parameters: the mean difference
  under a tenth of the mean movement); samples fp32 atol 1e-4, bf16 within
  3e-2 of the largest magnitude (every linear rounds to bf16, 8 significant
  bits, through the UNet and 4 sampling steps).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from from_ddpm_to_stable_diffusion_tpu.pipelines import (
    ddpm_trainer as jddpm_trainer)
from from_ddpm_to_stable_diffusion_tpu.utils import config as jconfig
from from_ddpm_to_stable_diffusion_tpu_torch.io import data as tdata
from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from from_ddpm_to_stable_diffusion_tpu_torch.ops import schedules as tsched
from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
    DDPMTrainer)
from from_ddpm_to_stable_diffusion_tpu_torch.utils import config as tconfig
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)
from torch_trainer_parity import (assert_adamw_close, ddpm_draws, lr_bound,
                                  one_device_mesh, port_flat, port_flat_jax)

BF16, F32 = torch.bfloat16, torch.float32
FORMS = [(c, b, s) for c in (False, True) for b in (False, True)
         for s in (False, True)]          # (causal, bias, segments)
ROUTES = {"K1": tfa.k1_route, "K3": tfa.k3_route, "K4": tfa.k4_route}
ATOL = RTOL = 1e-4
SMEM_LIMIT = 232448   # dynamic shared memory a block may take on the H100


# ------------------------------------------------------------------ routes
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("kernel", sorted(ROUTES))
def test_routes_take_every_head_dim_up_to_256(kernel, dtype):
    """bf16: the sm90 kernel in every form; fp32: the TF32 kernels in every
    form too (a bias, dbias, segment ids, causal) at every head dim (the
    forward above 160 on its streaming kernel)."""
    want = "sm90" if dtype == BF16 else "fp32"
    for d in range(1, 257):
        for form in FORMS:
            assert ROUTES[kernel](dtype, d, *form) == want, (d, form)


REFUSED_WIDE = 520   # above 512: no kernel takes it in any form
WIDE_ROUTES = {tfa.k1_route: "d512", tfa.k3_route: "wide",
               tfa.k4_route: "wide", tfa.k5_route: "d512",
               tfa.k6_route: "wide", tfa.k7_route: "wide"}
CASES = [
    # (route, dtype, head dim, form keywords, the entry point named); those
    # up to 256 were refused before the fp32 mask forms and the position
    # kernels took every head dim, those from 257 to 512 before the wide
    # kernels: they now have their route, and the same form stays refused
    # above 512 (REFUSED_WIDE)
    (tfa.k3_route, BF16, 512, {}, "flash_attention_bwd_dq_cuda"),
    (tfa.k4_route, F32, 512, {}, "flash_attention_bwd_dkv_cuda"),
    (tfa.k1_route, BF16, 320, {}, "flash_attention_cuda"),
    (tfa.k1_route, BF16, 512, dict(causal=True), "flash_attention_cuda"),
    (tfa.k5_route, BF16, 96, {}, "flash_attention_pos_cuda"),
    (tfa.k6_route, BF16, 96, {}, "flash_bwd_pos_dq_cuda"),
    (tfa.k7_route, F32, 96, {}, "flash_bwd_pos_dkv_cuda"),
    (tfa.k1_route, F32, 96, dict(bias=True), "flash_attention_cuda"),
    (tfa.k1_route, F32, 64, dict(bias=True, causal=True),
     "flash_attention_cuda"),
    (tfa.k1_route, F32, 192, dict(segments=True), "flash_attention_cuda"),
    (tfa.k3_route, F32, 96, dict(bias=True), "flash_attention_bwd_dq_cuda"),
    (tfa.k4_route, F32, 160, dict(segments=True, causal=True),
     "flash_attention_bwd_dkv_cuda"),
]


@pytest.mark.parametrize("route,dtype,d,form,entry", CASES,
                         ids=lambda x: getattr(x, "__name__", str(x)))
def test_what_stays_refused_raises_naming_the_entry_point(route, dtype, d,
                                                          form, entry):
    """Above 512 a route raises naming its entry point. A case at a head
    dim the route takes has its route in its dtype, and raises so in the
    same form above the limit."""
    if d <= 512:
        want = ("fp32" if dtype == F32 else "sm90" if d <= 256
                else WIDE_ROUTES[route])
        assert route(dtype, d, **form) == want
        d = REFUSED_WIDE
    with pytest.raises(NotImplementedError, match=entry):
        route(dtype, d, **form)


# ------------------------------------------------------------------- tiles
def _source(name):
    return (_build.CSRC / name).read_text()


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_segment_tiles_follow_the_kernels_tiles(d):
    """The (query, key) tiles the wrappers build segment ids at: K1 halves
    its key tile above DP 160 (above 128 in a masked form), K3 above DP
    192, K4 above DP 128 (one block a 64-key tile), as the kernels' Cfg
    say."""
    dp = -(-d // 16) * 16
    for masked in (False, True):
        wide = dp > (128 if masked else 160)
        assert tfa._k1_tiles(d, masked) == (128, 64 if wide else 128)
    assert tfa._dq_tiles(d) == (128, 32 if dp > 192 else 64)
    assert tfa._dkv_tiles(d) == (64, 64 if dp > 128 else 128)
    assert tfa._dkv_width(d) == (dp if d <= 128 else -(-d // 32) * 32)
    rules = {"flash_attention_sm90.cuh":
             "DP <= 128 || (DP <= 160 && !HAS_BIAS) ? k1::kBK : k1::kBK / 2",
             "flash_attention_dq_sm90.cuh":
             "kBK = DP <= 192 ? k3::kBK : k3::kBK / 2",
             "flash_attention_bwd_sm90.cuh":
             "kBK = DP <= 128 ? k4::kBK : k4::kBK / 2"}
    for name, rule in rules.items():
        assert rule in _source(name), name


def _k1_smem(dp, bias):
    bk = 128 if dp <= 128 or (dp <= 160 and not bias) else 64
    return (128 * dp * 2 + 2 * 2 * bk * dp * 2 + (128 * bk * 4 if bias else 0)
            + 8 * 7 + 1024)


def _k3_smem(dp, bias):
    bk = 64 if dp <= 192 else 32
    return (2 * 128 * dp * 2 + 2 * 2 * bk * dp * 2
            + (128 * bk * 4 if bias else 0) + 8 * 7 + 1024)


def _k4_smem(dp, bias):
    """K and V, two stages of Q and dO, above 128 the P^T and dS^T tiles,
    the row statistics, the bias tile, barriers and the alignment."""
    bq, bk = 64, 128 if dp <= 128 else 64
    return (2 * bk * dp * 2 + 2 * 2 * bq * dp * 2
            + (2 * bk * bq * 2 if dp > 128 else 0) + 2 * 3 * bq * 4
            + (bq * bk * 4 if bias else 0) + 8 * 7 + 1024)


@pytest.mark.parametrize("kernel,smem", [("K1", _k1_smem), ("K3", _k3_smem),
                                         ("K4", _k4_smem)])
def test_every_width_fits_in_shared_memory(kernel, smem):
    """Each width's tiles (Q, the K / V or Q / dO ring, the bias tile of a
    masked form, barriers and the 1 KB alignment), as its Cfg lays them
    out, fit in a block's shared memory; DP = 256 is the widest."""
    widths = list(range(16, 257, 16))
    if kernel == "K4":   # above 128 a multiple of 32 (two column halves)
        widths = [w for w in widths if w <= 128 or w % 32 == 0]
    for dp in widths:
        for bias in (False, True):
            assert smem(dp, bias) <= SMEM_LIMIT, (dp, bias)
    src = {"K1": "flash_attention_sm90.cuh",
           "K3": "flash_attention_dq_sm90.cuh",
           "K4": "flash_attention_bwd_sm90.cuh"}[kernel]
    text = _source(src)
    assert 'static_assert(kSmemBytes <= 232448, "shared memory");' in text
    assert re.search(r"#define FDSD_K\d_WIDTHS\(X\)[^#]*X\(256\)", text)


@pytest.mark.parametrize("dp", [192, 224, 256, 512])
def test_fp32_streaming_forward_fits_in_shared_memory(dp):
    """The fp32 K1 above 160 (and at 512), as the Cfg of
    ``csrc/fp32/flash_f32_fwd_wide.cuh`` lays it out: three 64 KB slots, the
    P hi / lo tile (64 x 64 fp32 each), both consumers' row maxima and sums,
    six barriers and the 1 KB alignment fit a block; a V slot holds both
    consumers' v^T hi / lo rows over 64 keys, as many rows (a multiple of 8)
    as one TF32 wgmma of sm90.cuh takes as its N."""
    smem = 3 * 65536 + 2 * 64 * 64 * 4 + 4 * 64 * 4 + 8 * 6 + 1024
    assert smem <= SMEM_LIMIT
    v_slots = -(-(dp // 2) // 64)
    v_rows = dp // 2 // v_slots
    assert v_rows * v_slots == dp // 2 and v_rows % 8 == 0
    assert 2 * 2 * 2 * v_rows * 128 <= 65536
    text = _source("fp32/flash_f32_fwd_wide.cuh")
    for rule in ("kVSlots = (DP / 2 + 63) / 64", "kVRows = DP / 2 / kVSlots",
                 "kSlots = 3, kSlotBytes = 65536",
                 "kStatOff = kPOff + 2 * 2 * kChunk",
                 'static_assert(kSmemBytes <= 232448, "shared memory");'):
        assert rule in text, rule
    takes = re.search(r'static_assert\(([^;]*)"wgmma_tf32_ss: N"\)',
                      _source("sm90.cuh")).group(1)
    assert f"N == {v_rows}" in takes, (dp, v_rows)


@pytest.mark.parametrize("dp", [160, 192, 224, 256])
def test_k4_wide_products_have_a_wgmma_shape(dp):
    """K4 above 128: each consumer's dV += P^T dO and dK += dS^T Q are
    m64n(DP/2)k16 SS wgmmas (sm90.cuh's wgmma_ss takes that N), and its
    columns start on a swizzle chunk (128-byte chunks of 64 columns where
    DP / 2 is a multiple of 64, else 32-byte chunks of 16)."""
    takes = re.search(r'static_assert\(([^;]*)"wgmma_ss: N"\)',
                      _source("sm90.cuh")).group(1)
    assert f"N == {dp // 2}" in takes
    w = 64 if dp % 64 == 0 and dp // 2 % 64 == 0 else 16
    assert dp // 2 % w == 0
    text = _source("flash_attention_bwd_sm90.cuh")
    assert "W = DP % 64 == 0 && kDC % 64 == 0 ? 64 : 16" in text
    assert "kDC = kWide ? DP / 2 : DP" in text
    assert re.search(r"wgmma_ss<DC, 1>\(\s*dv", text)


def test_each_width_is_instantiated_once():
    """Every width of K1, K3 and K4 is instantiated in exactly one of the
    width sources, so each library holds every width once; so is each width
    of the fp32 K1's streaming kernel above 160."""
    for prefix, mac, widths in (
            ("flash_attention_sm90_w", "FDSD_K1_WIDTH", range(16, 257, 16)),
            ("flash_attention_dq_sm90_w", "FDSD_K3_WIDTH",
             range(16, 257, 16)),
            ("flash_attention_bwd_sm90_w", "FDSD_K4_WIDTH",
             [*range(16, 129, 16), 160, 192, 224, 256]),
            ("fp32/flash_f32_fwd_w", "FDSD_F32_FWD_WIDE", [192, 224, 256])):
        found = []
        for src in sorted(_build.CSRC.glob(prefix + "*.cu")):
            found += map(int, re.findall(mac + r"\((\d+)\)",
                                         src.read_text()))
        assert sorted(found) == list(widths), prefix


# ----------------------------------------------------------------- padding
def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("d", [12, 36, 100])
def test_padding_an_odd_head_dim_is_exact(d):
    """Zero columns up to a multiple of 8, the scale of d, the outputs cut
    back: the plain forward and backward equal the unpadded ones (the
    zero columns add nothing to QK^T; their own columns are cut)."""
    q, k, v, g = (torch.from_numpy(_rand((2, 3, n, d), s, 0.7))
                  for s, n in ((0, 70), (1, 50), (2, 50), (3, 70)))
    scale = d ** -0.5
    out, lse = tfa.flash_attention_plain(q, k, v, causal=True)
    grads = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, causal=True)
    qp, kp, vp, gp = tfa._pad_head_dim(q, k, v, g)
    assert qp.shape[-1] == -(-d // 8) * 8 and not qp[..., d:].any()
    pout, plse = tfa.flash_attention_plain(qp, kp, vp, scale, causal=True)
    pgrads = tfa.flash_attention_bwd_plain(qp, kp, vp, pout, plse, gp, scale,
                                           causal=True)
    torch.testing.assert_close(pout[..., :d], out, atol=1e-6, rtol=1e-6)
    assert not pout[..., d:].any()
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=1e-6)
    for a, w in zip(pgrads, grads):
        torch.testing.assert_close(a[..., :d], w, atol=1e-6, rtol=1e-6)
    whole = q[..., :8]
    assert tfa._pad_head_dim(whole)[0] is whole   # a multiple of 8: as it is


# ------------------------------------------- plain versions against Pallas
@pytest.fixture(scope="module", params=[24, 96, 160, 192, 256, (192, True)],
                ids=lambda p: f"d{p[0]}-causal" if isinstance(p, tuple)
                else f"d{p}")
def pallas_case(request):
    """q, k, v, dO at (1, 2, 256, 200, d) and the port's plain forward and
    backward through ``flash_attention`` on CPU tensors; causal in the
    (d, True) case, the form the fp32 K1 above 160 takes with its
    backward."""
    d, causal = (request.param if isinstance(request.param, tuple)
                 else (request.param, False))
    q, k, v = (_rand((1, 2, n, d), s, 0.7)
               for s, n in ((0, 256), (1, 200), (2, 200)))
    g = _rand((1, 2, 256, d), 3)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*ts, causal=causal)
    out.backward(torch.from_numpy(g))
    _, lse = tfa.flash_attention_plain(*(t.detach() for t in ts),
                                       causal=causal)
    return (q, k, v, g, causal), out.detach().numpy(), lse.numpy(), [
        t.grad.numpy() for t in ts]


def test_plain_forward_matches_pallas_interpret(pallas_case):
    """K1's plain version against ``_flash_fwd`` (``_fwd_kernel`` over two
    query and two key blocks, the second ragged) in interpret mode."""
    (q, k, v, _, causal), out, lse, _ = pallas_case
    jout, jlse = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), None, None,
                                causal, q.shape[-1] ** -0.5, 128, 128,
                                interpret=True)
    np.testing.assert_allclose(out, np.asarray(jout), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse, np.asarray(jlse).reshape(lse.shape),
                               atol=ATOL, rtol=RTOL)


def test_plain_backward_matches_pallas_interpret(pallas_case):
    """K3's and K4's plain versions against ``jax.vjp`` of
    ``flash_attention(..., interpret=True)``, which runs the Pallas
    ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``."""
    (q, k, v, g, causal), _, _, grads = pallas_case

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, block_q=128,
                                   block_k=128, interpret=True)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    for name, a, w in zip("qkv", grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=f"d{name}")


# ------------------------------------------------ tiny-SD at channel: 96
STEPS = 2
CFG = dict(epoch=3, batch_size=2, img_size=16, num_class=3, T=4, channel=96,
           channel_multy=[1, 2, 2, 2], dropout=0.0, lr=1e-4, max_lr=1e-3,
           warmup_epochs=1, train_rand=0.5, w=1.8, ema_decay=0.9, seed=0)


def _sample_draws(cfg, n, shape):
    """The JAX trainer's ``sample`` draws: x_T from the first key of
    ``split(key(seed + 2))``, each step's noise from ``fold_in`` of the
    second."""
    noise_key, samp_key = jax.random.split(jax.random.key(cfg.seed + 2))
    x_T = np.array(jax.random.normal(noise_key, (n,) + shape))
    steps = [np.array(jax.random.normal(jax.random.fold_in(samp_key, s),
                                        (n,) + shape))
             for s in range(cfg.T)]
    return x_T, steps


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def width96_run(request):
    """Two train steps of the JAX ``DDPMTrainer`` at ``channel: 96`` on a
    one-device mesh, and the port's trainer from the same parameters fed
    the JAX steps' draws; then each one's CFG sample of 3 labels."""
    cfg = dict(CFG, dtype=request.param)
    jcfg = jconfig.TinySDConfig(**cfg)
    jt = jddpm_trainer.DDPMTrainer(jcfg, mesh=one_device_mesh())
    jstate = jt.create_state(steps_per_epoch=1)
    params0 = jax.tree_util.tree_map(np.array, jstate.params)
    batches = list(tdata.DataLoader(tdata.SyntheticImageDataset(4, 16), 2,
                                    shuffle=False))[:STEPS]
    rng = jax.random.key(jcfg.seed + 1)
    jax_steps = []
    for i, (images, labels) in enumerate(batches):
        draws = ddpm_draws(jcfg, i, labels.shape, images.shape)
        jstate, loss = jt.train_step(jstate, images, labels, rng)
        jax_steps.append(dict(draws, loss=float(loss),
                              params=port_flat_jax(jstate.params),
                              ema=port_flat_jax(jstate.ema_params)))
    labels = [1, 2, 3]
    jsample = np.array(jt.sample(jstate, labels))

    trainer = DDPMTrainer(tconfig.TinySDConfig(**cfg), device="cpu")
    state = trainer.create_state(1, params=params0)
    port_steps = []
    for (images, labels_b), js in zip(batches, jax_steps):
        state, loss = trainer.train_step(state, images, labels_b,
                                         drop=js["drop"], t=js["t"],
                                         noise=js["noise"])
        port_steps.append(dict(loss=loss.item(),
                               params=port_flat(state.params),
                               ema=port_flat(state.ema_params)))
    x_T, step_noise = _sample_draws(jcfg, len(labels),
                                    trainer.sample_shape)
    with torch.no_grad():
        sample = trainer.sample(state, labels, noise=x_T,
                                step_noise=step_noise).numpy()
    return dict(dtype=request.param, params0=port_flat_jax(params0),
                jax=jax_steps, port=port_steps, jsample=jsample,
                sample=sample, state=state)


def test_width96_has_the_head_dims_of_the_slice(width96_run):
    """At ``channel: 96`` tiny-SD's transformer blocks take one head of 96
    at level 0 and one of 192 at the 2x levels: the widths the card's
    kernels newly take."""
    model = width96_run["state"].model
    dims = {m.num_heads and m.qkv.weight.shape[0] // 3 // m.num_heads
            for m in model.modules() if hasattr(m, "qkv")}
    assert dims == {96, 192}


@pytest.mark.parametrize("i", range(STEPS))
def test_width96_train_steps_match_jax(width96_run, i):
    js, ps = width96_run["jax"][i], width96_run["port"][i]
    schedule = tsched.cosine_warmup_lr(CFG["lr"], CFG["max_lr"],
                                       CFG["warmup_epochs"], CFG["epoch"], 1)
    bound = lr_bound(schedule, i + 1)
    if width96_run["dtype"] == "fp32":
        np.testing.assert_allclose(ps["loss"], js["loss"], rtol=1e-5)
        for key in ("params", "ema"):
            assert_adamw_close(ps[key], js[key], bound, key)
        return
    np.testing.assert_allclose(ps["loss"], js["loss"], rtol=2e-2)
    start = width96_run["params0"]
    for key in ("params", "ema"):
        want, got = js[key], ps[key]
        assert set(got) == set(want)
        diff = moved = 0.0
        for name, w in want.items():
            d = np.abs(got[name] - w)
            assert d.max() <= bound, f"{key} {name}: {d.max()}"
            diff += d.sum()
            moved += np.abs(w - start[name]).sum()
        assert moved > 0 and diff <= 0.1 * moved, f"{key}: {diff} {moved}"


def test_width96_sample_matches_jax(width96_run):
    """``ddpm_sample`` through the trainer (CFG over T = 4 steps) from the
    JAX sampler's own x_T and step noise."""
    got, want = width96_run["sample"], width96_run["jsample"]
    assert got.shape == want.shape == (3, 16, 16, 3)
    if width96_run["dtype"] == "fp32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
