"""K1, K3 and K4 at head dims 257 to 512, on the CPU.

- The routes: on a CUDA tensor K1 (``k1_route``), K3 (``k3_route``) and K4
  (``k4_route``) take every head dim from 257 to 512 in every mask form and
  both dtypes ("d512" for K1 in bf16, "wide" for K3 / K4 in bf16, "fp32");
  above 512 they raise, naming the entry point, and so do K5, K6 and K7,
  which take 257 to 512 too (``tests/test_torch_wide_pos.py``).
- The widths: the padded widths 384 and 512 of the kernels above 256
  (``csrc/flash_attention.cu``, ``csrc/flash_attention_wide_bwd_sm90.cuh``,
  ``csrc/fp32/flash_f32_fwd_wide.cuh``, ``csrc/fp32/flash_f32_bwd_stream.cuh``)
  fit a block's shared memory and their accumulators its registers, as the
  sources lay them out; the wgmma shapes they issue exist; each width is
  instantiated once; the segment-id tiles the wrappers build are theirs.
- The padding of d = 300 (zero columns to 304, the scale of 300, the
  outputs cut back) is exact on the plain versions, in every mask form.
- The plain K1, K3 and K4 (the kernels' oracle on the card) against the JAX
  Pallas kernels in interpret mode (``_flash_fwd`` and ``jax.vjp`` of
  ``flash_attention(..., interpret=True)``, which runs ``_bwd_dq_kernel``
  with its dbias tiles and ``_bwd_dkv_kernel``) at head dims 264, 300, 384
  and 512, without a mask, causal, with a bias (and dbias) and with segment
  ids, lengths 256 x 200 in blocks of 128, fp32: atol = rtol = 1e-4, as
  ``tests/test_torch_head_dims.py`` (fp32 sums over up to 512 columns and
  200 keys, taken in another order and block split).
- The gradients of the VAEs through their one-head mid attention: SD1's
  ``VAEDecoder`` (mid width 512) on a 4 x 4 latent, and the SD3 VAE decoder
  at ``ch=96, ch_mult=(1, 2, 4)`` (mid width 384) on a 4 x 6 latent, with
  respect to the latent and every parameter, against ``jax.grad`` of the
  JAX modules with the same weights through ``io/from_jax.py``, fp32. The
  loss is <decoder(z), r> for a fixed random r. Tolerance: each gradient
  within 1e-4 of its largest magnitude plus 1e-5 absolute (fp32 sums over
  up to 3 x 3 x 512 inputs per output, in XLA's and PyTorch's orders,
  through some 30 layers and back; the two packages' forwards already agree
  to 1e-4 in ``tests/test_torch_sd3_models.py``).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu.models import sd1 as jsd1
from from_ddpm_to_stable_diffusion_tpu.models import sd3_vae as jvae
from from_ddpm_to_stable_diffusion_tpu.ops import flash_attention as jfa
from from_ddpm_to_stable_diffusion_tpu_torch.io.from_jax import (
    load_jax_params, state_dict_from_jax)
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd1 as tsd1
from from_ddpm_to_stable_diffusion_tpu_torch.models import sd3_vae as tvae
from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_models import jax_random_params
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

BF16, F32 = torch.bfloat16, torch.float32
FORMS = [(c, b, s) for c in (False, True) for b in (False, True)
         for s in (False, True)]          # (causal, bias, segments)
ATOL = RTOL = 1e-4
SMEM_LIMIT = 232448   # dynamic shared memory a block may take on the H100
REGS = 232            # registers a consumer thread holds (setmaxnreg)
WIDTHS = (384, 512)


def _source(name):
    return (_build.CSRC / name).read_text()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ------------------------------------------------------------------ routes
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("kernel,route,wide", [
    ("K1", tfa.k1_route, "d512"), ("K3", tfa.k3_route, "wide"),
    ("K4", tfa.k4_route, "wide")], ids=["K1", "K3", "K4"])
def test_routes_take_every_head_dim_from_257_to_512(kernel, route, wide,
                                                    dtype):
    want = "fp32" if dtype == F32 else wide
    for d in range(257, 513):
        for form in FORMS:
            assert route(dtype, d, *form) == want, (kernel, d, form)


@pytest.mark.parametrize("route,entry", [
    (tfa.k1_route, "flash_attention_cuda"),
    (tfa.k3_route, "flash_attention_bwd_dq_cuda"),
    (tfa.k4_route, "flash_attention_bwd_dkv_cuda")],
    ids=["K1", "K3", "K4"])
def test_routes_above_512_raise_naming_the_entry_point(route, entry):
    for dtype in (BF16, F32):
        for d in (513, 520, 640, 1024):
            for form in FORMS:
                with pytest.raises(NotImplementedError,
                                   match=f"head dim {d}: {entry} takes head "
                                         "dims 1 to 512"):
                    route(dtype, d, *form)


@pytest.mark.parametrize("route,entry", [
    (tfa.k5_route, "flash_attention_pos_cuda"),
    (tfa.k6_route, "flash_bwd_pos_dq_cuda"),
    (tfa.k7_route, "flash_bwd_pos_dkv_cuda")], ids=["K5", "K6", "K7"])
def test_position_kernels_raise_above_512(route, entry):
    """K5, K6 and K7 raise above 512 only, naming the entry point: from 257
    to 512 they take their wide route, as K1, K3 and K4 do."""
    wide = "d512" if route is tfa.k5_route else "wide"
    for dtype in (BF16, F32):
        assert route(dtype, 256) == ("fp32" if dtype == F32 else "sm90")
        for d in (257, 300, 384, 512):
            assert route(dtype, d) == ("fp32" if dtype == F32 else wide)
        for d in (513, 520, 640, 1024):
            with pytest.raises(NotImplementedError,
                               match=f"head dim {d}: {entry} takes head "
                                     "dims 1 to 512"):
                route(dtype, d)


def test_the_wrappers_launch_nothing_on_cpu_tensors():
    """On CPU tensors ``flash_attention`` at d = 300 runs the plain
    versions, forward and backward, and counts no launch; the kernels'
    wrappers refuse CPU tensors."""
    fns = (tfa.flash_attention_cuda, tfa.flash_attention_bwd_dq_cuda,
           tfa.flash_attention_bwd_dkv_cuda)
    before = [fn.launches for fn in fns]
    q = torch.from_numpy(_rand((1, 1, 64, 300), 0)).requires_grad_()
    tfa.flash_attention(q, q, q, causal=True).sum().backward()
    assert q.grad.shape == q.shape
    assert [fn.launches for fn in fns] == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_cuda(q, q, q)


# ------------------------------------------------------------------ widths
@pytest.mark.parametrize("d,want", [(257, 384), (264, 384), (300, 384),
                                    (384, 384), (385, 512), (512, 512)])
def test_wide_width_rounds_up_to_384_or_512(d, want):
    assert tfa._wide_width(d) == want


def _k1_wide_smem(dp):
    """Q (64 x DP), one K and one V tile of 64 keys, the P tile (64 x 64
    bf16), the row maxima and sums, five barriers and the alignment."""
    return 3 * 64 * dp * 2 + 64 * 64 * 2 + 4 * 64 * 4 + 8 * 5 + 1024


def _bwd_wide_smem(dp):
    """(bytes, stages) of the bf16 pair kernel's block at width DP, as its
    Cfg lays them out: A1 and A2 (64 x DH, DH = DP / 2, the block's half of
    the columns), two T tiles (64 x 64 bf16), the swap's `in` and `out`
    (X and Y of a 64 x 32 tile in fp32 each; dq: one `in` for each of its
    two swap channels), then as many stages of B1 and B2 (32 x DH) with the
    column tile's lse and delta as fit (at most 4), the barriers (A full,
    full / empty a stage, the two channels' five each) and the
    alignment."""
    dh = dp // 2
    fixed = 2 * 64 * dh * 2 + 2 * 64 * 64 * 2 + 2 * (2 * 64 * 32 * 4)
    stage = 2 * 32 * dh * 2
    room = SMEM_LIMIT - fixed - 8 * (1 + 2 * 5) - 1024
    stages = min(4, room // (stage + 2 * 32 * 4 + 16))
    return (fixed + stages * (stage + 2 * 32 * 4)
            + 8 * (1 + 2 * stages + 2 * 5) + 1024, stages)


def _f32_stream_smem(dkv):
    """(bytes, slots) of the fp32 pair kernel's block (the same at both
    widths): the T tiles (hi / lo of dS, and of P^T for dk / dv: 16 KB a
    term), the swap's `in` (X and Y of a 64 x 64 tile in fp32: the other
    block stores there), two entries of a column tile's lse and delta, as
    many 32 KB slots as fit (at most 4), the barriers (full / empty a slot
    and a statistics entry, the swap's five) and the alignment."""
    slot = 32768
    fixed = (2 if dkv else 1) * 2 * 16384 + 2 * 64 * 64 * 4 + 2 * 2 * 64 * 4
    room = SMEM_LIMIT - fixed - 8 * (2 * 2 + 5) - 1024
    slots = min(4, room // (slot + 16))
    return fixed + slots * slot + 8 * (2 * slots + 2 * 2 + 5) + 1024, slots


@pytest.mark.parametrize("dp", WIDTHS)
def test_each_wide_kernel_fits_a_block(dp):
    """Shared memory (as each Cfg lays it out, the swap's buffers counted)
    within the 232,448 bytes a block may take, the column operands on a
    ring of at least two stages (bf16: three, tiles j - 1, j and j + 1),
    and each consumer's accumulators within the registers it holds beside
    48 for addresses, indices and the
    statistics: K1's O (DP / 4 a thread) and S (16); the bf16 backward's
    pair: dq (each consumer its own, over whole tiles: X and Y, 16 each,
    and dS's fragments, 8), or dk (consumer 0) / dv (consumer 1), over the
    block's DH = DP / 2 columns (DH / 2 a thread), X or Y (16), the pulled
    sums (16) and P, dS (16); the fp32 pair: dq or dk and dv, each over a consumer's
    DH / 2 columns (DH / 4 a thread each), X, Y and a chunk (16 each) — a
    piece (at most 32) lives when a chunk no longer does."""
    dh = dp // 2
    smem, stages = _bwd_wide_smem(dp)
    assert smem == {384: 198808, 512: 214920}[dp] <= SMEM_LIMIT
    assert stages == {384: 4, 512: 3}[dp] >= 3
    for dkv, want in ((False, 198792), (True, 231560)):
        f32, slots = _f32_stream_smem(dkv)
        assert f32 == want <= SMEM_LIMIT and slots == 4
    assert _k1_wide_smem(dp) <= SMEM_LIMIT
    assert dp // 4 + 16 + 48 <= REGS
    assert dh // 2 + 3 * 16 + 48 <= REGS
    assert 2 * (dh // 4) + 3 * 16 + 48 <= REGS
    k1, bwd = _source("flash_attention.cu"), _source(
        "flash_attention_wide_bwd_sm90.cuh")
    stream = _source("fp32/flash_f32_bwd_stream.cuh")
    assert 'static_assert(kSmemBytes <= 232448, "shared memory");' in k1
    assert "kProducerRegs = 40, kConsumerRegs = 232" in k1
    assert "static constexpr int kNC = DP / 2;" in k1
    assert "float o[NC / 2];" in k1 and "float s[kHalf / 2];" in k1
    assert 'static_assert(kSmemBytes <= 232448, "shared memory");' in bwd
    assert "kProducerRegs = 40, kConsumerRegs = 232" in bwd
    assert 'static_assert(kStages >= 3, "a pipelined ring");' in bwd
    assert "static constexpr int kStages = kFit < 4 ? kFit : 4;" in bwd
    assert "kInOff = kTOff + 2 * kTBytes" in bwd
    assert "constexpr int kXBytes = 2 * kBR * kBC * 4;" in bwd
    assert "float acc[DH / 2];" in bwd and "float xy[kBC / 2];" in bwd
    assert "float x[kBC / 2], y[kBC / 2];" in bwd
    assert "uint32_t frag[kBC / 16][4];" in bwd
    assert "float sx[8], sy[8];" in bwd and "float ds[8], pr[8];" in bwd
    assert "static constexpr int kSlotBytes = 32768;" in stream
    assert 'static_assert(kSlots >= 2, "a pipelined ring");' in stream
    assert "float o[kAccs][C::kVSlots][kVR / 2];" in stream
    assert "float x[16], y[16], part[16];" in stream
    assert "kConsumerRegs = 232" in stream


@pytest.mark.parametrize("source", ["flash_attention_wide_bwd_sm90.cuh",
                                    "fp32/flash_f32_bwd_stream.cuh"])
def test_wide_backward_kernels_split_the_head_dim_on_a_pair(source):
    """Both wide backward kernels run on a cluster of two blocks that split
    the head dim: the cluster attribute on the kernel, block r's first
    column r DH, the partials stored into the other block by st.async
    (asynchronous: no consumer waits on the other SM) and the swap's helper
    arming and freeing `in`, the column tile's lse and delta staged in
    shared memory once a tile by a producer warp, dbias written by block 0
    alone, dk and dv one launch of pairs (no role per block; each role a
    kernel of its own), and a cluster barrier after the barriers are set up
    and again before exit."""
    text = _source(source)
    swap = _source("pair_swap.cuh")
    assert "__cluster_dims__(2, 1, 1)" in text
    assert "s9::cluster_rank()) * DH;  // first column" in text
    assert re.search(r"fdsd::swap_helper\(xbars[^;]*, tiles, kXBytes[,)]",
                     text)
    assert "s9::st_async_v4(peer.in + " in text and "peer.full);" in text
    assert "st.async.shared::cluster.mbarrier::complete_tx::bytes" in \
        _source("sm90.cuh")
    assert "bulk_copy_cluster" not in text + swap   # no copy hop
    assert text.count("s9::cluster_sync();") == 2
    body = text.split("s9::cluster_sync();")[-1]
    assert body.lstrip().startswith("}"), "the last cluster barrier exits"
    assert "tid >= 64 && tid < 96" in text   # the statistics' warp
    assert re.search(r"float\* db = [^;]*&& c0 == 0", text)
    assert "per_role" not in text and "2 * p.B * p.H * p." in text
    assert "template <int DP, bool ANY, bool DKV>" in text  # a kernel a role


@pytest.mark.parametrize("dp", WIDTHS)
def test_wide_kernels_issue_wgmma_shapes_that_exist(dp):
    """bf16: K1's S per consumer as m64n32k16; the backward pair's X / Y
    per consumer as m64n32k16 (a 32-column tile over the block's DH
    columns), dq's two k-steps as m64nDHk16 RS and dk / dv's as m64nDHk16
    SS, B MN-major (DH = DP / 2, 192 or 256); K1's O as m64n(DP/2)k16 SS;
    fp32:
    X / Y as m64n32k8 and the pieces as m64n(kVR)k8, 32 rows of d on the
    32 KB slots."""
    dh = dp // 2
    bf16 = re.search(r'static_assert\(([^;]*)"wgmma_ss: N"\)',
                     _source("sm90.cuh")).group(1)
    for n in (32, dh, dp // 2):
        assert f"N == {n}" in bf16, n
    tf32 = re.search(r'static_assert\(([^;]*)"wgmma_tf32_ss: N"\)',
                     _source("sm90.cuh")).group(1)
    slot = 32768
    most = slot // 1024
    pieces = -(-(dh // 2) // most)
    rows = dh // 2 // pieces
    assert rows == 32 and f"N == {rows}" in tf32, dp
    assert dh % most == 0 and 8 * rows * 128 <= slot
    assert "N == 32" in tf32
    bwd = _source("flash_attention_wide_bwd_sm90.cuh")
    assert "wgmma_ss<kBC>(" in bwd and "wgmma_ss<DH, 1>(" in bwd
    assert "wgmma_rs<DH>(" in bwd
    stream = _source("fp32/flash_f32_bwd_stream.cuh")
    assert "wgmma_tf32_ss<32>(" in stream and "wgmma_tf32_ss<kVR>(" in stream
    assert "wgmma_ss<NC, 1>(" in _source("flash_attention.cu")


def test_each_wide_width_is_instantiated_once():
    """384 and 512 once each for K3 / K4 in bf16 (one header, two sources;
    each width's launch holds the pair kernel without a mask and ANY), the
    fp32 K1's forms above 256 and the fp32 backward above 256 (each width's
    run_stream holds the dq and the dk / dv pair kernels)."""
    for prefix, mac in (
            ("flash_attention_wide_bwd_sm90_w", "FDSD_KW_WIDTH"),
            ("fp32/flash_f32_fwd_w", "FDSD_F32_FWD_K1"),
            ("fp32/flash_f32_bwd_w", r"FDSD_F32_BWD_STREAM\(,\s*")):
        found = []
        for src in sorted(_build.CSRC.glob(prefix + "*.cu")):
            found += map(int, re.findall(mac + r"\(?(\d+)\)",
                                         src.read_text()))
        assert sorted(found) == list(WIDTHS), prefix
    k1 = _source("flash_attention.cu")
    assert "launch_width<384>" in k1 and "launch_width<512>" in k1
    stream = _source("fp32/flash_f32_bwd_stream.cuh")
    assert ("run_stream_role<DP, ANY, true>(w, p, s)" in stream
            and "run_stream_role<DP, ANY, false>(w, p, s)" in stream)


@pytest.mark.parametrize("d", [264, 300, 384, 512])
def test_wide_segment_tiles_are_the_kernels_tiles(d):
    """The (query tile, key tile) the wrappers build segment ids at above
    256: K1 (64, 64) in bf16 and fp32; K3 (64, 32) and K4 (32, 64) in bf16
    (a pair owns 64 rows and walks tiles of 32 of the other axis), (64, 64)
    in fp32 (64 rows, tiles of 64)."""
    assert tfa._k1_tiles(d, True) == tfa._k1_tiles(d, False) == (64, 64)
    assert tfa._dq_tiles(d) == (64, 32) and tfa._dkv_tiles(d) == (32, 64)
    assert tfa._WIDE_BWD_TILES == (64, 32)
    for kernel in ("k1", "k3", "k4"):
        assert tfa._f32_tiles(kernel, d) == (64, 64)
    bwd = _source("flash_attention_wide_bwd_sm90.cuh")
    assert "constexpr int kBR = 64, kBC = 32;" in bwd
    assert "constexpr int kBR = 64, kBC = 64;" in _source(
        "fp32/flash_f32_bwd_stream.cuh")
    assert "constexpr int kBQ = 64, kBK = 64" in _source("flash_attention.cu")


def _launch_plan(source, lq, lk, b, h, dkv):
    """The grid the launch function of ``source`` computes for (B, H, Lq,
    Lk) and the role, evaluated from its own expressions: the row tiles
    (``(la + kBR - 1) / kBR``) and the blocks (``2 * p.B * p.H * ...``)."""
    text = _source(source)
    rows = re.search(r"p\.(n_rt|n_tiles) = \(la \+ (?:stream::)?kBR - 1\) "
                     r"/ (?:stream::)?kBR;", text)
    blocks = re.search(r"(2 \* p\.B \* p\.H \* p\.(?:n_rt|n_tiles))", text)
    assert rows and blocks, source
    env = dict(p=type("P", (), dict(B=b, H=h)))
    la = lk if dkv else lq
    setattr(env["p"], rows.group(1), -(-la // 64))
    return eval(blocks.group(1), env), getattr(env["p"], rows.group(1))


@pytest.mark.parametrize("lq,lk", [(1000, 777), (777, 1000), (1, 65),
                                   (4096, 4096)])
@pytest.mark.parametrize("source", ["flash_attention_wide_bwd_sm90.cuh",
                                    "fp32/flash_f32_bwd_stream.cuh"])
def test_wide_launch_grids_are_whole_cluster_pairs(source, lq, lk):
    """At odd row counts each launch plan's grid is a whole number of
    clusters of two, one cluster a 64-row tile of every (b, h), the tiles
    covering every row: dq over the queries, dk / dv over the keys."""
    for b, h in ((1, 1), (2, 3)):
        for dkv in (False, True):
            blocks, tiles = _launch_plan(source, lq, lk, b, h, dkv)
            rows = lk if dkv else lq
            assert blocks % 2 == 0 and blocks // 2 == b * h * tiles
            assert 64 * tiles >= rows > 64 * (tiles - 1)


@pytest.mark.parametrize("d,splits", [(300, 1), (300, 4), (512, 2)])
def test_fp32_wide_workspace_holds_the_key_splits(d, splits):
    """Above 256 the fp32 forward's workspace adds (splits, B·H·Lq, DP + 1)
    for the partial outputs and their lse when the keys are split."""
    b, h, lq, lk = 1, 2, 64, 130
    base = 2 * b * h * d * (lq + lk + 136)
    extra = splits * b * h * lq * (tfa._wide_width(d) + 1) if splits > 1 \
        else 0
    assert tfa.f32_forward_work(b, h, lq, lk, d, splits) == base + extra


# ----------------------------------------------------------------- padding
@pytest.mark.parametrize("form", FORMS, ids=lambda f: "-".join(
    n for n, on in zip(("causal", "bias", "segments"), f) if on) or "none")
def test_padding_head_dim_300_is_exact(form):
    """Zero columns up to 304, the scale of 300, the outputs cut back: the
    plain forward and backward (dbias too) equal the unpadded ones, within
    fp32's rounding of sums taken over 304 columns instead of 300 (1e-6 of
    each output's largest magnitude, or 1e-6 where that is below 1)."""
    causal, bias, seg = form
    d = 300
    q, k, v, g = (torch.from_numpy(_rand((2, 2, n, d), s, 0.7))
                  for s, n in ((0, 70), (1, 50), (2, 50), (3, 70)))
    masks = dict(causal=causal)
    if bias:
        masks["bias"] = torch.from_numpy(_rand((1, 2, 70, 50), 4, 0.5))
    if seg:
        masks["segment_ids"] = (torch.arange(70).repeat(2, 1) // 30,
                                torch.arange(50).repeat(2, 1) // 20)
    out, lse = tfa.flash_attention_plain(q, k, v, **masks)
    grads = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g, **masks,
                                          need_dbias=bias)
    qp, kp, vp, gp = tfa._pad_head_dim(q, k, v, g)
    assert qp.shape[-1] == 304 and not qp[..., d:].any()
    pout, plse = tfa.flash_attention_plain(qp, kp, vp, d ** -0.5, **masks)
    pgrads = tfa.flash_attention_bwd_plain(qp, kp, vp, pout, plse, gp,
                                           d ** -0.5, **masks,
                                           need_dbias=bias)
    torch.testing.assert_close(pout[..., :d], out, atol=1e-6, rtol=1e-6)
    assert not pout[..., d:].any()
    torch.testing.assert_close(plse, lse, atol=1e-6, rtol=1e-6)
    for a, w in zip(pgrads, grads):
        cut = a[..., :d] if a.shape[-1] == 304 else a
        tol = 1e-6 * max(1.0, w.abs().max().item())
        torch.testing.assert_close(cut, w, atol=tol, rtol=0)


# ------------------------------------------- plain versions against Pallas
PALLAS_DIMS = (264, 300, 384, 512)
PALLAS_FORMS = ("none", "causal", "bias", "segments")


@functools.lru_cache(maxsize=None)
def _pallas_case(d, form):
    """q, k, v, dO at (1, 2, 256, 200, d) (and a (1, 2, 256, 200) bias, or
    segment ids of runs of 70 queries and 60 keys), through the Pallas
    kernels in interpret mode at blocks of 128 and through the port's
    ``flash_attention`` on CPU tensors (its plain versions)."""
    q, k, v = (_rand((1, 2, n, d), s, 0.7)
               for s, n in ((0, 256), (1, 200), (2, 200)))
    g = _rand((1, 2, 256, d), 3)
    causal = form == "causal"
    bias = _rand((1, 2, 256, 200), 4, 0.5) if form == "bias" else None
    ids = None
    if form == "segments":
        ids = ((np.arange(256) // 70)[None].astype(np.int32),
               (np.arange(200) // 60)[None].astype(np.int32))
    jids = None if ids is None else tuple(map(jnp.asarray, ids))
    jbias = None if bias is None else jnp.asarray(bias)
    jin = [jnp.asarray(a) for a in (q, k, v)]
    jout, jlse = jfa._flash_fwd(*jin, jbias, jids, causal, d ** -0.5, 128,
                                128, interpret=True)

    def f(q, k, v, bias):
        return jfa.flash_attention(q, k, v, bias=bias, segment_ids=jids,
                                   causal=causal, block_q=128, block_k=128,
                                   interpret=True)

    _, vjp = jax.vjp(f, *jin, jbias)
    jgrads = [w for w in vjp(jnp.asarray(g)) if w is not None]

    tin = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tbias = None if bias is None else torch.from_numpy(bias).requires_grad_()
    tids = None if ids is None else tuple(map(torch.from_numpy, ids))
    tout = tfa.flash_attention(*tin, bias=tbias, segment_ids=tids,
                               causal=causal)
    tout.backward(torch.from_numpy(g))
    _, tlse = tfa.flash_attention_plain(*(t.detach() for t in tin),
                                        bias=None if tbias is None
                                        else tbias.detach(),
                                        segment_ids=tids, causal=causal)
    tgrads = [t.grad for t in tin] + ([] if tbias is None else [tbias.grad])
    return dict(out=(tout.detach().numpy(), np.asarray(jout)),
                lse=(tlse.numpy(), np.asarray(jlse).reshape(tlse.shape)),
                grads=[(a.numpy(), np.asarray(w))
                       for a, w in zip(tgrads, jgrads)])


@pytest.mark.parametrize("form", PALLAS_FORMS)
@pytest.mark.parametrize("d", PALLAS_DIMS)
def test_plain_forward_matches_pallas_interpret(d, form):
    """K1's plain version against ``_flash_fwd`` (``_fwd_kernel``, or
    ``_fwd_kernel_wide`` without a mask) in interpret mode."""
    case = _pallas_case(d, form)
    for name in ("out", "lse"):
        got, want = case[name]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("form", PALLAS_FORMS)
@pytest.mark.parametrize("d", PALLAS_DIMS)
def test_plain_backward_matches_pallas_interpret(d, form):
    """K3's and K4's plain versions (dbias with a bias) against ``jax.vjp``
    of ``flash_attention(..., interpret=True)``: the Pallas
    ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``."""
    grads = _pallas_case(d, form)["grads"]
    assert len(grads) == (4 if form == "bias" else 3)
    for name, (got, want) in zip(("dq", "dk", "dv", "dbias"), grads):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


# --------------------------------------------------- the VAEs' gradients
def _grads_close(name, got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=1e-4 * scale + 1e-5, rtol=0,
                               err_msg=name)


def _vae_grads(jmod, tmod, z, seed):
    """Gradients of <decoder(z), r> with respect to z and every parameter
    from both packages, the port's parameters loaded from the JAX ones."""
    params = jax_random_params(jmod, jnp.asarray(z), seed=seed)
    out_shape = jax.eval_shape(jmod.apply, {"params": params},
                               jnp.asarray(z)).shape
    r = _rand(out_shape, seed + 1)

    def loss(params, z):
        return jnp.sum(jmod.apply({"params": params}, z) * r)

    jp, jz = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(z))
    load_jax_params(tmod, params)
    tz = torch.from_numpy(z).requires_grad_()
    (tmod(tz) * torch.from_numpy(r)).sum().backward()
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    got = {n: p.grad for n, p in tmod.named_parameters()}
    assert set(got) == set(want)
    assert all(g is not None for g in got.values())
    _grads_close("z", tz.grad.numpy(), np.asarray(jz))
    for name in sorted(got):
        _grads_close(name, got[name].numpy(), want[name].numpy())
    return got


def test_sd1_vae_decoder_gradients_match_jax():
    """SD1's VAEDecoder at full width (mid attention: one head of 512 over
    the 16 tokens of a 4 x 4 latent)."""
    got = _vae_grads(jsd1.VAEDecoder(), tsd1.VAEDecoder(),
                     _rand((1, 4, 4, 4), 50, 0.5), seed=51)
    assert tuple(got["mid_attn.attn.qkv.weight"].shape) == (3 * 512, 512)


def test_sd3_vae_decoder_gradients_match_jax_at_mid_width_384():
    """The SD3 VAE decoder at ch=96, ch_mult=(1, 2, 4): its mid attention is
    one head of 384, a head dim between 257 and 511."""
    kw = dict(ch=96, ch_mult=(1, 2, 4), num_res_blocks=1)
    tmod = tvae.SD3VAEDecoder(**kw)
    assert tmod.mid_attn.attn.num_heads == 1
    got = _vae_grads(jvae.SD3VAEDecoder(**kw), tmod,
                     _rand((1, 4, 6, 16), 52, 0.5), seed=53)
    assert tuple(got["mid_attn.attn.qkv.weight"].shape) == (3 * 384, 384)
