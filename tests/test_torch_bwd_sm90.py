"""K3's and K4's dispatch and tiles, the fp32 forward's constants, and K1's
key split at head dim 512, on the CPU.

Which kernel a CUDA launch of K3 (dq) or K4 (dk, dv) runs is decided in
Python before anything reaches the card (``k3_route``, ``k4_route``): the
TMA / wgmma kernels of ``csrc/flash_attention_dq_sm90.cuh`` and
``csrc/flash_attention_bwd_sm90.cuh`` for bf16 at every head dim from 1 to
256 in every form, that of ``csrc/flash_attention_wide_bwd_sm90.cuh`` from
257 to 512 ("wide"), the fp32 library for fp32 in every form up to 512 (its
TF32 kernels: one block up to 128, a cluster of two blocks to 256, the
streaming kernel above); every other (dtype, head dim) raises before a
launch. The segment-id ranges the wrapper builds must be at each kernel's
tiles, and the workspace the wrapper allocates for the fp32 forward must
match the source's layout. Above head dim 256 the host splits the keys of
K1 over up to four blocks per 64-query tile when the query tiles alone do
not fill the card (``k1_d512_splits``). The kernels themselves are tested
on the card (``tests/test_torch_cuda_kernels.py``).
"""

import re

import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

BF16, F32 = torch.bfloat16, torch.float32
FORMS = {  # name -> (causal, bias, segments)
    "none": (False, False, False), "causal": (True, False, False),
    "bias": (False, True, False), "segments": (False, False, True),
    "causal+bias": (True, True, False), "causal+segments": (True, False, True),
    "bias+segments": (False, True, True), "all": (True, True, True),
}
H100_SMS = 132


def _want_bwd(dtype, d, form):
    """The route the port's contract gives, or the exception it raises."""
    causal, bias, seg = FORMS[form]
    if not 1 <= d <= 512:
        return NotImplementedError
    if dtype == F32:
        return "fp32"
    return "wide" if d > 256 else "sm90"


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("d", [40, 48, 64, 72, 80, 128, 512])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_k4_route_by_dtype_head_dim_and_form(dtype, d, form):
    want = _want_bwd(dtype, d, form)
    causal, bias, seg = FORMS[form]
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError) as err:
            tfa.k4_route(dtype, d, causal, bias, seg)
        # the message names what the kernels take
        assert "take" in str(err.value)
    else:
        assert tfa.k4_route(dtype, d, causal, bias, seg) == want


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("d", [40, 48, 64, 72, 80, 128, 512])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_k3_route_by_dtype_head_dim_and_form(dtype, d, form):
    want = _want_bwd(dtype, d, form)
    causal, bias, seg = FORMS[form]
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError) as err:
            tfa.k3_route(dtype, d, causal, bias, seg)
        assert "take" in str(err.value)
    else:
        assert tfa.k3_route(dtype, d, causal, bias, seg) == want


@pytest.mark.parametrize("d", [0, 513, 1024])
def test_k3_route_refuses_other_head_dims_and_dtypes(d):
    for dtype in (BF16, F32):
        with pytest.raises(NotImplementedError, match=str(d)):
            tfa.k3_route(dtype, d)
    with pytest.raises(TypeError):
        tfa.k3_route(torch.float16, 64)


@pytest.mark.parametrize("d", [0, 513, 1024])
def test_k4_route_refuses_other_head_dims_and_dtypes(d):
    for dtype in (BF16, F32):
        with pytest.raises(NotImplementedError, match=str(d)):
            tfa.k4_route(dtype, d)
    with pytest.raises(TypeError):
        tfa.k4_route(torch.float16, 64)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_k1_route_at_head_dim_512(form):
    """bf16 at d = 512 takes the d512 kernel (``csrc/flash_attention.cu``)
    in every form, as at every head dim from 257; fp32 the fp32 library;
    above 512 every form raises naming what the kernels take."""
    causal, bias, seg = FORMS[form]
    for d in (257, 300, 384, 385, 512):
        assert tfa.k1_route(BF16, d, causal, bias, seg) == "d512"
        assert tfa.k1_route(F32, d, causal, bias, seg) == "fp32"
    for dtype in (BF16, F32):
        with pytest.raises(NotImplementedError, match="take"):
            tfa.k1_route(dtype, 520, causal, bias, seg)


def _source(name):
    return (_build.CSRC / name).read_text()


def test_segment_tiles_are_the_sm90_k3_tiles():
    """The wrapper builds K3's segment-id tile bounds and ranges at the
    (query tile, key tile) of the kernel it launches."""
    m = re.search(r"constexpr int kBQ = (\d+), kBK = (\d+)",
                  _source("flash_attention_dq_sm90.cuh"))
    assert m and tuple(map(int, m.groups())) == tfa._DQ_TILES == (128, 64)


def test_fp32_forward_constants_are_the_wrappers():
    """The passes, the key group of v's transposed terms (in the split
    pre-pass the forward shares with the backward) and the tiles above head
    dim 256 (of the streaming kernel, fp32/flash_f32_fwd_wide.cuh), its
    widths and splits of csrc/fp32/flash_f32_fwd.cu (and its header) are
    what the wrapper assumes when it sizes the workspace and the key
    splits."""
    text = _source("fp32/flash_f32_fwd.cu") + _source("fp32/flash_f32_fwd.cuh")
    m = re.search(r"constexpr int kPasses = (\d+);", text)
    assert m and int(m.group(1)) == tfa._F32_PASSES == 3
    m = re.search(r"constexpr int kKeyGroup = (\d+);",
                  _source("fp32/split_f32.cuh"))
    assert m and int(m.group(1)) == tfa._F32_KEY_GROUP
    m = re.search(r"static constexpr int kBQ = (\d+), kBK = (\d+), kHalf",
                  _source("fp32/flash_f32_fwd_wide.cuh"))
    assert m and tuple(map(int, m.groups())) == (tfa._D512_TILE,) * 2
    assert ": run_stream<512>(w, p, splits, form, s)" in text
    assert "d <= 384 ? run_stream<384>(w, p, splits, form, s)" in text
    assert tfa._WIDE_WIDTHS == (384, 512)
    m = re.search(r"constexpr int kMaxSplits = (\d+);", text)
    assert m and int(m.group(1)) == tfa._D512_MAX_SPLITS
    # the workspace: three hi / lo pairs, then DP + 1 floats a row per split
    assert "w.part = w.vt + 2 * w.nv;" in text
    assert "splits * B * H * Lq * (DP + 1)" in text


@pytest.mark.parametrize("b,h,lq,lk,d,splits,want", [
    (1, 1, 8, 8, 64, 1, 2 * 64 * (8 + 8 + 8)),
    (2, 3, 5, 9, 40, 1, 2 * 6 * 40 * (5 + 9 + 16)),      # Lk8 = 16
    (1, 1, 64, 65, 512, 1, 2 * 512 * (64 + 65 + 72)),
    (1, 1, 64, 65, 512, 2, 2 * 512 * (64 + 65 + 72) + 2 * 64 * 513),
    (1, 1, 64, 65, 128, 2, 2 * 128 * (64 + 65 + 72)),     # splits: above 256
    (1, 1, 64, 65, 304, 3, 2 * 304 * (64 + 65 + 72) + 3 * 64 * 385),
])
def test_fp32_forward_workspace(b, h, lq, lk, d, splits, want):
    assert tfa.f32_forward_work(b, h, lq, lk, d, splits) == want

SMEM_LIMIT = 232448   # dynamic shared memory a block may take on the H100


def _f32_fwd_smem(dp, bias=False):
    """Shared memory of the fp32 K1 / K5 kernel at head dim dp < 512, as its
    Cfg lays it out: both terms of the Q tile, K and v^T tiles on their
    rings, the fp32 bias tile, barriers and the 1 KB alignment."""
    cons = 2 if dp <= 128 else 1
    bq, bk = 64 * cons, 32 if dp >= 80 else 64
    two = 2 * bq * dp * 4 + 2 * 4 * bk * dp * 4 + 1024 + 8 * 11 <= SMEM_LIMIT
    stages = 2 if two and dp < 128 else 1
    tiles = 2 * bq * dp * 4 + stages * 2 * 2 * bk * dp * 4
    return tiles + (bq * bk * 4 if bias else 0) + 8 * (1 + 4 * stages + 2) \
        + 1024


@pytest.mark.parametrize("dp,bias", [(40, False), (64, False),
                                     (128, False), (160, False),
                                     (64, True), (16, False), (96, False),
                                     (112, False), (144, False)])
def test_fp32_forward_tiles_fit_in_shared_memory(dp, bias):
    """d = 160 takes 64-query blocks (one consumer) and the bias form adds
    a 128 x 64 fp32 tile; both fit beside the Q tile and the rings, as every
    width up to 160 does (two stages where they fit, below 128)."""
    text = _source("fp32/flash_f32_fwd.cuh")
    for rule in ("kCons = DP <= 128 ? 2 : 1", "kBK = DP >= 80 ? 32 : 64",
                 "2 * kBQ * DP * 4 + 2 * 4 * kBK * DP * 4 + 1024 + 8 * 11 <= "
                 "232448 &&", "DP < 128",
                 "kBarOff = kBiasOff + (HAS_BIAS ? kBQ * kBK * 4 : 0)"):
        assert rule in text, rule
    assert _f32_fwd_smem(dp, bias) <= SMEM_LIMIT
    if dp == 160:
        assert _f32_fwd_smem(dp) - 1024 - 8 * 7 == 163840
    if bias:
        assert _f32_fwd_smem(dp, bias) == 230488


def _f32_wide_smem(dp):
    """Bytes of one block of the fp32 dq and dk/dv pair above 128 (tiles of
    both terms, the slot for the other block's partials, the push buffer
    where ring A has one stage, the barriers and the 1 KB alignment), by the
    rules of csrc/fp32/flash_f32_bwd.cuh: each block owns DH = DP / 2
    columns; dq keeps its half of Q and dO and rings its half of K, V (tiles
    of 32 keys up to DP 192, 16 above) and of K^T; dk/dv keeps its half of K
    and V and rings its half of Q, dO (tiles of 32 queries up to DP 160, 16
    above) and of Q^T, dO^T; ring A takes two stages where they fit (the
    partials pushed from the stage just read), else one and a push buffer;
    ring B two where they fit. Returns {"dq": (bytes, stages A, stages B),
    "dkv": ...}."""
    dh = dp // 2
    out = {}
    for kind, rows, width in (("dq", 64, 32 if dp <= 192 else 16),
                              ("dkv", 64, 32 if dp <= 160 else 16)):
        fixed = 4 * rows * dh * 4
        a = 4 * width * dh * 4
        b = (2 if kind == "dq" else 4) * dh * width * 4
        x = 128 * width * 4
        sa = 2 if fixed + 2 * a + b + x + 8 * 12 + 1024 <= SMEM_LIMIT else 1
        push = 0 if sa == 2 else x
        sb = (2 if fixed + sa * a + 2 * b + x + push + 8 * 14 + 1024
              <= SMEM_LIMIT else 1)
        bars = 1 + 2 * sa + 2 * sb + 5
        out[kind] = (fixed + sa * a + sb * b + x + push + 8 * bars + 1024,
                     sa, sb)
    return out


@pytest.mark.parametrize("d", [64, 128, 160, 192, 224, 256])
def test_fp32_backward_tiles_fill_shared_memory(d):
    """The tiles of the TF32 backward at each head dim, from the rules in
    csrc/fp32/flash_f32_bwd.cu: dq keeps both terms of Q and dO and rings K,
    V and K^T tiles of 32 keys; dk/dv keeps K and V and rings Q, dO (two
    stages) and Q^T, dO^T (one) tiles of 32 or 16 queries. Both come to the
    229,376 B of tiles the header states. Above 128 (flash_f32_bwd.cuh) a
    cluster of two blocks shares the columns, and each block's tiles and
    slot for the other's partials come to the bytes its header states, within
    the limit."""
    if d > 128:
        text = " ".join(_source("fp32/flash_f32_bwd.cuh").split())
        for rule in ("kDH = DP / 2", "kBQ = 64, kBK = DP <= 192 ? 32 : 16",
                     "kBQ = DP <= 160 ? 32 : 16",
                     "kXBytes = 128 * kBK * 4", "kXBytes = 128 * kBQ * 4",
                     "kAOff + 2 * kAStage + kBStage + kXBytes + 8 * 12 + "
                     "1024 <= kSmemLimit",
                     "kAOff + kStagesA * kAStage + 2 * kBStage + kXBytes + "
                     "kOutBytes + 8 * 14 + 1024 <= kSmemLimit",
                     "kFold = kStagesA == 2", "kOutBytes = kFold ? 0 : "
                     "kXBytes", "kExchangeBars = 5", "kSmemLimit = 232448",
                     "__cluster_dims__(2, 1, 1)"):
            assert rule in text, rule
        # the bytes a block, ring A's and B's stages, as the header states
        stated = {160: ((221184, 2, 2), (221184, 2, 1)),
                  192: ((229376, 1, 2), (204800, 2, 2)),
                  224: ((208896, 2, 2), (208896, 2, 1)),
                  256: ((221184, 2, 1), (212992, 1, 1))}
        got = _f32_wide_smem(d)
        for kind, (tiles, sa, sb) in zip(("dq", "dkv"), stated[d]):
            nbytes, got_sa, got_sb = got[kind]
            assert (got_sa, got_sb) == (sa, sb), kind
            assert nbytes <= SMEM_LIMIT, kind
            assert tiles < nbytes - 1024 <= tiles + 8 * 14, kind
            assert f"{tiles:,}" in text, tiles
        return
    text = _source("fp32/flash_f32_bwd.cu") + _source("fp32/flash_f32_bwd.cuh")
    for rule in ("kCons = DP <= 64 ? 2 : 1", "kBQ = 64 * kCons, kBK = 32",
                 "kStages = DP <= 64 ? 2 : 1", "kBQ = DP <= 64 ? 32 : 16",
                 "kStagesA = 2, kStagesB = 1", "229,376 B of tiles"):
        assert rule in text, rule
    cons = 2 if d <= 64 else 1
    stages = 2 if d <= 64 else 1
    bq, bk = 64 * cons, 32
    dq = 4 * bq * d * 4 + stages * (4 * bk * d * 4 + 2 * d * bk * 4)
    bkey, bqt = 64 * cons, 32 if d <= 64 else 16
    dkv = 4 * bkey * d * 4 + 2 * 4 * bqt * d * 4 + 4 * d * bqt * 4
    assert dq == dkv == 229376
    assert dq + 8 * (1 + 4 * stages) + 1024 <= SMEM_LIMIT


@pytest.mark.parametrize("b,h,lq,lk,d,want", [
    (1, 1, 8, 8, 64, 2 * 64 * (16 + 16 + 8 + 16)),
    (2, 3, 5, 9, 64, 2 * 6 * 64 * (10 + 18 + 16 + 16)),   # Lq8 8, Lk8 16
    (2, 24, 154, 4096, 64,
     2 * 48 * 64 * (308 + 8192 + 4096 + 320)),            # Lq8 = 160
])
def test_fp32_backward_workspace(b, h, lq, lk, d, want):
    """q, k, v, dO as rows, then k^T and q^T, dO^T padded to 8: the layout
    both backward entries carve (csrc/fp32/flash_f32_bwd.cu)."""
    assert tfa.f32_backward_work(b, h, lq, lk, d) == want
    text = _source("fp32/flash_f32_bwd.cu")
    for line in ("w.k = w.q + 2 * w.nq;", "w.v = w.k + 2 * w.nk;",
                 "w.g = w.v + 2 * w.nk;", "w.kt = w.g + 2 * w.nq;",
                 "w.qt = w.kt + 2 * w.nkt;", "w.gt = w.qt + 2 * w.nqt;"):
        assert line in text, line


def test_segment_tiles_are_the_sm90_k4_tiles():
    """The wrapper builds K4's segment-id tile bounds and ranges at the
    (query tile, key tile) of the kernel it launches."""
    m = re.search(r"constexpr int kBQ = (\d+), kBK = (\d+)",
                  _source("flash_attention_bwd_sm90.cuh"))
    assert m and tuple(map(int, m.groups())) == tfa._DKV_TILES == (64, 128)


def test_d512_tiles_are_the_kernels_tiles():
    text = _source("flash_attention.cu")
    m = re.search(r"constexpr int kBQ = (\d+), kBK = (\d+)", text)
    assert m and tuple(map(int, m.groups())) == (tfa._D512_TILE,) * 2
    m = re.search(r"constexpr int kMaxSplits = (\d+)", text)
    assert m and int(m.group(1)) == tfa._D512_MAX_SPLITS


@pytest.mark.parametrize("entry,source", [
    ("fdsd_flash_bwd_dkv", "flash_attention_bwd_sm90.cu"),
    ("fdsd_flash_bwd_dq", "flash_attention_dq_sm90.cu"),
    ("fdsd_flash_fwd_d512", "flash_attention.cu"),
    ("fdsd_flash_fwd", "flash_attention_sm90.cu"),
    ("fdsd_flash_fwd_pos", "flash_attention_sm90.cu"),
    ("fdsd_flash_bwd_pos_dkv", "flash_attention_bwd_sm90.cu"),
    ("fdsd_flash_bwd_pos_dq", "flash_attention_dq_sm90.cu"),
    ("fdsd_flash_fwd_f32", "fp32/flash_f32_fwd.cu"),
    ("fdsd_flash_fwd_pos_f32", "fp32/flash_f32_fwd.cu"),
    ("fdsd_flash_bwd_dq_f32", "fp32/flash_f32_bwd.cu"),
    ("fdsd_flash_bwd_dkv_f32", "fp32/flash_f32_bwd.cu"),
    ("fdsd_flash_bwd_pos_dq_f32", "fp32/flash_f32_bwd.cu"),
    ("fdsd_flash_bwd_pos_dkv_f32", "fp32/flash_f32_bwd.cu"),
    ("fdsd_group_norm", "groupnorm.cu"),
    ("fdsd_group_norm_blocks_per_sm", "groupnorm.cu")])
def test_each_entry_is_defined_in_its_kernels_source(entry, source):
    defined = {str(src.relative_to(_build.CSRC))
               for src in _build.CSRC.rglob("*.cu")
               if f'extern "C" int {entry}(' in src.read_text()}
    assert defined == {source}


def test_the_mma_sync_k3_is_gone():
    """K3 runs on TMA and wgmma only: no source defines the old
    flash_bwd_dq_kernel, and no bf16 source is left that K3 came from."""
    assert not (_build.CSRC / "flash_attention_bwd.cu").exists()
    for src in _build.CSRC.rglob("*.cu"):
        assert "flash_bwd_dq_kernel(" not in src.read_text(), src.name


def test_the_mma_sync_k6_is_gone():
    """K6 runs on TMA and wgmma only (the position-mask form of K3's
    kernel): its mma.sync source and kernel are gone, no kernel source
    issues mma.sync or ldmatrix, and csrc/mma.cuh went with them (its bf16
    pair packing is sm90.cuh's pack_bf16)."""
    assert not (_build.CSRC / "flash_attention_pos_bwd.cu").exists()
    assert not (_build.CSRC / "mma.cuh").exists()
    sources = [*_build.CSRC.rglob("*.cu"), *_build.CSRC.rglob("*.cuh")]
    for src in sources:
        text = src.read_text()
        assert "flash_bwd_pos_dq_kernel(" not in text, src.name
        # the PTX instructions; comments may still name what was replaced
        assert "mma.sync.aligned" not in text, src.name
        assert "ldmatrix.sync" not in text, src.name
        assert '#include "mma.cuh"' not in text, src.name
    dq = (_build.CSRC / "flash_attention_dq_sm90.cuh").read_text()
    assert "flash_bwd_pos_dq_sm90_kernel(" in dq
    assert "__device__ __forceinline__ uint32_t pack_bf16(" in (
        _build.CSRC / "sm90.cuh").read_text()


@pytest.mark.parametrize("b,h,lq,lk,want", [
    (1, 1, 4096, 4096, 2),      # SD1's VAE at 512^2: 64 query tiles
    (1, 1, 16384, 16384, 1),    # SD3's VAE at 1024^2: 256 fill the card
    (2, 1, 4096, 4096, 1),      # 128 query tiles on 132 SMs
    (4, 1, 4096, 4096, 1),      # SD1 at batch 4
    (3, 8, 128, 4096, 2),       # B*H > 1: 48 query tiles
    (1, 2, 100, 300, 3),        # 5 key tiles over 3 splits: 2 + 2 + 1
    (1, 1, 1, 4097, 4),
    (1, 1, 64, 65, 2),
    (1, 1, 1, 1, 1),
    (1, 1, 1, 63, 1),
])
def test_d512_key_splits(b, h, lq, lk, want):
    got = tfa.k1_d512_splits(b, h, lq, lk, H100_SMS)
    assert got == want
    # every split has a key tile: the last one starts before the end
    n_kt = -(-lk // 64)
    per = -(-n_kt // got)
    assert (got - 1) * per < n_kt and got <= tfa._D512_MAX_SPLITS


def test_d512_key_splits_follow_the_sm_count():
    assert tfa.k1_d512_splits(1, 1, 4096, 4096, 114) == 1
    assert tfa.k1_d512_splits(1, 1, 4096, 4096, 256) == 4
    assert tfa.k1_d512_splits(1, 1, 2048, 4096, 132) == 4


def test_cpu_tensors_never_reach_k3():
    """On CPU tensors the backward runs the plain version and counts no K3
    launch; the K3 wrapper itself refuses CPU tensors."""
    q = torch.zeros(1, 1, 64, 64, dtype=BF16)
    lse = torch.zeros(1, 1, 64)
    before = (tfa.flash_attention_bwd_dq_cuda.launches,
              dict(tfa.flash_attention_bwd_dq_cuda.routes))
    dq, dk, dv = tfa.flash_attention_backward(q, q, q, q, lse, q,
                                              causal=True)
    assert dq.shape == q.shape and dq.dtype == BF16
    assert (tfa.flash_attention_bwd_dq_cuda.launches,
            dict(tfa.flash_attention_bwd_dq_cuda.routes)) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_bwd_dq_cuda(q, q, q, q, lse, lse)


def test_cpu_tensors_never_reach_k4():
    """On CPU tensors the backward runs the plain version and counts no
    launch; the K4 wrapper itself refuses CPU tensors."""
    q = torch.zeros(1, 1, 64, 64, dtype=BF16)
    lse = torch.zeros(1, 1, 64)
    before = (tfa.flash_attention_bwd_dkv_cuda.launches,
              dict(tfa.flash_attention_bwd_dkv_cuda.routes))
    dq, dk, dv = tfa.flash_attention_backward(q, q, q, q, lse, q)
    assert dk.shape == q.shape and dv.dtype == BF16
    assert (tfa.flash_attention_bwd_dkv_cuda.launches,
            dict(tfa.flash_attention_bwd_dkv_cuda.routes)) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_bwd_dkv_cuda(q, q, q, q, lse, lse)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_video_unet_level0_attention_has_k3_and_k4_routes(dtype):
    """The backward of the video UNet's two flash-eligible attentions at
    the video CLI's training point, (256, 1, 1024, 1024, 64), has a K3 and
    a K4 route in both dtypes; nothing else of it is flash eligible."""
    from test_torch_k1_sm90 import flash_eligible, video_unet_attentions

    eligible = flash_eligible(video_unet_attentions(32, dtype))
    assert eligible == [(256, 1, 1024, 1024, 64)] * 2
    want = "sm90" if dtype == BF16 else "fp32"
    assert tfa.k3_route(dtype, 64) == tfa.k4_route(dtype, 64) == want
