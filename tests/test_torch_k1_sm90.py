"""K1's dispatch and the C interface of the kernel libraries, on the CPU.

Which kernel a CUDA launch of K1 runs is decided in Python before anything
reaches the card (``k1_route``): the TMA / wgmma kernel of
``csrc/flash_attention_sm90.cuh`` for bf16 at every head dim from 1 to 256
in every mask form, the TMA / wgmma kernel of ``csrc/flash_attention.cu``
for bf16 from 257 to 512 in every mask form, the fp32 library for fp32 (its
TF32 kernels at every head dim up to 512 in every form, T5's bias alone at
head dim 64 on its own); every other (dtype, head dim) raises before a
launch. The ctypes signatures are held against the
argument counts of the ``extern "C"`` declarations in the sources, which
nothing compiles here. The kernels themselves are tested on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import re
import types
from pathlib import Path

import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu_torch.models.layers import (
    TransformerBlock)
from from_ddpm_to_stable_diffusion_tpu_torch.models.sd1 import SD1UNet
from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build
from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as tattn
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

BF16, F32 = torch.bfloat16, torch.float32
FORMS = {  # name -> (causal, bias, segments)
    "none": (False, False, False), "causal": (True, False, False),
    "bias": (False, True, False), "segments": (False, False, True),
    "causal+bias": (True, True, False), "causal+segments": (True, False, True),
    "bias+segments": (False, True, True), "all": (True, True, True),
}


def _want(dtype, d, form):
    """The route the port's contract gives, or the exception it raises."""
    causal, bias, seg = FORMS[form]
    if dtype == F32:
        # the TF32 kernels at every head dim up to 512 in every form
        return "fp32"
    return "d512" if d > 256 else "sm90"


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("d", [8, 40, 48, 64, 72, 80, 128, 160, 512])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_k1_route_by_dtype_head_dim_and_form(dtype, d, form):
    want = _want(dtype, d, form)
    causal, bias, seg = FORMS[form]
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError) as err:
            tfa.k1_route(dtype, d, causal, bias, seg)
        # the message names what the kernels take
        assert "take" in str(err.value)
    else:
        assert tfa.k1_route(dtype, d, causal, bias, seg) == want


@pytest.mark.parametrize("d", [0, 513, 640])
def test_k1_route_refuses_other_head_dims_and_dtypes(d):
    for dtype in (BF16, F32):
        with pytest.raises(NotImplementedError, match=str(d)):
            tfa.k1_route(dtype, d)
    with pytest.raises(TypeError):
        tfa.k1_route(torch.float16, 64)


def test_checks_sd1_unet_takes_k1_fp32_at_head_dim_8():
    """``checks sd1`` runs SD1UNet(model_channels=64) in fp32 on a 32^2
    latent: its level-0 self-attentions (8 heads of 8, 1024 tokens) are the
    flash-eligible ones, and K1 takes them in fp32 on its TF32 kernel, causal
    too; in bf16 the sm90 kernel takes head dim 8 as it takes every head dim
    up to 256."""
    with torch.device("meta"):
        unet = SD1UNet(model_channels=64)
    blocks = [m for m in unet.modules() if isinstance(m, TransformerBlock)]
    dims = {m.attn1.qkv.weight.shape[1] // m.attn1.num_heads for m in blocks}
    level0 = [m for m in blocks if m.attn1.qkv.weight.shape[1] == 64]
    assert dims == {8, 16, 32} and len(level0) == 5
    assert tfa.k1_route(F32, 8) == "fp32"
    assert tfa.k1_route(F32, 8, causal=True) == "fp32"
    assert tfa.k1_route(BF16, 8) == "sm90"


def _unet_attentions(height, width):
    """(block, heads, head dim, Lq, Lk) of every attention of ``SD1UNet()``
    for a (height, width) image, from its module tree alone: the UNet is
    built on the meta device and never run. Each ``_down`` halves the latent
    (rounding up, as a stride-2 convolution with padding 1 does), each
    ``_up`` doubles it; a TransformerBlock's self-attention sees the level's
    tokens, its cross-attention CLIP's 77."""
    with torch.device("meta"):
        unet = SD1UNet()
    h, w = height // 8, width // 8
    sizes, found = [(h, w)], []
    for name, mod in unet.named_children():
        if name.endswith("_down"):
            h, w = -(-h // 2), -(-w // 2)
            sizes.append((h, w))
        elif name.endswith("_up"):
            sizes.pop()
            h, w = sizes[-1]
        elif isinstance(mod, TransformerBlock):
            heads = mod.attn1.num_heads
            d = mod.attn1.qkv.weight.shape[1] // heads
            found += [(name + ".attn1", heads, d, h * w, h * w),
                      (name + ".attn2", heads, d, h * w, 77)]
    return found


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("size", [(512, 512), (768, 768), (512, 1024)])
def test_every_flash_eligible_sd1_attention_has_a_k1_route(size, dtype):
    """Every attention of the SD1 UNet that the dispatch rule would send to
    the flash kernel on the card has a K1 route in both dtypes; from 768^2
    (and at 512 x 1024) that includes the level-2 self-attention at head
    dim 160."""
    attns = _unet_attentions(*size)
    assert len(attns) == 2 * 16
    eligible = []
    for block, heads, d, lq, lk in attns:
        on_card = types.SimpleNamespace(is_cuda=True,
                                        shape=(1, heads, lq, d))
        keys = types.SimpleNamespace(is_cuda=True, shape=(1, heads, lk, d))
        if tattn._flash_eligible(on_card, keys):
            want = "fp32" if dtype == F32 else "sm90"
            assert tfa.k1_route(dtype, d) == want, block
            eligible.append(d)
    # the two levels of 40 and 80 always; 160 from 768^2 and at 512 x 1024
    assert {40, 80} <= set(eligible)
    assert (160 in eligible) == (size != (512, 512))


def _extern_c_arg_counts():
    """name -> number of parameters of every ``extern "C"`` function
    defined in ``csrc/*.cu`` and ``csrc/fp32/*.cu``."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")) + sorted(
            (_build.CSRC / "fp32").glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            assert m.group(1) not in found, m.group(1)
            found[m.group(1)] = len(params)
    return found


@pytest.mark.parametrize("library", ["kernels", "kernels_fp32"])
def test_ctypes_signatures_match_the_c_entries(library):
    entries = _extern_c_arg_counts()
    signatures = _build._LIBRARIES[library][1]
    for name, argtypes in signatures.items():
        assert name in entries, name
        assert len(argtypes) == entries[name], name
    # the library's sources define exactly its entries
    src_dir = _build._LIBRARIES[library][0]
    defined = set()
    for src in src_dir.glob("*.cu"):
        defined |= set(re.findall(r'extern "C" int (\w+)\(', src.read_text()))
    assert defined == set(signatures)


def test_segment_tiles_are_the_sm90_kernels_tiles():
    """The wrapper builds K1's segment-id tile bounds and ranges at the
    query and key tile of the kernel it launches."""
    text = (_build.CSRC / "flash_attention_sm90.cuh").read_text()
    m = re.search(r"constexpr int kBQ = (\d+), kBK = (\d+)", text)
    assert m and tuple(map(int, m.groups())) == tfa._FWD_TILES == (128, 128)


def test_tma_operand_copies_only_expanded_tensors():
    x = torch.zeros(2, 3, 5, 8, dtype=BF16)
    assert tfa._tma_operand(x) is x
    view = torch.zeros(2, 5, 3, 8, dtype=BF16).transpose(1, 2)
    assert tfa._tma_operand(view) is view
    one_head = torch.zeros(2, 5, 1, 8, dtype=BF16).transpose(1, 2)
    assert tfa._tma_operand(one_head) is one_head
    expanded = torch.zeros(1, 3, 5, 8, dtype=BF16).expand(2, -1, -1, -1)
    got = tfa._tma_operand(expanded)
    assert got.is_contiguous() and torch.equal(got, expanded)


def test_cpu_tensors_never_reach_a_route():
    """On CPU tensors the wrappers run the plain version and count no
    launch, whatever the route of the same call on the card would be."""
    q = torch.zeros(1, 1, 64, 40, dtype=BF16)
    before = (tfa.flash_attention_cuda.launches,
              dict(tfa.flash_attention_cuda.routes))
    out, lse = tfa.flash_attention_forward(q, q, q)
    assert out.shape == q.shape and lse.shape == (1, 1, 64)
    assert (tfa.flash_attention_cuda.launches,
            dict(tfa.flash_attention_cuda.routes)) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_cuda(q, q, q)


def _vae_attentions(run):
    """(B, H, Lq, Lk, D) of every attention that ``run()`` reaches, on the
    meta device, where nothing is computed."""
    seen = []
    saved = tattn.dot_product_attention

    def record(q, k, v, *args, **kw):
        seen.append((*q.shape[:3], k.shape[2], q.shape[3]))
        return saved(q, k, v, *args, **kw)

    tattn.dot_product_attention = record
    try:
        with torch.device("meta"), torch.no_grad():
            run()
    finally:
        tattn.dot_product_attention = saved
    return seen


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_sd3_vae_encoder_and_tiled_head_attentions_have_a_k1_route(dtype):
    """The SD3 VAE encoder on a 1024^2 init image and the tiled decode's
    head at batch 2 (1024^2): each runs one mid attention over 128 x 128
    tokens at head dim 512, which the dispatch sends to K1 (d512 in bf16)."""
    from from_ddpm_to_stable_diffusion_tpu_torch.models.sd3_vae import (
        SD3VAEDecoder, SD3VAEEncoder)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.sd3_vae_tiled import (
        tiled_decode)

    def encode():
        SD3VAEEncoder().to(dtype)(torch.empty(1, 1024, 1024, 3))

    def tiled():
        tiled_decode(SD3VAEDecoder().to(dtype),
                     torch.empty(2, 128, 128, 16))

    for run, batch in ((encode, 1), (tiled, 2)):
        attns = _vae_attentions(run)
        assert attns == [(batch, 1, 16384, 16384, 512)]
        for b, h, lq, lk, d in attns:
            on_card = types.SimpleNamespace(is_cuda=True, shape=(b, h, lq, d))
            keys = types.SimpleNamespace(is_cuda=True, shape=(b, h, lk, d))
            assert tattn._flash_eligible(on_card, keys)
            assert tfa.k1_route(dtype, d) == ("d512" if dtype == BF16
                                              else "fp32")


def video_unet_attentions(batch, dtype):
    """(B, H, Lq, Lk, D) of every attention of one ``TinyVideoUNet``
    forward at the video CLI's defaults (channel 64, 32², 8 frames) on
    ``batch`` clips, on the meta device."""
    from from_ddpm_to_stable_diffusion_tpu_torch.models.tiny_video_unet import (
        TinyVideoUNet)

    def run():
        TinyVideoUNet(base_channels=64, num_classes=3, dtype=dtype)(
            torch.empty(batch, 8, 32, 32, 3),
            torch.empty(batch, dtype=torch.long),
            torch.empty(batch, dtype=torch.long))

    return _vae_attentions(run)


def flash_eligible(attns):
    """The attentions that the dispatch would send to the flash kernels on
    the card."""
    out = []
    for b, h, lq, lk, d in attns:
        on_card = types.SimpleNamespace(is_cuda=True, shape=(b, h, lq, d))
        keys = types.SimpleNamespace(is_cuda=True, shape=(b, h, lk, d))
        if tattn._flash_eligible(on_card, keys):
            out.append((b, h, lq, lk, d))
    return out


@pytest.mark.parametrize("batch", [32, 6], ids=["train", "cfg-sample"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_video_unet_level0_attention_has_a_k1_route(batch, dtype):
    """The video UNet at the CLI's defaults: the level-0 self-attentions of
    ``enc1_att`` and ``dec2_att`` (1024 tokens of the 32² frames, one head
    of 64, the frames folded into the batch: (B·8, 1, 1024, 1024, 64) for
    a train batch of 32 and CFG sampling of 3 clips at batch 6) take K1 in
    both dtypes; the other 13 attentions (the 16² and 8² levels, the
    one-token cross-attentions, the 8-frame temporal attentions) stay
    plain."""
    attns = video_unet_attentions(batch, dtype)
    assert len(attns) == 15   # 5 spatial blocks (self + cross), 5 temporal
    assert flash_eligible(attns) == [(8 * batch, 1, 1024, 1024, 64)] * 2
    assert tfa.k1_route(dtype, 64) == ("sm90" if dtype == BF16 else "fp32")
