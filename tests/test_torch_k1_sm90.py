"""K1's dispatch and the C interface of the kernel libraries, on the CPU.

Which kernel a CUDA launch of K1 runs is decided in Python before anything
reaches the card (``k1_route``): the TMA / wgmma kernel of
``csrc/flash_attention_sm90.cu`` for bf16 at every head dim but 512 and for
every mask form, the mma.sync kernel of ``csrc/flash_attention.cu`` for bf16
at head dim 512, the fp32 library for fp32; every other (dtype, head dim,
form) raises before a launch. The ctypes signatures are held against the
argument counts of the ``extern "C"`` declarations in the sources, which
nothing compiles here. The kernels themselves are tested on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import re
from pathlib import Path

import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build
from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa

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
        if bias or seg or (causal and d != 64):
            return NotImplementedError
        return "fp32"
    if form != "none" and d not in (64, 128):
        return NotImplementedError
    return "d512" if d == 512 else "sm90"


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("d", [40, 48, 64, 72, 80, 128, 512])
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


@pytest.mark.parametrize("d", [32, 96, 256])
def test_k1_route_refuses_other_head_dims_and_dtypes(d):
    for dtype in (BF16, F32):
        with pytest.raises(NotImplementedError, match=str(d)):
            tfa.k1_route(dtype, d)
    with pytest.raises(TypeError):
        tfa.k1_route(torch.float16, 64)


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
    text = (_build.CSRC / "flash_attention_sm90.cu").read_text()
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
