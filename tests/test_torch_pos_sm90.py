"""K5's, K6's and K7's dispatch, on the CPU.

Which kernel a CUDA launch of K5 (the position-masked forward), K6 (its dq
under a global lse) or K7 (its dk, dv) runs is decided in Python before
anything reaches the card (``k5_route``, ``k6_route``, ``k7_route``): the
position-mask forms of the TMA / wgmma kernels of
``csrc/flash_attention_sm90.cu`` (K5), ``csrc/flash_attention_dq_sm90.cu``
(K6) and ``csrc/flash_attention_bwd_sm90.cu`` (K7) for bf16 at head dims 64
and 128,
whatever the masks (causal by position, ``valid_len``, two segments on a
side, the bounded softmax), and the fp32 library for fp32 at head dim 64;
every other (dtype, head dim) raises before a launch. On CPU tensors the
public entries run the plain versions and no counter moves. The kernels
themselves are tested on the card (``tests/test_torch_cuda_kernels.py``).
"""

import pytest
import torch

from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as tfa

BF16, F32 = torch.bfloat16, torch.float32
# name -> (causal, valid_len, two segments, bounded)
FORMS = {
    "none": (False, False, False, False),
    "causal": (True, False, False, False),
    "valid_len": (False, True, False, False),
    "two segments": (False, False, True, False),
    "bounded": (False, False, False, True),
    "all": (True, True, True, True),
}
HEAD_DIMS = [40, 64, 80, 128, 512]


def _want(dtype, d):
    """The route the port's contract gives K5, K6 and K7 (any form), or the
    exception it raises."""
    if dtype == F32:
        return "fp32" if d == 64 else NotImplementedError
    return "sm90" if d in (64, 128) else NotImplementedError


def _check_route(route, want, *args):
    if want is NotImplementedError:
        with pytest.raises(NotImplementedError) as err:
            route(*args)
        # the message names what the kernels take
        assert "take" in str(err.value)
        if args[0] == F32 and args[1] == 128:
            assert "pass bf16" in str(err.value)
    else:
        assert route(*args) == want


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_k5_route_by_dtype_head_dim_and_form(dtype, d, form):
    _check_route(tfa.k5_route, _want(dtype, d), dtype, d, *FORMS[form])


@pytest.mark.parametrize("form", sorted(f for f in FORMS if f != "bounded"))
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_k6_route_by_dtype_head_dim_and_form(dtype, d, form):
    # the backward is the same function for both softmaxes: no bounded form
    _check_route(tfa.k6_route, _want(dtype, d), dtype, d, *FORMS[form][:3])


@pytest.mark.parametrize("form", sorted(f for f in FORMS if f != "bounded"))
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "fp32"])
def test_k7_route_by_dtype_head_dim_and_form(dtype, d, form):
    # the backward is the same function for both softmaxes: no bounded form
    _check_route(tfa.k7_route, _want(dtype, d), dtype, d, *FORMS[form][:3])


@pytest.mark.parametrize("route", [tfa.k5_route, tfa.k6_route,
                                   tfa.k7_route], ids=["k5", "k6", "k7"])
def test_pos_routes_refuse_other_dtypes(route):
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            route(dtype, 64)


def _counters(*fns):
    """Launches, by dtype and by route."""
    return [(fn.launches, dict(fn.dtypes), dict(getattr(fn, "routes", {})))
            for fn in fns]


def test_cpu_tensors_never_reach_k5():
    """``flash_attention_pos`` on CPU tensors runs the plain version, in
    every form, and no counter of K5 moves; the K5 wrapper itself refuses
    CPU tensors."""
    q = torch.zeros(1, 2, 96, 64, dtype=BF16)
    k = torch.zeros(1, 2, 130, 64, dtype=BF16)
    off = torch.tensor([0, 500], dtype=torch.int32)
    before = _counters(tfa.flash_attention_pos_cuda)
    for causal, valid, two, bounded in FORMS.values():
        out, lse = tfa.flash_attention_pos(
            q, k, k, off, off, causal=causal,
            valid_len=300 if valid else None, seg_q=48 if two else None,
            seg_k=64 if two else None,
            stability="bounded" if bounded else "online")
        assert out.shape == q.shape and lse.shape == (1, 2, 96)
    assert _counters(tfa.flash_attention_pos_cuda) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_pos_cuda(q, k, k, off, off)


def test_cpu_tensors_never_reach_k7():
    """``flash_bwd_pos`` on CPU tensors runs the plain version and no
    counter of K6 or K7 moves; the K7 wrapper itself refuses CPU tensors."""
    q = torch.zeros(1, 2, 96, 64, dtype=BF16)
    k = torch.zeros(1, 2, 130, 64, dtype=BF16)
    lse, delta = torch.zeros(1, 2, 96), torch.zeros(1, 2, 96)
    off = torch.tensor([0, 500], dtype=torch.int32)
    before = _counters(tfa.flash_bwd_pos_dq_cuda, tfa.flash_bwd_pos_dkv_cuda)
    for causal, valid, two, _ in FORMS.values():
        dq, dk, dv = tfa.flash_bwd_pos(
            q, k, k, q, lse, delta, off, off, causal=causal,
            valid_len=300 if valid else None, seg_q=48 if two else None,
            seg_k=64 if two else None)
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert _counters(tfa.flash_bwd_pos_dq_cuda,
                     tfa.flash_bwd_pos_dkv_cuda) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_bwd_pos_dkv_cuda(q, k, k, q, lse, delta, off, off)


def test_cpu_tensors_never_reach_k6():
    """``flash_bwd_pos`` on CPU tensors runs the plain version, in every
    form, and no counter of K6 moves; the K6 wrapper itself refuses CPU
    tensors, before its route is asked."""
    q = torch.zeros(1, 2, 96, 64, dtype=BF16)
    k = torch.zeros(1, 2, 130, 64, dtype=BF16)
    lse, delta = torch.zeros(1, 2, 96), torch.zeros(1, 2, 96)
    off = torch.tensor([0, 500], dtype=torch.int32)
    before = _counters(tfa.flash_bwd_pos_dq_cuda)
    for causal, valid, two, _ in FORMS.values():
        dq = tfa.flash_bwd_pos(
            q, k, k, q, lse, delta, off, off, causal=causal,
            valid_len=300 if valid else None, seg_q=48 if two else None,
            seg_k=64 if two else None)[0]
        assert dq.shape == q.shape and dq.dtype == BF16
    assert _counters(tfa.flash_bwd_pos_dq_cuda) == before
    for dtype in (BF16, F32):
        q_, k_ = q.to(dtype), k.to(dtype)
        with pytest.raises(ValueError, match="CUDA tensors"):
            tfa.flash_bwd_pos_dq_cuda(q_, k_, k_, q_, lse, delta, off, off)
