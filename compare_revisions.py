#!/usr/bin/env python3
"""Times two checkouts of the port against each other on one GPU, with the
cases, timers and phases of ``chip_smoke.py``.

    python3 compare_revisions.py DIR_A DIR_B [--only PART[,PART...]]

Each of DIR_A, DIR_B is the root of a checkout (this repository at some
commit, e.g. unpacked with ``git archive``). The measurement runs four
times, in the order A, B, B, A, each in a fresh process that imports and
builds that checkout's package but takes its cases, timers and phases from
the ``chip_smoke.py`` beside this file, so that both checkouts are measured
alike. Each run's output is printed with its label; then, for every number,
both of A's and both of B's values, the device times first.

Parts, all of them unless ``--only`` names some:
  - launch: K1's host path at small shapes (``chip_smoke.k1_launch_path``:
    the wrapper and its C entry alone, us per call, and the kernel's us);
  - kernels: K1 at ``chip_smoke.K1_SHAPES`` and ``K1_FORMS``, K3 and K4 at
    the head-dim-128 shapes of ``K1_SHAPES``, the wide shapes of
    ``chip_smoke.HEAD_DIM_TIMED`` and the TinyVLM's two forms of
    ``K1_FORMS``, K2 at ``chip_smoke.GN_CASES`` (and the wrapper's host
    time per call at the first), K5 (online and bounded), K6 and K7 at the
    four shapes of the SD3 joint attention (``chip_smoke.SD3_JOINT_SHAPES``;
    q, k, v slices of the fused projections, K6 / K7 under the lse merged
    over both streams):
    wall ms per call (``cuda_ms``) and the kernel's own device ms per call
    (profiler kernel rows of its family over 10 calls);
  - training: ``chip_smoke.phase_training`` (the tiny-SD step) and
    ``phase_sampling`` (T = 250);
  - widths: ``chip_smoke.phase_tiny_sd_widths`` (tiny-SD at ``channel: 96``
    and ``320``): the bf16 step's ms (CUDA events), device-busy ms of one
    profiled step and idle share, and the warm fp32 step's ms;
  - vlm: ``chip_smoke.phase_vlm_training`` (the TinyVLM step);
  - mmdit: ``chip_smoke.phase_mmdit_training`` (the MMDiT step at SD3's
    width, depth and 4096 + 154 tokens): ms/step (CUDA events), host ms,
    device-busy ms and idle share of one profiled step, and K5, K6 and K7's
    device ms in it;
  - sd1: an SD1 request (random weights, 512², 50 k-LMS steps, CFG 7.5) at
    batch 1 (the second of two) and 4, wall s, and the device-busy ms of one
    profiled batch-1 request;
  - t5: the T5-XXL encoder of the SD3-medium bundle on (2, 512) tokens, ms
    per call, device-busy ms of one profiled call and K1's part of it;
  - sd3: an SD3-medium request (1024², 50 steps, CFG 5), wall s of the
    second of two, and of a third under the profiler its device-busy ms,
    K5's device ms and the idle share (1 - busy / the second's wall);
  - fp32: the fp32 forward (K1 and K5 on fp32 tensors) and backward (K3 and
    K4 where ``chip_smoke.FP32_CASES`` has one, K6 and K7) at the shapes of
    ``chip_smoke.FP32_CASES``, ``chip_smoke.FP32_WIDE_CASES`` (K1 above
    head dim 160, K3 and K4 above 128) and ``FP32_POS_SHAPES``, wall ms and device
    ms per call (its flash kernels and its split pre-pass, together and the
    pre-pass alone; ``chip_smoke.fp32_fwd_device_ms``), and one fp32 SD1
    request (``SD1Models`` at fp32, 512², 10 k-LMS steps, CFG 7.5): wall s
    of the second of two, device-busy ms of a third under the profiler and
    the fp32 forward's part of it;
  - fp32train: ``chip_smoke.phase_train_fp32`` (``VLMTrainer()``, tiny-SD and
    the depth-24 MMDiT at fp32 compute, two steps each): the last step's ms
    through the fp32 kernels (CUDA events);
  - fp32bias: K1 on fp32 tensors with T5's bias (``chip_smoke.FP32_T5_SHAPE``,
    a (1, H, L, L) bias shared over the batch, scale 1.0), wall and device
    ms per call as in fp32;
  - wide: the flash backward above head dim 256 in bf16 and fp32: K3 and
    K4 at ``chip_smoke.WIDE_VAE_SHAPE`` and causal at ``WIDE_MASKED``, K6
    and K7 over the four stream pairs of SD3's joint attention at heads of
    ``chip_smoke.WIDE_JOINT_DIMS`` (one call each: four launches), and K6 /
    K7 at the ring hop of ``chip_smoke.WIDE_RING_SHAPE`` (bf16, the ring's
    only dtype): wall ms per call and the wide kernel's own device ms per
    call (profiler rows of its family; fp32 without the split pre-pass).
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PARTS = ("launch", "kernels", "training", "widths", "vlm", "mmdit", "sd1",
         "t5", "sd3", "fp32", "fp32train", "fp32bias", "wide")
K1 = "K1 flash fwd"
# K5's fp32 shapes of the SD3 joint attention (K1's: chip_smoke.FP32_CASES)
FP32_POS_SHAPES = [(2, 24, 4096, 4096, 64), (2, 24, 4096, 154, 64)]


def _chip_smoke():
    """This tree's chip_smoke.py, whichever package the process imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def _kernels(cs, out):
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf16 = torch.bfloat16
    cases = [("none", shape, {}) for shape in cs.K1_SHAPES] + cs.K1_FORMS
    for name, (b, h, lq, lk, d), m in cases:
        if lq == lk:    # q|k|v column slices of one fused projection
            q, k, v = (t.reshape(b, lq, h, d).transpose(1, 2) for t in
                       rnd(b, lq, 3 * h * d).to(bf16).chunk(3, -1))
        else:
            q, k, v = (rnd(b, h, n, d).to(bf16) for n in (lq, lk, lk))
        masks = dict(causal=m.get("causal", False))
        if "bias_bh" in m:
            masks["bias"] = (0.5 * rnd(*m["bias_bh"], lq, lk)).to(bf16)
        if "ids" in m:
            masks["segment_ids"] = (cs.k1_segment_ids(m["ids"], b, lq),) * 2
        call = lambda: fa.flash_attention_cuda(q, k, v, m.get("scale"),
                                               **masks)
        key = f"K1 {name} {(b, h, lq, lk, d)}"
        out[key + " wall ms"] = cs.cuda_ms(call)
        out[key + " device ms"] = cs.kernel_device_ms(call, K1)
        del q, k, v, masks
    torch.cuda.empty_cache()
    _other_kernels(cs, out, rnd)


def _timed(cs, out, key, family, call):
    """Wall ms (``cuda_ms``) and device ms (profiler rows of ``family``) per
    call."""
    out[key + " wall ms"] = cs.cuda_ms(call, 10, 2)
    out[key + " device ms"] = cs.kernel_device_ms(call, family)


def _other_kernels(cs, out, rnd):
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as gn

    bf16 = torch.bfloat16
    cases = [("none", s, {}) for s in cs.K1_SHAPES if s[-1] == 128]
    # K3 and K4 above head dim 128
    cases += [("none", s, {}) for s in cs.HEAD_DIM_TIMED if s[-1] > 128]
    cases += [f for f in cs.K1_FORMS if f[1] in ((16, 12, 576, 576, 64),
                                                  (16, 12, 584, 584, 64))]
    for name, (b, h, lq, lk, d), m in cases:
        q, g = (rnd(b, h, lq, d).to(bf16) for _ in range(2))
        k, v = (rnd(b, h, lk, d).to(bf16) for _ in range(2))
        causal = m.get("causal", False)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=causal)
        delta = (g.float() * o.float()).sum(-1)
        key = f"{name} {(b, h, lq, lk, d)}"
        _timed(cs, out, "K3 " + key, "K3 flash bwd dq",
               lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, g, lse, delta,
                                                      causal=causal))
        _timed(cs, out, "K4 " + key, "K4 flash bwd dk/dv",
               lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, g, lse, delta,
                                                       causal=causal))
        del q, g, k, v, o
    for shape, act, dt in cs.GN_CASES:
        x = rnd(*shape).to(bf16 if dt == "bf16" else torch.float32)
        w, bb = 1.0 + 0.1 * rnd(shape[-1]), 0.1 * rnd(shape[-1])
        _timed(cs, out, f"K2 {shape} {act} {dt}", "K2 group norm",
               lambda: gn.group_norm_cuda(x, 32, w, bb, 1e-5, act))
        del x
    # K2's host path: the wrapper, 2000 calls back to back on the host clock
    x = rnd(2, 64, 64, 320).to(bf16)
    w, bb = 1.0 + 0.1 * rnd(320), 0.1 * rnd(320)
    for _ in range(50):
        gn.group_norm_cuda(x, 32, w, bb, 1e-5, "silu")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2000):
        gn.group_norm_cuda(x, 32, w, bb, 1e-5, "silu")
    torch.cuda.synchronize()
    out["K2 launch path (2,64,64,320) silu: wrapper us"] = (
        time.perf_counter() - t) * 1e6 / 2000
    # the joint attention of SD3 / the MMDiT: q, k, v slices of the fused
    # (B, L, 3, H, D) projections of the 154 context and 4096 x tokens
    b, h, d = 2, 24, 64
    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    fused = {n: rnd(b, n, 3 * h * d).to(bf16).reshape(b, n, 3, h, d)
             for n in (154, 4096)}
    pick = lambda n, i: fused[n][:, :, i].transpose(1, 2)
    stats = {}
    for n in (154, 4096):    # the merged lse and delta of each query stream
        q = pick(n, 0)
        g = rnd(b, n, h * d).to(bf16).reshape(b, n, h, d).transpose(1, 2)
        parts = [fa.flash_attention_pos_cuda(q, pick(m, 1), pick(m, 2), z, z)
                 for m in (154, 4096)]
        o, lse = fa.merge_attention_partials(*parts[0], *parts[1])
        stats[n] = (g, lse.contiguous(), (g.float() * o.float()).sum(-1))
    for lq, lk in cs.SD3_JOINT_SHAPES:
        q, k, v = pick(lq, 0), pick(lk, 1), pick(lk, 2)
        g, lse, delta = stats[lq]
        key = f"{(b, h, lq, lk, d)}"
        for st in ("online", "bounded"):
            _timed(cs, out, f"K5 {key} {st}", "K5 flash fwd pos",
                   lambda: fa.flash_attention_pos_cuda(q, k, v, z, z,
                                                       stability=st))
        _timed(cs, out, "K6 " + key, "K6 flash bwd pos dq",
               lambda: fa.flash_bwd_pos_dq_cuda(q, k, v, g, lse, delta, z, z))
        _timed(cs, out, "K7 " + key, "K7 flash bwd pos dk/dv",
               lambda: fa.flash_bwd_pos_dkv_cuda(q, k, v, g, lse, delta, z,
                                                 z))
    del fused, stats
    torch.cuda.empty_cache()


def _wide(cs, out):
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2900)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        fam = cs.WIDE_POS_FAMS[dt][1]    # the wide backward kernel's rows
        n, w = (10, 2) if dt == "bf16" else (3, 1)

        def timed(key, call):
            out[f"{key} {dt} wall ms"] = cs.cuda_ms(call, n, w)
            out[f"{key} {dt} device ms"] = cs.kernel_device_ms(call, fam, n)

        for shape, causal in ((cs.WIDE_VAE_SHAPE, False),
                              (cs.WIDE_MASKED, True)):
            b, h, lq, lk, d = shape
            q, k, v, g, _ = cs.head_dim_inputs(rnd, dtype, d,
                                               cs.MASK_FORMS[0],
                                               (b, h, lq, lk))
            o, lse = fa.flash_attention_cuda(q, k, v, causal=causal)
            delta = (g.float() * o.float()).sum(-1)
            key = f"{'causal ' if causal else ''}{shape}"
            timed("K3 " + key, lambda: fa.flash_attention_bwd_dq_cuda(
                q, k, v, g, lse, delta, causal=causal))
            timed("K4 " + key, lambda: fa.flash_attention_bwd_dkv_cuda(
                q, k, v, g, lse, delta, causal=causal))
            del q, k, v, g, o, lse, delta
        for d in cs.WIDE_JOINT_DIMS:
            xs, gs = cs._joint_inputs(rnd, dtype, d)
            jc = cs.joint_calls(fa, xs[:3], xs[3:], dict(c=gs[0], x=gs[1]),
                                z)
            key = f"joint attention, heads of {d}, four stream pairs"
            timed("K6 " + key, jc["dq"])
            timed("K7 " + key, jc["dkv"])
            del xs, gs, jc
        torch.cuda.empty_cache()
    # the ring hop at d 512: the first query shard against the last key
    # shard at their global offsets, under the ring's valid length
    b, h, l, d = cs.WIDE_RING_SHAPE
    n_l = l // cs.RING_N
    q, k, v, g = (rnd(b, h, n_l, d).to(torch.bfloat16) for _ in range(4))
    qo = torch.zeros(2, dtype=torch.int32, device="cuda")
    ko = torch.tensor((3 * n_l, 0), dtype=torch.int32, device="cuda")
    kw = dict(seg_q=n_l, seg_k=n_l, valid_len=cs.RING_VALID)
    o, lse = fa.flash_attention_pos_cuda(q, k, v, qo, ko, **kw)
    delta = (g.float() * o.float()).sum(-1)
    fam = cs.WIDE_POS_FAMS["bf16"][1]
    key = f"ring hop {(b, h, n_l, n_l, d)}"
    for name, fn in (("K6", fa.flash_bwd_pos_dq_cuda),
                     ("K7", fa.flash_bwd_pos_dkv_cuda)):
        call = lambda: fn(q, k, v, g, lse, delta, qo, ko, **kw)
        out[f"{name} {key} bf16 wall ms"] = cs.cuda_ms(call, 20, 3)
        out[f"{name} {key} bf16 device ms"] = cs.kernel_device_ms(call, fam)
    del q, k, v, g, o, lse, delta
    torch.cuda.empty_cache()


def _fp32_timed(cs, out, key, call, family=None):
    """Wall ms and an fp32 flash call's device ms per call (its flash
    kernels, the forward's or those of ``family``, and its split pre-pass
    together, and the pre-pass alone)."""
    out[key + " wall ms"] = cs.cuda_ms(call, 5, 1)
    dev = cs.fp32_fwd_device_ms(call, family=family or cs.F32_FWD)
    fwd, split = dev["device_ms"], dev["split_device_ms"]
    out[key + " device ms"] = None if fwd is None else fwd + (split or 0.0)
    out[key + " split pre-pass device ms"] = split


def _fp32(cs, out):
    import gc

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SD1Generator, SD1Models)

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    dq_fam, dkv_fam = "K3 flash bwd dq", "K4 flash bwd dk/dv"
    for (b, h, lq, lk, d), causal, with_bwd in (
            *cs.FP32_CASES, *cs.FP32_WIDE_CASES):
        q, k, v = (t.reshape(b, lq, h, d).transpose(1, 2)
                   for t in rnd(b, lq, 3 * h * d).chunk(3, -1))
        key = f"{'causal' if causal else 'none'} {(b, h, lq, lk, d)}"
        _fp32_timed(cs, out, "K1 fp32 " + key,
                    lambda: fa.flash_attention_cuda(q, k, v, causal=causal))
        if with_bwd:   # K3 and K4 on fp32 tensors (the dq kernel's family)
            g = rnd(b, h, lq, d)
            o, lse = fa.flash_attention_cuda(q, k, v, causal=causal)
            delta = (g * o).sum(-1)
            _fp32_timed(cs, out, "K3 fp32 " + key,
                        lambda: fa.flash_attention_bwd_dq_cuda(
                            q, k, v, g, lse, delta, causal=causal), dq_fam)
            _fp32_timed(cs, out, "K4 fp32 " + key,
                        lambda: fa.flash_attention_bwd_dkv_cuda(
                            q, k, v, g, lse, delta, causal=causal), dkv_fam)
            del g, o, lse, delta
        del q, k, v
        torch.cuda.empty_cache()
    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    for b, h, lq, lk, d in FP32_POS_SHAPES:
        q = rnd(b, lq, h * d).reshape(b, lq, h, d).transpose(1, 2)
        k, v = (t.reshape(b, lk, h, d).transpose(1, 2)
                for t in rnd(b, lk, 2 * h * d).chunk(2, -1))
        for st in ("online", "bounded"):
            _fp32_timed(cs, out, f"K5 fp32 {st} {(b, h, lq, lk, d)}",
                        lambda: fa.flash_attention_pos_cuda(q, k, v, z, z,
                                                            stability=st))
        # K6 and K7 on fp32 tensors under this block's own lse
        g = rnd(b, h, lq, d)
        o, lse = fa.flash_attention_pos_cuda(q, k, v, z, z)
        delta = (g * o).sum(-1)
        _fp32_timed(cs, out, f"K6 fp32 {(b, h, lq, lk, d)}",
                    lambda: fa.flash_bwd_pos_dq_cuda(q, k, v, g, lse, delta,
                                                     z, z), dq_fam)
        _fp32_timed(cs, out, f"K7 fp32 {(b, h, lq, lk, d)}",
                    lambda: fa.flash_bwd_pos_dkv_cuda(q, k, v, g, lse, delta,
                                                      z, z), dkv_fam)
        del q, k, v, g, o, lse, delta
    models = SD1Models.initialize(torch.Generator(device="cuda").manual_seed(
        0), "cuda", "fp32")
    sd = SD1Generator(models, sampler="k_lms", n_inference_steps=10,
                      cfg_scale=7.5, height=512, width=512)
    prompt = ["a lighthouse at dusk"]

    def request(seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sd(prompt, seed=seed)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    request(1)
    out["fp32 SD1 10 steps s/request"] = request(2)
    busy, fwd, split = cs.fp32_fwd_share(lambda: sd(prompt, seed=3))
    out["fp32 SD1 10 steps device busy ms"] = busy
    out["fp32 SD1 10 steps K1 fp32 device ms"] = fwd
    out["fp32 SD1 10 steps split pre-pass device ms"] = split
    del sd, models
    gc.collect()
    torch.cuda.empty_cache()


def _fp32_bias(cs, out):
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(25)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    b, h, lq, lk, d = shape = cs.FP32_T5_SHAPE
    q, k, v = (rnd(b, h, n, d) for n in (lq, lk, lk))
    bias = 3.0 * rnd(1, h, lq, lk)
    _fp32_timed(cs, out, f"K1 fp32 bias {shape}",
                lambda: fa.flash_attention_cuda(q, k, v, scale=1.0,
                                                bias=bias))
    del q, k, v, bias
    torch.cuda.empty_cache()


def _sd1(cs, out):
    import gc

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SD1Generator, SD1Models)

    models = SD1Models.initialize(torch.Generator(device="cuda").manual_seed(
        0), "cuda", "bf16")
    sd = SD1Generator(models, sampler="k_lms", n_inference_steps=50,
                      cfg_scale=7.5, height=512, width=512)
    prompts = ["a photograph of an astronaut riding a horse"] * 4

    def request(n, seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sd(prompts[:n], seed=seed)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    request(1, 1)
    out["SD1 bs=1 s/request"] = request(1, 2)
    out["SD1 bs=4 s/request"] = request(4, 3)
    out["SD1 bs=1 device busy ms"] = sum(cs.device_families(
        lambda: sd(prompts[:1], seed=4)).values())
    del sd, models
    gc.collect()
    torch.cuda.empty_cache()


def _sd3_bundle(cs, out, parts):
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer, SD3Models)

    models = SD3Models.initialize(torch.Generator(device="cuda").manual_seed(
        0), "cuda", "bf16", depth=24, pos_embed_max_size=192)
    if "t5" in parts:
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, models.t5.config.vocab_size, (2, 512))).cuda()
        with torch.no_grad():
            call = lambda: models.t5(tokens)
            out["T5 (2, 512) ms/call"] = cs.cuda_ms(call)
            fams = cs.device_families(call, K1)
            out["T5 (2, 512) device busy ms"] = sum(fams.values())
            out["T5 (2, 512) K1 device ms"] = fams.get(K1)
    if "sd3" not in parts:
        return
    inf = SD3Inferencer(models, shift=3.0)
    zero = np.zeros((1, 77), np.int32)

    def sd3(seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        inf.gen_image(zero, width=1024, height=1024, steps=50, cfg_scale=5.0,
                      seed=seed)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    sd3(1)
    out["SD3 s/request"] = sd3(2)
    fams = cs.device_families(lambda: sd3(3))
    busy = sum(fams.values())
    out["SD3 device busy ms"] = busy
    out["SD3 K5 device ms"] = fams.get("K5 flash fwd pos")
    out["SD3 idle share"] = 1.0 - busy / (1e3 * out["SD3 s/request"])


def measure(parts):
    # the package of the checkout this process runs in, not of this file's
    sys.path[:] = [os.getcwd()] + [p for p in sys.path
                                   if os.path.abspath(p or ".") != HERE]
    import gc

    import torch

    import from_ddpm_to_stable_diffusion_tpu_torch as pkg
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build

    cs = _chip_smoke()
    card = cs.phase_device()
    out = {"card": card, "package": os.path.dirname(pkg.__file__)}
    _build.load()
    out["nvcc s"] = _build.builds["kernels"][0]
    if "launch" in parts:
        for what, us in cs.k1_launch_path(card, "fresh process").items():
            for unit, x in zip(("wrapper", "C entry", "kernel"), us):
                out[f"K1 launch path, {what}: {unit} us"] = x
    if "kernels" in parts:
        _kernels(cs, out)
    if "training" in parts:
        trainer, state, _, step = cs.phase_training(card)
        for key, x in step.items():
            out[f"tiny-SD step {key}"] = x
        t = time.perf_counter()
        cs.phase_sampling(card, trainer, state)
        out["tiny-SD sampling T=250 s"] = time.perf_counter() - t
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    if "widths" in parts:
        runs, fp32_runs = cs.phase_tiny_sd_widths(card)
        for channel, (fp32_counts, _) in fp32_runs.items():
            c = runs[f"tiny_sd_w{channel}"]
            key = f"tiny-SD channel {channel}"
            out[key + " bf16 step ms"] = c.step_ms
            out[key + " bf16 step device busy ms"] = c.busy_ms
            out[key + " bf16 idle share"] = 1.0 - c.busy_ms / c.step_ms
            out[key + " fp32 step ms"] = fp32_counts.step_ms
        del runs, fp32_runs
        gc.collect()
        torch.cuda.empty_cache()
    if "vlm" in parts:
        trainer, state, _, step = cs.phase_vlm_training(card)
        for key, x in step.items():
            out[f"TinyVLM step {key}"] = x
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    if "mmdit" in parts:
        trainer, state, _, step = cs.phase_mmdit_training(card)
        for key, x in step.items():
            out[f"MMDiT step {key}"] = x
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    if "sd1" in parts:
        _sd1(cs, out)
    if "t5" in parts or "sd3" in parts:
        _sd3_bundle(cs, out, parts)
    if "fp32" in parts:
        _fp32(cs, out)
    if "fp32bias" in parts:
        _fp32_bias(cs, out)
    if "wide" in parts:
        _wide(cs, out)
    if "fp32train" in parts:
        for name, (counts, _) in zip(
                ("TinyVLM", "tiny-SD", "MMDiT latent 128 batch 1",
                 "MMDiT latent 64 batch 2"), cs.phase_train_fp32(card)):
            out[f"fp32 {name} step ms"] = counts.step_ms
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--measure"]:
        measure(argv[1].split(","))
        return
    only = ",".join(PARTS)
    if "--only" in argv:
        i = argv.index("--only")
        only, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    if len(argv) != 2 or not set(only.split(",")) <= set(PARTS):
        sys.exit(__doc__)
    dirs = dict(A=os.path.abspath(argv[0]), B=os.path.abspath(argv[1]))
    runs = []
    for label in "ABBA":
        env = dict(os.environ, PYTHONPATH=dirs[label])
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure", only],
            cwd=dirs[label], env=env, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f"{label}| {line}", flush=True)
        if proc.returncode or not lines:
            sys.exit(f"run {label} in {dirs[label]} failed:\n"
                     f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        runs.append((label, json.loads(lines[-1])))
    keys = [k for k in runs[0][1] if k not in ("card", "package")]
    keys.sort(key=lambda k: "device" not in k)   # device times first
    print(f"A = {dirs['A']}, B = {dirs['B']}; runs in the order A B B A on "
          f"{runs[0][1]['card']}")
    fmt = lambda xs: " / ".join("-" if x is None else f"{x:.4f}" for x in xs)
    for key in keys:
        a = [r.get(key) for lab, r in runs if lab == "A"]
        b = [r.get(key) for lab, r in runs if lab == "B"]
        print(f"  {key}: A {fmt(a)}  B {fmt(b)}")


if __name__ == "__main__":
    main(sys.argv[1:])
