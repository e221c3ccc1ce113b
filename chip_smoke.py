#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure makes the script exit non-zero without the
two summary lines:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (nvidia-smi) and the TF32 switches, which it turns off.
2. build: builds the CUDA kernels from ``csrc/`` (nvcc) and prints the time
   and ptxas's register, spill and shared-memory lines.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the SD1 and tiny-SD paths give it, in bf16 (and GroupNorm in
   fp32), with max errors and both times: K1 flash forward, K2 GroupNorm,
   K3 / K4 flash backward (dq; dk and dv), and the GroupNorm backward.
4. SD1: full-width SD1 (CLIP, 860M UNet, VAE decoder) with random weights
   from a seed, ``SD1Generator`` at 512x512, 50 k-LMS steps, CFG 7.5: two
   batch-1 requests, then one batch-4 request. Checks the images, the final
   latents, and the kernel launch counts of every request.
5. training: the tiny-SD ``DDPMTrainer`` at ``TinySDConfig()`` defaults
   (64x64, batch 32, base 128 x [1,2,2,2], 3 classes, dropout 0.1, bf16
   over fp32 parameters, AdamW, clip 1.0, warmup-cosine LR) on
   ``SyntheticImageDataset``: warm-up steps, timed steps (CUDA events),
   profiled steps (device time by kernel family, device idle share).
   Checks finite losses and gradients, moved parameters, and the launches
   of K1, K3, K4 and K2 per step.
6. gradient check: loss and gradient of one batch of 4 on the card (bf16,
   kernels) against the same weights and inputs on the CPU (fp32, plain
   versions), dropout off, as relative L2 errors of the whole flattened
   gradient and of each self-attention leaf of the six flash blocks; then
   the same check on two planted faults of the flash backward (dk and dv
   swapped; dq without its scale), which it must catch.
7. sampling: ``trainer.sample`` of 4 labels, CFG as one batch-8 forward,
   T = 1000; checks the images and the launches.

Every kernel's launch count is set to 0 just before each of the SD1,
training and sampling phases and read just after. The last two lines are a
JSON summary of the kernels and ``{"ok": true, "device": {...}}``; the
card's name and power limit come on the line before them. Imports nothing
of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

FAILURES = []
# Launches per request, at any batch (CFG and the batch ride in one forward):
# 10 long self-attentions per UNet forward (5 at 64^2, 5 at 32^2) x 50 steps
# + the VAE decoder's mid attention; 61 GroupNorms per UNet forward x 50
# + 30 in the VAE decoder.
K1_PER_REQUEST = 10 * 50 + 1
K2_PER_REQUEST = 61 * 50 + 30
# Tiny-SD UNet forward: 6 self-attentions of >= 512 tokens (enc1, dec6,
# dec7 at 64^2; enc3, dec4, dec5 at 32^2) take K1, and their backward K3
# and K4; 39 GroupNorms (28 in 14 ResBlocks, 10 TransformerBlock norm_in,
# the tail). The GroupNorm backward is plain PyTorch, so no K2 there.
TRAIN_PER_STEP = dict(K1=6, K3=6, K4=6, K2=39)
SAMPLE_T = 1000
TPU_KERNELS = "from_ddpm_to_stable_diffusion_tpu/ops/"
# Relative L2 error of the flattened gradient, card (bf16 compute, kernels)
# against CPU (fp32, plain versions). bf16 keeps 8 significant bits, so
# every rounded activation, weight and probability carries up to 2^-9
# relative error; through the ~100 rounded layers of forward and backward
# these add up to about 1e-2 of the gradient's norm. 5e-2 leaves room for
# that and fails on any real fault (a wrong kernel is off by O(1)). The same
# bound holds for each self-attention leaf of the six flash blocks, where a
# fault of K3 or K4 lands first; two planted faults show that it bites.
GRAD_REL_TOL = 5e-2


def check(ok: bool, what: str) -> None:
    if not ok:
        FAILURES.append(what)
        print(f"FAIL: {what}", flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    return card


def phase_build():
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    nvcc = _build.build_seconds
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{'cached' if nvcc is None else f'{nvcc:.2f} s'}) -> "
          f"{_build.library_path().name}", flush=True)
    for line in _build.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip().removeprefix("ptxas info    :"))


def kernel_counters():
    """name -> the function object whose ``launches`` counts the kernel."""
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as gn

    return dict(K1=fa.flash_attention_cuda, K2=gn.group_norm_cuda,
                K3=fa.flash_attention_bwd_dq_cuda,
                K4=fa.flash_attention_bwd_dkv_cuda)


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in kernel_counters().items()}


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _close(a, b, rtol, atol):
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def phase_kernels(card):
    """Each kernel against its plain version at the path's shapes."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf16 = torch.bfloat16
    results = {}

    # K1: q, k, v are column slices of one fused projection, as on the path.
    attn_cases = [(2, 8, 4096, 4096, 40), (2, 8, 1024, 1024, 80),
                  (1, 1, 4096, 4096, 512), (1, 2, 1000, 777, 80),
                  (32, 1, 4096, 4096, 128), (32, 2, 1024, 1024, 128),
                  (1, 2, 1000, 777, 128)]
    k1 = dict(err=0.0, ms=None, plain_ms=None)
    for b, h, lq, lk, d in attn_cases:
        split = lambda x, n: [t.reshape(b, n, h, d).transpose(1, 2)
                              for t in x.chunk(x.shape[-1] // (h * d), -1)]
        q = split(rnd(b, lq, h * d).to(bf16), lq)[0]
        k, v = split(rnd(b, lk, 2 * h * d).to(bf16), lk)
        out, lse = fa.flash_attention_cuda(q, k, v)
        ref, ref_lse = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 5, 1)
        print(f"K1 flash fwd (B,H,Lq,Lk,D)=({b},{h},{lq},{lk},{d}) bf16: "
              f"max|out err|={err:.3e} (atol 2e-2) max|lse err|="
              f"{lse_err:.3e} (atol 1e-3); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms [{card}]", flush=True)
        check(err <= 2e-2 and lse_err <= 1e-3,
              f"K1 disagrees at {(b, h, lq, lk, d)}: {err} / {lse_err}")
        k1["err"] = max(k1["err"], err)
        if k1["ms"] is None:          # report the SD1 64^2 UNet shape
            k1["ms"], k1["plain_ms"] = ms, plain_ms
        if d == 128:
            bwd_errs = phase_kernels_bwd(card, q, k, v, out, lse, gen)
            for name, e in bwd_errs.items():
                results.setdefault(name, dict(err=0.0, ms=None,
                                              plain_ms=None))
                r = results[name]
                r["err"] = max(r["err"], e["err"])
                if r["ms"] is None:   # report the tiny-SD 64^2 shape
                    r["ms"], r["plain_ms"] = e["ms"], e["plain_ms"]
    results["K1"] = k1

    fp32 = torch.float32
    gn_cases = [((2, 64, 64, 320), "silu", bf16),
                ((2, 32, 32, 640), "silu", bf16),
                ((2, 8, 8, 1280), "silu", bf16),
                ((8, 64, 64, 320), "silu", bf16),
                ((1, 512, 512, 128), None, bf16),
                ((1, 512, 512, 128), None, fp32),
                ((32, 64, 64, 128), "silu", bf16)]
    k2 = dict(err=0.0, ms=None, plain_ms=None)
    for shape, act, dtype in gn_cases:
        c = shape[-1]
        x = (rnd(*shape) * 2.0 + 0.5).to(dtype)
        scale = 1.0 + 0.1 * rnd(c)
        bias = 0.1 * rnd(c)
        y = gn.group_norm_cuda(x, 32, scale, bias, 1e-5, act)
        if dtype == fp32:
            ref = gn.group_norm_plain(x, 32, scale, bias, 1e-5, act)
            rtol, atol, plain = 0.0, 1e-4, gn.group_norm_plain
        else:
            ref = gn.group_norm_plain_one_pass(x, 32, scale, bias, 1e-5, act)
            rtol, atol, plain = 1.6e-2, 1.6e-2, gn.group_norm_plain_one_pass
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        ms = cuda_ms(lambda: gn.group_norm_cuda(x, 32, scale, bias, 1e-5, act))
        plain_ms = cuda_ms(lambda: plain(x, 32, scale, bias, 1e-5, act), 5, 1)
        name = "fp32 two-pass" if dtype == fp32 else "bf16 one-pass"
        print(f"K2 group norm {shape} act={act} {dtype} vs plain {name}: "
              f"max|err|={err:.3e} (rtol {rtol}, atol {atol}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]", flush=True)
        check(_close(y, ref, rtol, atol), f"K2 disagrees at {shape} {dtype}")
        if dtype == bf16:
            k2["err"] = max(k2["err"], err)
        if k2["ms"] is None:          # report the 64^2 UNet shape
            k2["ms"], k2["plain_ms"] = ms, plain_ms
    results["K2"] = k2

    # The GroupNorm backward (a plain port of the JAX _fused_bwd, no
    # kernel) at the tiny-SD 64^2 shape, as the trainer runs it.
    x = (rnd(32, 64, 64, 128) * 2.0 + 0.5).to(bf16)
    scale, bias, dy = 1.0 + 0.1 * rnd(128), 0.1 * rnd(128), rnd(
        32, 64, 64, 128).to(bf16)
    ms = cuda_ms(lambda: gn.group_norm_bwd_plain(x, scale, bias, dy, 32,
                                                 1e-5, "silu"), 10, 2)
    print(f"GroupNorm backward (plain, autograd Function) (32,64,64,128) "
          f"act=silu bf16: {ms:.4f} ms [{card}]", flush=True)
    return results


def phase_kernels_bwd(card, q, k, v, out, lse, gen):
    """K3 and K4 against the plain backward on K1's inputs and outputs."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    b, h, lq, d = q.shape
    # dO as the out-projection's gradient arrives: a view of (B, Lq, H*D)
    g = torch.randn((b, lq, h * d), generator=gen, device="cuda").to(
        q.dtype).reshape(b, lq, h, d).transpose(1, 2)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    errs, line = {}, []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = (a.float() - w.float()).abs().max().item()
        ref = w.float().abs().max().item()
        # five bf16 ulps of the largest gradient (see the cuda tests)
        check(err <= 2e-2 * ref, f"{name} disagrees at {tuple(q.shape)}, "
              f"Lk={k.shape[2]}: {err} > 2e-2 * {ref}")
        errs[name] = err
        line.append(f"max|{name} err|={err:.3e} (max|{name}|={ref:.3e}, "
                    f"tol 2e-2 of it)")
    delta = (g.float() * out.float()).sum(-1)
    ms3 = cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, g, lse,
                                                         delta), 10, 2)
    ms4 = cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, g, lse,
                                                          delta), 10, 2)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse,
                                                            g), 3, 1)
    print(f"K3/K4 flash bwd (B,H,Lq,Lk,D)=({b},{h},{lq},{k.shape[2]},{d}) "
          f"bf16: {'; '.join(line)}; K3 {ms3:.4f} ms, K4 {ms4:.4f} ms, "
          f"plain dq+dk+dv {plain_ms:.4f} ms [{card}]", flush=True)
    return dict(K3=dict(err=errs["dq"], ms=ms3, plain_ms=plain_ms),
                K4=dict(err=max(errs["dk"], errs["dv"]), ms=ms4,
                        plain_ms=plain_ms))


def phase_sd1(card):
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SD1Generator, SD1Models)

    t0 = time.perf_counter()
    seed = torch.Generator(device="cuda").manual_seed(0)
    models = SD1Models.initialize(seed, "cuda", "bf16")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (models.clip, models.unet,
                                       models.decoder) for p in m.parameters())
    print(f"main path: random-init SD1 bundle, {n_params} params, bf16, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    sd = SD1Generator(models, sampler="k_lms", n_inference_steps=50,
                      cfg_scale=7.5, height=512, width=512)

    step_events, final_latents = [], []

    def on_unet(module, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        step_events.append(ev)

    def on_decoder(module, args):
        final_latents.append(args[0].detach().clone())

    hooks = [models.unet.register_forward_pre_hook(on_unet),
             models.decoder.register_forward_pre_hook(on_decoder)]
    prompts = ["a photograph of an astronaut riding a horse",
               "a watercolor fox in the snow", "a lighthouse at dusk",
               "a bowl of ramen, studio lighting"]
    requests = [(prompts[:1], 1), (prompts[1:2], 2), (prompts, 3)]

    reset_counts()
    for prompt_batch, seed in requests:
        b = len(prompt_batch)
        n0 = read_counts()
        step_events.clear()
        final_latents.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        images = sd(prompt_batch, seed=seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        n1 = read_counts()
        k1, k2 = n1["K1"] - n0["K1"], n1["K2"] - n0["K2"]
        step_ms = (step_events[0].elapsed_time(step_events[-1])
                   / (len(step_events) - 1))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"request bs={b} seed={seed}: {secs:.3f} s, {secs / b:.3f} "
              f"s/image, {step_ms:.2f} ms/denoise step (UNet batch {2 * b}),"
              f" peak {peak:.2f} GiB, K1 launches {k1}, K2 launches {k2} "
              f"[{card}]", flush=True)
        check(images.shape == (b, 512, 512, 3) and str(images.dtype) ==
              "uint8", f"image shape/dtype {images.shape} {images.dtype}")
        check(float(images.std()) > 0.0, "constant image")
        check(len(final_latents) == 1 and final_latents[0].shape
              == (b, 64, 64, 4) and bool(torch.isfinite(final_latents[0]).all()),
              "final latents not finite or misshaped")
        check(len(step_events) == 50, f"{len(step_events)} UNet calls, not 50")
        check(k1 == K1_PER_REQUEST, f"K1 launches {k1} != {K1_PER_REQUEST}")
        check(k2 == K2_PER_REQUEST, f"K2 launches {k2} != {K2_PER_REQUEST}")
    launches = read_counts()
    for h in hooks:
        h.remove()
    return launches


def _family(name: str) -> str:
    """Kernel family of a CUDA kernel name, for the training profile."""
    n = name.lower()
    for key, fam in (("flash_fwd", "K1 flash fwd"),
                     ("flash_bwd_dq", "K3 flash bwd dq"),
                     ("flash_bwd_dkv", "K4 flash bwd dk/dv"),
                     ("gn_", "K2 group norm"),
                     ("multi_tensor", "optimizer (foreach)"),
                     ("layer_norm", "layer norm"), ("softmax", "softmax"),
                     ("reduce", "reductions"),
                     ("conv", "cuDNN convolutions"),
                     ("fprop", "cuDNN convolutions"),
                     ("dgrad", "cuDNN convolutions"),
                     ("wgrad", "cuDNN convolutions"),
                     ("gemm", "GEMMs"), ("cutlass", "GEMMs"),
                     ("xmma", "GEMMs"), ("copy", "copies / casts"),
                     ("cat", "copies / casts"),
                     ("elementwise", "elementwise")):
        if key in n:
            return fam
    return "other"


def profile_steps(trainer, state, batches, card):
    """Device time by kernel family over a few profiled steps; returns the
    state and the device busy time per step (sum of kernel time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for images, labels in batches:
            state, _ = trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, n_kernels, top = {}, 0, []
    for e in prof.key_averages():
        # kernel rows only: user annotations (Optimizer.step#...) also get a
        # device-side range, which would count their kernels twice
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        fam = _family(e.key)
        fams[fam] = fams.get(fam, 0.0) + us / 1e3
        n_kernels += e.count
        top.append((us / 1e3, e.count, e.key[:90]))
    busy = sum(fams.values())
    n = len(batches)
    print(f"training profile over {n} steps (torch.profiler, kernel rows "
          f"only): device busy {busy / n:.2f} ms/step, {n_kernels // n} "
          f"kernels/step; wall under the profiler {wall_ms / n:.2f} ms/step "
          f"[{card}]", flush=True)
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:24s} {ms / n:9.3f} ms/step {100 * ms / busy:5.1f} %")
    for ms, count, key in sorted(top, reverse=True)[:12]:
        print(f"  top: {ms / n:8.3f} ms/step x{count // n:4d}/step {key}")
    return state, busy / n


# Parameters with an exactly zero gradient in the tiny-SD UNet (the JAX
# model's too): the cross-attention attends to one label token, so its
# softmax is 1 whatever the logits, and attn2.q, attn2.k and the norm2 that
# feeds only them get no gradient. AdamW's decay of them (lr·1e-4 relative)
# rounds away in fp32, so they do not move.
DEAD_PARAMS = re.compile(r"_att\.(attn2\.[qk]|norm2)\.")
# The self-attention leaves of the six blocks whose attention takes K1, K3
# and K4 (>= 512 tokens); a fault of K3 or K4 lands first in their qkv.
FLASH_LEAVES = re.compile(r"^(enc1|enc3|dec4|dec5|dec6|dec7)_att\.attn1\.")


def phase_training(card):
    """The tiny-SD trainer at TinySDConfig() defaults on synthetic data."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        DataLoader, SyntheticImageDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        DDPMTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        TinySDConfig)

    cfg = TinySDConfig()
    warm, timed, profiled = 3, 20, 2
    n_steps = warm + timed + profiled
    t0 = time.perf_counter()
    loader = DataLoader(SyntheticImageDataset(
        cfg.batch_size * n_steps, cfg.img_size, cfg.img_channel,
        cfg.num_class, seed=cfg.seed), cfg.batch_size, seed=cfg.seed)
    batches = list(loader)
    trainer = DDPMTrainer(cfg, device="cuda")
    state = trainer.create_state(len(loader))
    before = {n: p.detach().clone() for n, p in state.params.items()}
    torch.cuda.synchronize()
    print(f"training: TinyUNet {trainer.num_params(state)} params (fp32), "
          f"batch {cfg.batch_size} at {cfg.img_size}^2, bf16 compute, "
          f"dropout {cfg.dropout}, T={cfg.T}; set-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    reset_counts()
    losses = []
    for images, labels in batches[:warm]:
        state, loss = trainer.train_step(state, images, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for images, labels in batches[warm:warm + timed]:
        state, loss = trainer.train_step(state, images, labels)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / timed
    step_ms = start.elapsed_time(end) / timed
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    state, busy = profile_steps(trainer, state, batches[warm + timed:], card)
    idle = 1.0 - busy / step_ms
    launches = read_counts()
    losses = torch.stack(losses).float().cpu()
    print(f"training: {timed} timed steps: {step_ms:.2f} ms/step (CUDA "
          f"events; host {host_ms:.2f} ms/step), "
          f"{1e3 * cfg.batch_size / step_ms:.1f} img/s, peak {peak:.2f} GiB, "
          f"device idle share {idle:.3f} (1 - busy / unprofiled step), "
          f"loss first {losses[0]:.4f} last {losses[-1]:.4f}, launches "
          f"{launches} over {n_steps} steps [{card}]", flush=True)
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses}")
    params = state.params
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in params.values()), "missing or non-finite gradient")
    dead = {n for n in params if DEAD_PARAMS.search(n)}
    still = {n for n, p in params.items() if torch.equal(before[n], p)}
    zero = {n for n, p in params.items() if not bool(p.grad.any())}
    print(f"training: {len(params) - len(still)}/{len(params)} parameter "
          f"tensors moved; {len(zero)} have a zero gradient (cross-attention "
          f"over one token: {len(dead)})", flush=True)
    check(still == dead and zero == dead,
          f"unmoved {sorted(still ^ dead)} / zero-gradient "
          f"{sorted(zero ^ dead)} differ from the dead cross-attention set")
    for name, per_step in TRAIN_PER_STEP.items():
        check(launches[name] == per_step * n_steps,
              f"{name} launches {launches[name]} != {per_step} x {n_steps}")
    return trainer, state, launches, dict(step_ms=step_ms, idle=idle,
                                          peak_gib=peak)


def phase_grad_check(card):
    """One batch of 4, dropout off: card (bf16, kernels) vs CPU (fp32), as
    the whole flattened gradient and leaf by leaf over the flash blocks;
    then two planted faults of the flash backward that the check must
    catch (dk and dv swapped; dq without its scale)."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.ops.schedules import (
        ddpm_tables)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        DDPMTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        flax_default_init_)
    from from_ddpm_to_stable_diffusion_tpu_torch.samplers.ddpm import ddpm_loss
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        TinySDConfig)

    cfg = TinySDConfig(dropout=0.0)
    card_model = flax_default_init_(
        DDPMTrainer(cfg, "cuda").make_model(),
        torch.Generator("cuda").manual_seed(7))
    cpu_model = DDPMTrainer(dataclasses.replace(cfg, dtype="fp32"),
                            "cpu").make_model()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               card_model.state_dict().items()})
    card_model = card_model.to(memory_format=torch.channels_last)
    rng = np.random.default_rng(7)
    s = cfg.img_size
    images = rng.uniform(-1, 1, (4, s, s, 3)).astype(np.float32)
    labels = np.asarray([1, 2, 3, 0])
    t = rng.integers(0, cfg.T, 4)
    noise = rng.standard_normal((4, s, s, 3)).astype(np.float32)
    tables = ddpm_tables(cfg.beta_1, cfg.beta_T, cfg.T)

    def loss_and_grads(model, dev):
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = ddpm_loss(model, tables, torch.from_numpy(images).to(dev),
                         torch.from_numpy(labels).to(dev), cfg.T,
                         t=torch.from_numpy(t), noise=noise).sum() / 16
        loss.backward()
        grads = {n: p.grad.float().flatten().cpu()
                 for n, p in model.named_parameters()}
        return loss.item(), grads, time.perf_counter() - t0

    l_cpu, g_cpu, s_cpu = loss_and_grads(cpu_model, "cpu")
    flash = [n for n in g_cpu if FLASH_LEAVES.search(n)]
    check(sum(n.endswith("qkv.weight") for n in flash) == 6,
          f"flash-block leaves {flash}")

    def errors(g_card):
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        whole = rel(torch.cat(list(g_card.values())),
                    torch.cat(list(g_cpu.values())))
        leaves = {n: rel(g_card[n], g_cpu[n]) for n in g_cpu
                  if g_cpu[n].norm() > 0}
        worst = max(leaves, key=leaves.get)
        worst_flash = max(flash, key=leaves.get)
        return whole, leaves, worst, worst_flash

    def passes(whole, leaves, loss_rel):
        return (whole <= GRAD_REL_TOL and loss_rel <= GRAD_REL_TOL
                and all(leaves[n] <= GRAD_REL_TOL for n in flash))

    l_card, g_card, s_card = loss_and_grads(card_model, "cuda")
    whole, leaves, worst, worst_flash = errors(g_card)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    print(f"gradient check (batch 4, dropout off): loss card {l_card:.6f} "
          f"cpu {l_cpu:.6f} (rel {loss_rel:.3e}); flattened gradient "
          f"({sum(g.numel() for g in g_cpu.values())} values) rel L2 err "
          f"{whole:.3e}; worst flash-block leaf ({len(flash)} attn1 leaves) "
          f"{worst_flash} {leaves[worst_flash]:.3e}; worst leaf of all "
          f"{worst} {leaves[worst]:.3e} (reported only); tol {GRAD_REL_TOL} "
          f"on the whole, the loss and each flash-block leaf; card "
          f"{s_card:.2f} s, cpu fp32 {s_cpu:.2f} s", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in g_card.values()),
          "non-finite card gradient")
    check(passes(whole, leaves, loss_rel),
          f"card gradient off the CPU's: whole {whole}, loss rel {loss_rel},"
          f" flash leaf {worst_flash} {leaves[worst_flash]}")

    # Controls: the same check must fail on a planted fault of K3 or K4.
    bwd = fa.flash_attention_bwd_cuda

    def swap_dk_dv(q, k, v, out, lse, g, scale):
        dq, dk, dv = bwd(q, k, v, out, lse, g, scale)
        return dq, dv, dk

    def unscaled_dq(q, k, v, out, lse, g, scale):
        dq, dk, dv = bwd(q, k, v, out, lse, g, scale)
        return dq / (scale or q.shape[-1] ** -0.5), dk, dv

    for fault, planted in (("dk/dv swapped", swap_dk_dv),
                           ("dq without scale", unscaled_dq)):
        fa.flash_attention_bwd_cuda = planted
        try:
            l_bad, g_bad, _ = loss_and_grads(card_model, "cuda")
        finally:
            fa.flash_attention_bwd_cuda = bwd
        whole_b, leaves_b, _, worst_b = errors(g_bad)
        caught = not passes(whole_b, leaves_b, abs(l_bad - l_cpu) / abs(l_cpu))
        print(f"gradient check control ({fault}): whole {whole_b:.3e} "
              f"({'above' if whole_b > GRAD_REL_TOL else 'within'} tol), "
              f"worst flash-block leaf {worst_b} {leaves_b[worst_b]:.3e}: "
              f"{'caught' if caught else 'MISSED'}", flush=True)
        check(caught, f"gradient check missed the planted fault: {fault}")
    return whole


def phase_sampling(card, trainer, state):
    """CFG ancestral sampling of 4 labels, one batch-8 forward per step."""
    import torch

    labels = [1, 2, 3, 1]
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    images = trainer.sample(state, labels)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = read_counts()
    s = trainer.cfg.img_size
    print(f"sampling: {len(labels)} images, T={trainer.cfg.T}, CFG "
          f"w={trainer.cfg.w} (UNet batch {2 * len(labels)}): {secs:.3f} s, "
          f"{1e3 * secs / trainer.cfg.T:.2f} ms/step, launches {launches} "
          f"[{card}]", flush=True)
    check(tuple(images.shape) == (len(labels), s, s, 3),
          f"samples {tuple(images.shape)}")
    check(bool(torch.isfinite(images).all()) and
          images.abs().max().item() <= 1.0, "samples not finite in [-1, 1]")
    check(float(images.std()) > 0.0, "constant samples")
    check(launches == dict(K1=6 * SAMPLE_T, K2=39 * SAMPLE_T, K3=0, K4=0),
          f"sampling launches {launches}")
    return launches


def main():
    card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    runs = [phase_sd1(card)]
    trainer, state, train_launches, _ = phase_training(card)
    runs.append(train_launches)
    phase_grad_check(card)
    runs.append(phase_sampling(card, trainer, state))
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    pkg = "from_ddpm_to_stable_diffusion_tpu_torch/csrc/"
    entry = lambda name, src, replaces, k, **kw: dict(
        name=name, route="cuda", source=pkg + src,
        replaces=TPU_KERNELS + replaces, **kw, launches=launches[k],
        launches_by_path=dict(zip(("sd1", "training", "sampling"),
                                  (r[k] for r in runs))),
        max_abs_err=kernels[k]["err"], ms=kernels[k]["ms"],
        plain_ms=kernels[k]["plain_ms"])
    summary = {"kernels": [
        entry("flash_attention_fwd", "flash_attention.cu",
              "flash_attention.py:242", "K1",
              also_replaces=[TPU_KERNELS + "flash_attention.py:119"]),
        entry("group_norm_silu", "groupnorm.cu", "groupnorm_pallas.py:29",
              "K2"),
        entry("flash_attention_bwd_dq", "flash_attention_bwd.cu",
              "flash_attention.py:682", "K3",
              plain_computes="dq, dk and dv together"),
        entry("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
              "flash_attention.py:764", "K4",
              plain_computes="dq, dk and dv together"),
    ]}
    print(card)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        sys.exit(1)
    import torch

    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
