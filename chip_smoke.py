#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure makes the script exit non-zero without the
final line:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (nvidia-smi) and the TF32 switches, which it turns off.
2. build: builds the CUDA kernels from ``csrc/`` (nvcc) and prints the time.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the SD1 path gives it, in bf16 (and GroupNorm in fp32), with
   max errors and both times.
4. main path: full-width SD1 (CLIP, 860M UNet, VAE decoder) with random
   weights from a seed, ``SD1Generator`` at 512x512, 50 k-LMS steps, CFG 7.5:
   two batch-1 requests, then one batch-4 request. Checks the images, the
   final latents, and the kernel launch counts of every request.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
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
TPU_KERNELS = "from_ddpm_to_stable_diffusion_tpu/ops/"


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
                  (1, 1, 4096, 4096, 512), (1, 2, 1000, 777, 80)]
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
        if k1["ms"] is None:          # report the 64^2 UNet shape
            k1["ms"], k1["plain_ms"] = ms, plain_ms
    results["K1"] = k1

    fp32 = torch.float32
    gn_cases = [((2, 64, 64, 320), "silu", bf16),
                ((2, 32, 32, 640), "silu", bf16),
                ((2, 8, 8, 1280), "silu", bf16),
                ((8, 64, 64, 320), "silu", bf16),
                ((1, 512, 512, 128), None, bf16),
                ((1, 512, 512, 128), None, fp32)]
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
    return results


def phase_main_path(card):
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as gn
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

    fa.flash_attention_cuda.launches = 0
    gn.group_norm_cuda.launches = 0
    for prompt_batch, seed in requests:
        b = len(prompt_batch)
        k1_0 = fa.flash_attention_cuda.launches
        k2_0 = gn.group_norm_cuda.launches
        step_events.clear()
        final_latents.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        images = sd(prompt_batch, seed=seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        k1 = fa.flash_attention_cuda.launches - k1_0
        k2 = gn.group_norm_cuda.launches - k2_0
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
    launches = dict(K1=fa.flash_attention_cuda.launches,
                    K2=gn.group_norm_cuda.launches)
    for h in hooks:
        h.remove()
    return launches


def main():
    card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    launches = phase_main_path(card)
    pkg = "from_ddpm_to_stable_diffusion_tpu_torch/csrc/"
    summary = {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": pkg + "flash_attention.cu",
         "replaces": TPU_KERNELS + "flash_attention.py:242",
         "also_replaces": [TPU_KERNELS + "flash_attention.py:119"],
         "launches": launches["K1"], "max_abs_err": kernels["K1"]["err"],
         "ms": kernels["K1"]["ms"], "plain_ms": kernels["K1"]["plain_ms"]},
        {"name": "group_norm_silu", "route": "cuda",
         "source": pkg + "groupnorm.cu",
         "replaces": TPU_KERNELS + "groupnorm_pallas.py:29",
         "launches": launches["K2"], "max_abs_err": kernels["K2"]["err"],
         "ms": kernels["K2"]["ms"], "plain_ms": kernels["K2"]["plain_ms"]},
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
