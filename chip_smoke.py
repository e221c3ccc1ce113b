#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure makes the script exit non-zero without the
two summary lines:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (nvidia-smi) and the TF32 switches, which it turns off.
2. build: builds the CUDA kernels from ``csrc/`` (nvcc) into two shared
   objects, the bf16 flash kernels with GroupNorm and the fp32 flash kernels
   (``csrc/fp32/``), and prints each one's time and ptxas's register, spill
   and shared-memory lines; then counts the wgmma (HGMMA) and TMA (UTMALDG,
   UBLKCP) instructions of each K1, K3, K4, K5, K6 and K7 kernel in the bf16
   library's SASS and of each fp32 forward kernel in the fp32 library's
   (``cuobjdump -sass``) and fails unless all 19 instantiations of the sm90
   K1 (d = 160 among them) and all 4 of the sm90 K5
   (``csrc/flash_attention_sm90.cu``), the d = 512 K1
   (``csrc/flash_attention.cu``), all 16 of the sm90 K3 and 2 of the sm90 K6
   (``csrc/flash_attention_dq_sm90.cu``), all 16 of the sm90 K4 and 2 of the
   sm90 K7 (``csrc/flash_attention_bwd_sm90.cu``), all 10 of the TF32 fp32
   forward (K1 at seven head dims, K1 causal / K5 online, K5 bounded, T5's
   bias) and its d = 512 kernel (``csrc/fp32/flash_f32_fwd.cu``), and the 3
   + 3 of the TF32 fp32 backward (dq and dk/dv at 64 and 128, masked at 64:
   ``csrc/fp32/flash_f32_bwd.cu``) have both.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the SD1, tiny-SD and SD3 paths give it, in bf16 (and
   GroupNorm in fp32), with max errors, both times, the least time the card
   could take (bytes over 3.35 TB/s or operations over 989 TFLOP/s bf16,
   whichever is larger) and the time of the one PyTorch call that computes
   the same function (a yardstick only; nothing in the port calls it): K1
   flash forward (TMA / wgmma; at d = 512 also with its keys split over 1
   and 2 blocks per query tile; at d = 160, SD1 at 768^2), K2 GroupNorm
   (one cooperative launch a call, by its own device time beside its wall
   time, its kernels per call counted in a profile, bf16 and fp32, rows kept
   in shared memory or streamed), K3 / K4 flash backward (dq;
   dk and dv, both on TMA / wgmma), K5 (TMA / wgmma)
   position-masked flash forward (the four SD3 shapes, online and bounded,
   each also by its own device time from torch.profiler;
   two-segment causal / valid_len masks, a ragged key tail, head dim 128,
   fully masked rows; the joint attention over 154 + 4096 tokens against
   plain attention over the concatenated sequence), K6 / K7
   position-masked flash backward (dq; dk and dv, both on TMA / wgmma) under
   the merged lse of the joint attention (the four shapes, with device
   times; two-segment causal / valid_len
   masks, a ragged x length, head dim 128, rows masked in one partial only
   and rows masked everywhere; the joint backward as a whole against
   autograd through plain attention over the concatenated sequence), and
   the GroupNorm backward; then the causal, bias and segment-id forms of
   K1, K3 and K4 (with dbias) at head dims 64 and 128: the TinyVLM's causal
   584 tokens and its tower's 576, causal 4096 tokens at head dim 128, T5's
   biased 512 tokens, 4096 tokens packed from 8 ragged sequences (alone,
   causal, with a bias), causal Lq != Lk, rows that see no key (K1 also by
   its own device time from torch.profiler beside its wall time); each with a
   bound that counts the visible pairs only, and two planted faults (a
   causal mask off by one, a dbias tile left unwritten) that the comparison
   must catch; a packing of 64 sequences of 64 tokens beside the seeded one.
   Then K1's host path at small shapes (the wrapper and its C entry alone,
   microseconds per call, beside the kernel's own time); again beside T5;
   and K2's at the SD1 UNet's (2, 64, 64, 320) + SiLU the same way.
   Then the fp32 form of K1 and K3 - K7 against the plain fp32 versions (TF32
   off) at the shapes the fp32 defaults give them (and K1 at d = 160 and
   with T5's bias): out and lse within 1e-4, each gradient within 1e-4 of
   its largest magnitude, the plain version fed operands rounded once to
   bf16 outside that and at least ten times farther off than the kernel;
   every form (three-term TF32 split on the tensor cores, forward and
   backward) also against the plain version fed operands truncated once to
   TF32 (what a one-pass kernel computes), held to the same two
   conditions, and against plain attention in fp64 (its error stated, at
   most 1e-5; of each gradient's largest magnitude); with the time of one
   ``scaled_dot_product_attention`` call on the same fp32 inputs, the
   kernels' device time (profiler) and split pre-pass, and the bound at 3
   TF32 passes over 495 TFLOP/s (the 67 TFLOP/s FMA bound beside it).
4. SD1: full-width SD1 (CLIP, 860M UNet, VAE decoder) with random weights
   from a seed, ``SD1Generator`` at 512x512, 50 k-LMS steps, CFG 7.5: two
   batch-1 requests, then one batch-4 request. Checks the images, the final
   latents, the kernel launch counts of every request, and that K1 took the
   sm90 kernel (the VAE's d = 512 attention aside). Then one profiled
   request at batch 1 and one at batch 4: device-busy ms, idle share and
   K1's share of the device time. Then the rest of
   the generator on the same bundle: a request with each of the four
   samplers at 50 steps, img2img at strength 0.8 from a seeded uint8 image
   (40 steps; the VAE encoder's attention is one K1 launch at head dim 512),
   ``do_cfg=False``, the same ``per_sample_seeds`` entry at batch 1 and
   inside a batch of 4 (equal initial latents, bit for bit), and a weighted
   prompt through the tokenizer with a synthetic vocabulary. Then a
   request at 768x768 (20 k-LMS steps): the UNet's level-2 self-attention
   runs K1 at head dim 160; s/image, device-busy ms and K1's launches by
   head dim and kernel. Then SD1 in fp32 (``SD1Models``' default dtype
   from a JAX tree), 10 steps, through the fp32 kernels against the same
   request through plain attention, and the fp32 bundle at 768x768 (10
   steps) the same way as the bf16 one. Then (after the checkpoint phase)
   ``SD1Models.quantize_int8()`` on the bf16 bundle (resident GiB before and
   after, the peak while it runs), the int8 product's int32 accumulators
   against the exact product at the UNet's operand shapes (equality), and
   one 512^2 / 50-step request in int8: K1, K2 and ``torch._int_mm`` calls
   counted, s/image, its image against the bf16 one (printed).
5. SD3: full-width SD3-medium (CLIP-L, CLIP-G, T5-XXL, the depth-24 MMDiT,
   the 16-channel VAE decoder; random weights from a seed, bf16, all
   resident), ``SD3Inferencer.gen_image`` at 1024x1024, 50 flow-Euler
   steps, CFG 5, shift 3, zero tokens: a cold request, a warm timed one and
   a profiled one (device time by kernel family, device idle share).
   Checks the images, the final latents and the launches of K5 (4 per
   block), K1 (the VAE's mid attention) and K2 per request. Then the
   bundle's T5-XXL encoder alone on (2, 512) token ids, the longest prompt
   SD3 admits: its 24 attentions take K1 in the bias form; the output is
   held against the same encoder through plain attention on the card, and
   both are timed (10 calls) with the device-busy time of one call. Then
   the rest of SD3 serving on the same bundle: img2img (the warm image back
   in as ``init_image`` at strength 0.6, the last 30 steps; the VAE encoder
   takes K1 at d = 512 and K2); batch 2 with ``per_sample_seeds=[warm seed,
   None]`` decoded tiled (``models/sd3_vae_tiled.py``: the head's K1 at
   batch 2 and 5 GroupNorms) and again whole from the same final latents,
   each decode timed with its peak memory (the tiled image against the
   whole one within 11 levels, mean 1.2; sample 0's starting noise equal to
   the warm request's, bit for bit; its image within the same levels of the
   warm image); the text entry points with a synthetic CLIP vocabulary and
   a synthetic SentencePiece model written by ``build_spm_model``
   (``gen_image_text`` and ``gen_image`` on the tokenizer's ids: 0 values
   differ; a ``(word:1.3)`` prompt with ``prompt_weighting``). After the
   checkpoint phase, on the bundle it loaded: ``SD3Models.quantize_int8()``
   (resident GiB before and after, the peak while it runs), the int8
   accumulators against the exact product at the MMDiT's and T5's operand
   shapes, 16 rows and fewer padded (equality), the warm request in int8
   (s/image, ms/step, K5 launches, ``torch._int_mm`` calls, the final
   latents' relative L2 against the bf16 request's, a sanity bound of 0.5),
   and last ``gen_image(offload_text_encoders=True)``: its image equal to
   the int8 request's (0 values differ), ``hbm_bytes_live()`` falling by the
   text encoders' bytes, and ``get_cond`` raising afterwards. Then
   (the bf16 bundle freed) SD3-medium in fp32, 28.7 GiB of weights, 4 steps
   at 1024x1024 through the fp32 kernels against plain attention, and its
   fp32 T5-XXL on (2, 512) tokens through K1's fp32 bias form against plain
   attention.
   Checkpoints (after the SD1 phase's generator paths, and after T5): the
   resident SD1 bundle written in the reference layout (``ckpt/{clip,
   diffusion,encoder,decoder}.pt``, fp32, the attention projections under
   their ``*_proj_weight`` names) and read back by
   ``SD1Models.from_checkpoint_dir``; the SD3-medium bundle written as the
   published safetensors files (``sd3`` with ``model.diffusion_model.*``,
   ``first_stage_model.encoder.*`` and ``first_stage_model.decoder.*``,
   HF-layout CLIP-L, CLIP-G and T5-XXL;
   bf16 weights, fp32 norms), freed once the files are read back by
   ``SD3Models.from_checkpoints`` and compared. Each loaded bundle lives on
   the card, equals its source bit for bit (the sniffed MMDiT config
   equal), and answers the source's request (SD1 batch 1 seed 1; SD3 the
   warm request's seed) within one level of the source's image, through
   K1, K2 and K5 by the launch counters; the SD3 VAE encoder read back
   encodes the warm image to the source encoder's latent, bit for bit.
   Prints the bytes, the seconds to
   write and to load and the peak host RSS of the load; the files are
   deleted whatever happens.
6. training: the tiny-SD ``DDPMTrainer`` at ``TinySDConfig()`` defaults
   (64x64, batch 32, base 128 x [1,2,2,2], 3 classes, dropout 0.1, bf16
   over fp32 parameters, AdamW, clip 1.0, warmup-cosine LR) on
   ``SyntheticImageDataset``: warm-up steps, timed steps (CUDA events),
   profiled steps (device time by kernel family, device idle share).
   Checks finite losses and gradients, moved parameters, and the launches
   of K1, K3, K4 and K2 per step (K3 and K4 on their sm90 kernels).
7. gradient check: loss and gradient of one batch of 4 on the card (bf16,
   kernels) against the same weights and inputs on the CPU (fp32, plain
   versions), dropout off, as relative L2 errors of the whole flattened
   gradient and of each self-attention leaf of the six flash blocks; then
   the same check on two planted faults of the flash backward (dk and dv
   swapped; dq without its scale), which it must catch.
8. sampling: ``DDPMTrainer.sample`` of 4 labels, CFG as one batch-8
   forward, over T = 250 steps (the trained weights under a config with a
   shorter chain, to keep the run short); checks the images and the launches.
9. MMDiT training: ``MMDiTTrainer`` at SD3-medium's width and depth
   (``MMDiTConfig()``: depth 24, hidden 1536, 24 heads of 64) and SD3's
   operating point (latent 128: 4096 x tokens + 154 context tokens), batch
   2, bf16 over fp32 parameters, random weights from seed 0, normal
   latents, context and pooled vectors from a numpy seed: warm-up steps,
   timed steps (CUDA events), one profiled step. Checks finite losses, the
   fixed batch's loss before and after, and the launches per step of K5,
   K6 and K7 (4 per block each).
10. MMDiT gradient check: a depth-2 MMDiT at 529 ragged x tokens + 154
   context tokens, batch 2, on the card (bf16, kernels) against the CPU
   (fp32, plain versions): the whole gradient and the qkv leaves of both
   streams; then a planted fault of the joint backward it must catch.
11. MMDiT sampling: ``MMDiTTrainer.sample`` of 2 latents in a few CFG
   flow-Euler steps from the trained state; checks the latents and the
   launches of K5.
12. TinyVLM training: ``VLMTrainer`` with the SigLIP-base tower (hidden 768,
   12 layers, 12 heads of 64, patch 16) on 384 x 384 captioned shapes (576
   patch tokens) and a decoder of width 768, depth 12 over 576 + 8 tokens,
   batch 16, bf16 over fp32 parameters: warm-up, timed and one profiled
   step. Checks finite losses, the fixed batch's loss before and after, and
   the launches per step of K1 (12 no-mask, 12 causal), K3 and K4.
13. TinyVLM gradient check: 2 tower layers + 2 decoder blocks at the same
   widths and lengths, batch 4, card (bf16, kernels) against CPU (fp32,
   plain versions); then a planted fault of the flash backward.
14. TinyVLM decoding: ``caption_accuracy`` on held-out images through
   ``greedy_decode`` (7 forwards); the accuracy is printed, not judged.
15. fp32 training: two steps each of ``VLMTrainer`` at its default dtype
   (fp32) on 384 x 384 images, ``TinySDConfig(dtype="fp32")`` and
   ``FlowTrainConfig(dtype="fp32")`` with the depth-24 MMDiT, through the
   fp32 kernels and again through plain attention from the same seeds: the
   losses and the last step's gradient must agree, and the fp32 launch
   counts are asserted (a run that reached no fp32 kernel fails).

Every kernel's launch count is set to 0 just before each of the SD1, SD1
generator, SD1 at 768^2, SD1 checkpoint, SD1 int8, SD3, SD3 img2img, SD3
batch 2 tiled, SD3 text, SD3 checkpoint, SD3 int8, SD3 offload, training,
sampling, MMDiT training, MMDiT sampling, T5, TinyVLM training, TinyVLM
decoding and fp32 paths and read
just after (before the plain-attention run it is compared with), K1's also
by the kernel it ran (sm90, d512, fp32) and by head dim, K3's - K7's (but
K2) by the kernel they ran (sm90, fp32): on every path the launches by
kernel add up to the launches, on the bf16 SD3 and MMDiT paths every K5, K6
and K7 launch took sm90, and on the bf16
tiny-SD and TinyVLM training paths every K3 and K4 launch took sm90. The last two
lines are a
JSON summary of the kernels and ``{"ok": true, "device": {...}}``; the
card's name and power limit come on the line before them. Imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
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
# SD1 at 768^2 (96 x 96 latents): the 15 self-attentions of >= 512 tokens
# per UNet forward are 5 at each level, 9216 tokens at d = 40, 2304 at
# d = 80 and 576 at d = 160 (the mid block's 144 run plain); + the VAE
# decoder's mid attention at d = 512.
SD1_768_STEPS, SD1_768_FP32_STEPS = 20, 10
SD1_768_PER_STEP = {40: 5, 80: 5, 160: 5}
# Tiny-SD UNet forward: 6 self-attentions of >= 512 tokens (enc1, dec6,
# dec7 at 64^2; enc3, dec4, dec5 at 32^2) take K1, and their backward K3
# and K4; 39 GroupNorms (28 in 14 ResBlocks, 10 TransformerBlock norm_in,
# the tail). The GroupNorm backward is plain PyTorch, so no K2 there.
TRAIN_PER_STEP = dict(K1=6, K3=6, K4=6, K2=39, K5=0, K6=0, K7=0)
SAMPLE_T = 250
# SD3 request: 4 position-masked flash calls (context and x queries against
# context and x keys) in each of 24 joint blocks x 50 steps; the VAE
# decoder's one mid attention over 128 x 128 tokens takes K1; 30 GroupNorms
# in the decoder (2 in each of 14 res blocks, the attention's, the tail).
SD3_DEPTH, SD3_STEPS = 24, 50
SD3_PER_REQUEST = dict(K1=1, K2=30, K3=0, K4=0, K5=4 * SD3_DEPTH * SD3_STEPS,
                       K6=0, K7=0)
# MMDiT train step: in each of the 24 joint blocks the forward launches K5
# four times (context and x queries against context and x keys) and the
# backward K6 and K7 four times each, under the merged lse; the MMDiT has no
# GroupNorm and nothing takes the unmasked kernels. A CFG sampling step is
# one forward of batch 2B.
MMDIT_PER_STEP = dict(K1=0, K2=0, K3=0, K4=0, K5=4 * SD3_DEPTH,
                      K6=4 * SD3_DEPTH, K7=4 * SD3_DEPTH)
MMDIT_SAMPLE_STEPS = 4
# TinyVLM train step: the 12 tower layers attend over 576 patch tokens (K1
# without a mask) and the 12 decoder blocks over 576 + 8 tokens (K1 causal);
# the backward launches K3 and K4 once for each. Greedy decoding of 8 slots
# is 7 forwards. The T5-XXL encoder's 24 blocks share one bias.
VLM_LAYERS = 12
VLM_PER_STEP = dict(K1=2 * VLM_LAYERS, K2=0, K3=2 * VLM_LAYERS,
                    K4=2 * VLM_LAYERS, K5=0, K6=0, K7=0)
VLM_DECODE_FORWARDS = 7
T5_PER_CALL = dict(K1=24, K2=0, K3=0, K4=0, K5=0, K6=0, K7=0)
NO_MASK, CAUSAL, BIASED = ((False, False, False), (True, False, False),
                           (False, True, False))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16, data sheet
PEAK_FP32_FLOPS = 67e12    # outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # dense TF32 on the tensor cores
TF32_PASSES = 3            # the fp32 forward's split: hi hi + hi lo + lo hi
PEAK_BYTES = 3.35e12       # HBM3
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

    for name in ("kernels", "kernels_fp32"):   # bf16 + GroupNorm; fp32 flash
        t0 = time.perf_counter()
        _build.load(name)
        nvcc, log = _build.builds[name]
        print(f"build {name}: {time.perf_counter() - t0:.2f} s (nvcc "
              f"{'cached' if nvcc is None else f'{nvcc:.2f} s'}) -> "
              f"{_build.library_path(name).name}", flush=True)
        for line in log.splitlines():
            # C75xx: ptxas serialised or fenced wgmma instructions itself
            if ("Used" in line or "spill" in line or "Compiling" in line
                    or "(C75" in line):
                print("  ptxas:", line.strip().removeprefix("ptxas info    :"))
    sass_check(_build.library_path("kernels"), SM90_KERNELS, BF16_FAMILY)
    sass_check(_build.library_path("kernels_fp32"), FP32_KERNELS,
               FP32_FAMILY)


# The sm90 K1 instantiations: 5 padded head dims (48, 64, 80, 128, 160)
# without a mask, 7 mask forms at head dims 64 and 128; the d = 512 K1; the
# sm90 K3 and K4: 8 forms
# at head dims 64 and 128 each; the sm90 K5: online and bounded at head dims
# 64 and 128; the sm90 K6 and K7: head dims 64 and 128.
SM90_KERNELS = {  # kind -> (kernel name, instantiations)
    "K1 sm90": ("flash_fwd_sm90_kernel", 5 + 2 * 7),
    "K1 d512": ("flash_fwd_d512", 1),
    "K3 sm90": ("flash_bwd_dq_sm90_kernel", 2 * 8),
    "K4 sm90": ("flash_bwd_dkv_sm90_kernel", 2 * 8),
    "K5 sm90": ("flash_fwd_pos_sm90_kernel", 2 * 2),
    "K6 sm90": ("flash_bwd_pos_dq_sm90_kernel", 2),
    "K7 sm90": ("flash_bwd_pos_dkv_sm90_kernel", 2),
}
# The names of the kernels above, and of any other bf16 flash kernel: one
# outside the table fails the check.
BF16_FAMILY = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_pos_dkv",
               "flash_bwd_dq", "flash_bwd_pos_dq")
# The fp32 forward (TF32 split): seven head dims without a mask, the masked
# form online (K1 causal, K5) and bounded (K5), T5's bias form; the d = 512
# kernel. The fp32 backward (TF32 split): dq and dk/dv at head dims 64 and
# 128 without a mask and their masked forms at 64 (K3 / K4 causal, K6 / K7).
FP32_KERNELS = {
    "K1/K5 fp32": ("flash_fwd_f32_kernel", 7 + 2 + 1),
    "K1 fp32 d512": ("flash_fwd_f32_d512_kernel", 1),
    "K3/K6 fp32": ("flash_bwd_dq_f32_kernel", 3),
    "K4/K7 fp32": ("flash_bwd_dkv_f32_kernel", 3),
}
FP32_FAMILY = ("flash_fwd", "flash_bwd")


def sass_check(library, table, family):
    """Counts, in each kernel of the built library whose name holds one of
    ``family``, the wgmma (HGMMA) and TMA (UTMALDG, UBLKCP) instructions of
    its SASS (cuobjdump -sass), and checks that every instantiation ``table``
    names has both and that no kernel of ``family`` is outside it."""
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            fn = name if any(key in name for key in family) else None
            if fn:
                counts[fn] = [0, 0]
        elif fn:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += "UTMALDG" in line or "UBLKCP" in line
    found = {kind: {f: c for f, c in counts.items() if key in f}
             for kind, (key, _) in table.items()}
    names = {"K1 sm90": "causal/bias/segments", "K3 sm90":
             "causal/bias/segments", "K4 sm90": "causal/bias/segments",
             "K5 sm90": "bounded", "K1/K5 fp32": "masked/bounded/bias",
             "K3/K6 fp32": "masked", "K4/K7 fp32": "masked"}
    for kind, fns in found.items():
        for f, (hgmma, tma) in sorted(fns.items()):
            # template arguments: padded head dim, then the form's flags
            inst = re.search(r"kernelILi(\d+)E((?:Lb\dE)*)", f)
            flags = "/".join(re.findall(r"Lb(\d)E", inst.group(2))) if inst \
                else ""
            what = (f"DP={inst.group(1)}" if inst else "DP=512") + (
                f" {names[kind]}={flags}" if flags else "")
            print(f"  sass {kind} {what}: HGMMA {hgmma}, UTMALDG/UBLKCP {tma}",
                  flush=True)
        check(len(fns) == table[kind][1] and all(
            h > 0 and t > 0 for h, t in fns.values()),
            f"the {kind} kernels lack wgmma or TMA in their SASS: {fns}")
    check(len(counts) == sum(n for _, n in table.values()),
          f"{'/'.join(family)} kernels off the TMA / wgmma routes: "
          f"{sorted(set(counts) - {f for fns in found.values() for f in fns})}")


# The four (Lq, Lk) of the SD3 / MMDiT joint attention: 154 context and 4096
# x tokens (latent 128), each query stream against each key stream.
SD3_JOINT_SHAPES = ((154, 154), (154, 4096), (4096, 154), (4096, 4096))

# K1's timed cases, which compare_revisions.py times too. Without a mask,
# (B, H, Lq, Lk, D): the first is reported (SD1 UNet at 64^2), the last two
# are the SD3 VAE's mid attention over 128 x 128 tokens (decoder and
# encoder at batch 1, the tiled decode's head at batch 2).
K1_SHAPES = [(2, 8, 4096, 4096, 40), (2, 8, 1024, 1024, 80),
             (1, 1, 4096, 4096, 512), (1, 2, 1000, 777, 80),
             (32, 1, 4096, 4096, 128), (32, 2, 1024, 1024, 128),
             (1, 2, 1000, 777, 128), (1, 1, 16384, 16384, 512),
             (2, 1, 16384, 16384, 512)]
# K2's timed cases, (shape, act, dtype), which compare_revisions.py times
# too: the first is reported (SD1 UNet at 64^2, CFG batch 2); then its other
# levels and batch 8, the SD1 VAE decoder's 512^2 level in both dtypes,
# tiny-SD's batch 32, the largest and the widest GroupNorm of the SD3 VAE
# decoder. The smaller keep their rows in shared memory, the larger stream.
GN_CASES = [((2, 64, 64, 320), "silu", "bf16"),
            ((2, 32, 32, 640), "silu", "bf16"),
            ((2, 8, 8, 1280), "silu", "bf16"),
            ((8, 64, 64, 320), "silu", "bf16"),
            ((1, 512, 512, 128), None, "bf16"),
            ((1, 512, 512, 128), None, "fp32"),
            ((32, 64, 64, 128), "silu", "bf16"),
            ((1, 1024, 1024, 128), "silu", "bf16"),
            ((1, 128, 128, 512), "silu", "bf16")]
# K1 at head dim 160 (SD1's UNet at level 2 from 768^2: 576 tokens, 8 heads
# of 160, batch 2 with CFG); kept apart from K1_SHAPES, which
# compare_revisions.py also times on checkouts from before d = 160.
K1_D160_SHAPE = (2, 8, 576, 576, 160)
# The mask forms at the TinyVLM step's shapes (the tower's 576 tokens, the
# decoder's 576 + 8 causal), causal at head dim 128, T5's bias shared over
# the batch, and packed sequences: (form, (B, H, Lq, Lk, D), masks), where
# masks holds ``causal``, ``bias_bh`` (the bias's (B, H) before it is
# broadcast), ``ids`` (see k1_segment_ids) and ``scale``.
K1_FORMS = [
    ("none, SigLIP tower", (16, 12, 576, 576, 64), {}),
    ("causal, TinyVLM decoder", (16, 12, 584, 584, 64), dict(causal=True)),
    ("causal", (2, 8, 4096, 4096, 128), dict(causal=True)),
    ("bias, T5-XXL", (2, 64, 512, 512, 64), dict(bias_bh=(1, 64), scale=1.0)),
    ("segments", (2, 12, 4096, 4096, 64), dict(ids="packed")),
    ("segments + causal", (2, 12, 4096, 4096, 64),
     dict(ids="packed", causal=True)),
    ("segments + bias", (2, 12, 4096, 4096, 64),
     dict(ids="packed", bias_bh=(1, 12))),
    # 1/64 of the pairs visible and one tile in 64 to visit: where the tile
    # skip matters most
    ("segments, 64 sequences of 64 tokens", (2, 12, 4096, 4096, 64),
     dict(ids="short")),
]


def packed_ids(b, n, n_seq, seed):
    """(B, n) int32 on the card: each row packs n_seq sorted ragged
    sequences."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(b):
        cuts = np.sort(rng.choice(np.arange(64, n - 64), n_seq - 1,
                                  replace=False))
        rows.append(np.repeat(np.arange(n_seq), np.diff(
            np.concatenate([[0], cuts, [n]]))))
    return torch.from_numpy(np.stack(rows).astype(np.int32)).cuda()


def k1_segment_ids(kind, b, n):
    """K1_FORMS' segment ids: "packed", 8 ragged sequences a row, or
    "short", 64 sequences of 64 tokens."""
    import torch

    if kind == "packed":
        return packed_ids(b, n, 8, seed=5)
    return (torch.arange(n, device="cuda") // 64).int().expand(b, -1)


def kernel_counters():
    """name -> the function object whose ``launches`` counts the kernel."""
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as gn

    return dict(K1=fa.flash_attention_cuda, K2=gn.group_norm_cuda,
                K3=fa.flash_attention_bwd_dq_cuda,
                K4=fa.flash_attention_bwd_dkv_cuda,
                K5=fa.flash_attention_pos_cuda, K6=fa.flash_bwd_pos_dq_cuda,
                K7=fa.flash_bwd_pos_dkv_cuda)


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0
        for counter in ("forms", "dtypes", "routes", "head_dims"):
            if hasattr(fn, counter):
                getattr(fn, counter).clear()


class Counts(dict):
    """Launches by kernel; ``k1_routes``: K1's launches by the kernel they
    ran (``flash_attention_cuda.routes``: "sm90", "d512", "fp32");
    ``k3_routes`` - ``k7_routes`` (but K2's): K3's - K7's (``.routes`` of
    their wrappers: "sm90", "fp32");
    ``k1_head_dims``: K1's launches by head dim."""


ROUTED = ("K1", "K3", "K4", "K5", "K6", "K7")  # counted by route


def read_counts():
    fns = kernel_counters()
    counts = Counts((k, fn.launches) for k, fn in fns.items())
    for k in ROUTED:
        setattr(counts, k.lower() + "_routes",
                dict(getattr(fns[k], "routes", {})))
    counts.k1_head_dims = dict(getattr(fns["K1"], "head_dims", {}))
    return counts


def read_fp32_counts():
    """Launches of each flash kernel's fp32 form since the last reset."""
    return {k: fn.dtypes["fp32"] for k, fn in kernel_counters().items()
            if hasattr(fn, "dtypes")}


@contextlib.contextmanager
def plain_attention_only():
    """Every attention of the port through its plain path on the card:
    ``dot_product_attention(use_flash=False)`` whoever calls it, and the
    joint attention through plain attention over the concatenated streams.
    The oracle of a whole request or train step."""
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as attn

    saved = attn.dot_product_attention, attn._flash_eligible
    attn.dot_product_attention = functools.partial(saved[0], use_flash=False)
    attn._flash_eligible = lambda q, k: False
    try:
        yield
    finally:
        attn.dot_product_attention, attn._flash_eligible = saved


def rel_l2(a, b):
    """|a - b| / |b| over all elements, in fp64."""
    a, b = a.double().flatten(), b.double().flatten()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


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


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): the least time the card could take."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attn_bound(b, h, lq, lk, d, n_products=2, n_q_like=2, n_k_like=2,
               n_stats=1):
    """Unmasked attention-shaped work in bf16: ``n_products`` Lq x Lk x d
    products (2 flop per multiply-add), ``n_q_like`` (Lq, d) and
    ``n_k_like`` (Lk, d) bf16 tensors and ``n_stats`` fp32 (Lq,) row
    statistics, each moved once."""
    flops = 2.0 * n_products * b * h * lq * lk * d
    nbytes = b * h * (2.0 * d * (n_q_like * lq + n_k_like * lk)
                      + 4.0 * n_stats * lq)
    return bound(flops, nbytes)


def _close(a, b, rtol, atol):
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def kernel_device_ms(call, family, n=10):
    """The device ms of one ``call()``: profiler kernel rows of ``family``
    over ``n`` calls; None where no window recorded one."""
    fams = device_families(lambda: [call() for _ in range(n)], family)
    return fams[family] / n if family in fams else None


def fp32_fwd_device_ms(call, n=3, family=None):
    """The device ms of one fp32 flash ``call()``: its flash kernels of
    ``family`` (``device_ms``; the forward's by default) and its split
    pre-pass (``split_device_ms``), from one profile of ``n`` calls; None
    where no window recorded one."""
    family = family or F32_FWD
    fams = device_families(lambda: [call() for _ in range(n)], family)
    return {key: fams[fam] / n if fam in fams else None
            for key, fam in (("device_ms", family),
                             ("split_device_ms", F32_SPLIT))}


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_kernels(card):
    """Each kernel against its plain version at the paths' shapes, with its
    bound and the library call's time. Returns, per kernel, the largest
    error over all cases and the times at the shape reported for it."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as attn
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf16 = torch.bfloat16
    results = {}

    def record(name, err, report, **times):
        r = results.setdefault(name, dict(err=0.0))
        r["err"] = max(r["err"], err)
        if report:
            r.update(times)

    def tail(ms, plain_ms, bound_ms, bound_by, library_ms):
        return (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                f"{100 * bound_ms / ms:.1f} % of it reached) [{card}]")

    sdpa = F.scaled_dot_product_attention

    # K1: q, k, v are column slices of one fused projection, as on the path.
    bwd_reported = False
    results["d512"] = []
    for i, (b, h, lq, lk, d) in enumerate(K1_SHAPES):
        split = lambda x, n: [t.reshape(b, n, h, d).transpose(1, 2)
                              for t in x.chunk(x.shape[-1] // (h * d), -1)]
        q = split(rnd(b, lq, h * d).to(bf16), lq)[0]
        k, v = split(rnd(b, lk, 2 * h * d).to(bf16), lk)
        out, lse = fa.flash_attention_cuda(q, k, v)
        ref, ref_lse = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        del ref, ref_lse
        times = dict(zip(("bound_ms", "bound_by"), attn_bound(b, h, lq, lk, d)),
                     ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v)),
                     plain_ms=cuda_ms(
                         lambda: fa.flash_attention_plain(q, k, v), 5, 1),
                     library_ms=cuda_ms(lambda: sdpa(q, k, v), 10, 2))
        print(f"K1 flash fwd (B,H,Lq,Lk,D)=({b},{h},{lq},{lk},{d}) bf16: "
              f"max|out err|={err:.3e} (atol 2e-2) max|lse err|="
              f"{lse_err:.3e} (atol 1e-3); {tail(**times)}", flush=True)
        check(err <= 2e-2 and lse_err <= 1e-3,
              f"K1 disagrees at {(b, h, lq, lk, d)}: {err} / {lse_err}")
        record("K1", err, i == 0, **times)
        if d == 512:    # its keys over 1 and 2 blocks per query tile
            split_ms, chosen = {}, fa.k1_d512_splits(b, h, lq, lk,
                                                     fa._sm_count(q.device))
            for n in (1, 2):
                o_n, l_n = fa._flash_fwd_d512(q, k, v, d ** -0.5, n)
                err_n = (o_n.float() - out.float()).abs().max().item()
                check(err_n <= 2e-2 and (l_n - lse).abs().max().item() <= 1e-3,
                      f"K1 d=512 with {n} key splits disagrees at "
                      f"{(b, h, lq, lk, d)}: {err_n}")
                split_ms[n] = cuda_ms(
                    lambda: fa._flash_fwd_d512(q, k, v, d ** -0.5, n))
            print(f"K1 d=512 key splits ({b},{h},{lq},{lk},{d}): 1 split "
                  f"{split_ms[1]:.4f} ms, 2 splits {split_ms[2]:.4f} ms; the "
                  f"route takes {chosen} [{card}]", flush=True)
            results["d512"].append(dict(
                shape=[b, h, lq, lk, d], max_abs_err=err, splits=chosen,
                split_ms=split_ms, **times))
        if d == 128:    # the first of them (tiny-SD at 64^2) is reported
            for name, e in phase_kernels_bwd(card, q, k, v, out, lse, gen,
                                             tail).items():
                record(name, e.pop("err"), not bwd_reported, **e)
            bwd_reported = True

    # K1 at head dim 160: the SD1 UNet's level-2 self-attention from 768^2
    # (576 tokens; 2B = 2 with CFG), on the sm90 kernel like the others.
    b, h, lq, lk, d = K1_D160_SHAPE
    q, k, v = (t.reshape(b, lq, h, d).transpose(1, 2) for t in
               rnd(b, lq, 3 * h * d).to(bf16).chunk(3, -1))
    n0 = fa.flash_attention_cuda.routes["sm90"]
    out, lse = fa.flash_attention_cuda(q, k, v)
    check(fa.flash_attention_cuda.routes["sm90"] == n0 + 1,
          "K1 at d = 160 did not take the sm90 kernel")
    ref, ref_lse = fa.flash_attention_plain(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    del ref, ref_lse
    run = lambda: fa.flash_attention_cuda(q, k, v)
    times = dict(zip(("bound_ms", "bound_by"), attn_bound(b, h, lq, lk, d)),
                 ms=cuda_ms(run), device_ms=kernel_device_ms(
                     run, "K1 flash fwd"),
                 plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v),
                                  5, 1),
                 library_ms=cuda_ms(lambda: sdpa(q, k, v), 10, 2))
    line = tail(**{key: times[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    print(f"K1 flash fwd (B,H,Lq,Lk,D)={K1_D160_SHAPE} bf16 (SD1 level 2 at "
          f"768^2): max|out err|={err:.3e} (atol 2e-2) max|lse err|="
          f"{lse_err:.3e} (atol 1e-3); {line}; device "
          f"{fmt_ms(times['device_ms'])}", flush=True)
    check(err <= 2e-2 and lse_err <= 1e-3,
          f"K1 disagrees at {K1_D160_SHAPE}: {err} / {lse_err}")
    results["d160"] = dict(shape=list(K1_D160_SHAPE), max_abs_err=err,
                           **times)
    record("K1", err, False)

    fp32 = torch.float32
    results["K2 shapes"] = []
    for i, (shape, act, dt) in enumerate(GN_CASES):
        dtype, c = bf16 if dt == "bf16" else fp32, shape[-1]
        x = (rnd(*shape) * 2.0 + 0.5).to(dtype)
        scale = 1.0 + 0.1 * rnd(c)
        bias = 0.1 * rnd(c)
        y = gn.group_norm_cuda(x, 32, scale, bias, 1e-5, act)
        if dtype == fp32:
            rtol, atol, plain = 0.0, 1e-4, gn.group_norm_plain
        else:
            rtol, atol, plain = 1.6e-2, 1.6e-2, gn.group_norm_plain_one_pass
        ref = plain(x, 32, scale, bias, 1e-5, act)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        ok = _close(y, ref, rtol, atol)
        del ref
        x_nchw, w, bb = x.permute(0, 3, 1, 2), scale.to(dtype), bias.to(dtype)
        if act == "silu":
            library = lambda: F.silu(F.group_norm(x_nchw, 32, w, bb, 1e-5))
        else:
            library = lambda: F.group_norm(x_nchw, 32, w, bb, 1e-5)
        # x read and y written once; ~10 fp32 operations per element
        # (statistics, normalise, affine, SiLU) outside the tensor cores
        run = lambda: gn.group_norm_cuda(x, 32, scale, bias, 1e-5, act)
        times = dict(zip(("bound_ms", "bound_by"),
                         bound(10.0 * x.numel(),
                               2.0 * x.numel() * x.element_size() + 8.0 * c,
                               PEAK_FP32_FLOPS)),
                     ms=cuda_ms(run),
                     plain_ms=cuda_ms(lambda: plain(x, 32, scale, bias, 1e-5,
                                                    act), 5, 1),
                     library_ms=cuda_ms(library, 10, 2))
        # one profile of 10 calls: the kernel's device time and how many
        # kernels a call launches
        fams, rows = {}, []
        for _ in range(3):
            _, _, fams, _, rows = profile_device(lambda: [run()
                                                          for _ in range(10)])
            if "K2 group norm" in fams:
                break
        device_ms = fams.get("K2 group norm", 0.0) / 10 or None
        per_call = sum(n for _, n, key in rows
                       if _family(key) == "K2 group norm") / 10
        again = run()
        plan = gn.group_norm_plan(shape[0], x.numel() // (shape[0] * c), c,
                                  32, x.element_size(),
                                  fa._sm_count(x.device))
        regime = "resident" if plan.resident else "streaming"
        name = "fp32 two-pass" if dtype == fp32 else "bf16 one-pass"
        print(f"K2 group norm {shape} act={act} {dtype} ({regime}) vs plain "
              f"{name}: max|err|={err:.3e} (rtol {rtol}, atol {atol}); "
              f"{tail(**times)}; device {fmt_ms(device_ms)}, {per_call:g} "
              f"kernel(s) a call (profiler); a second call bitwise equal: "
              f"{torch.equal(y, again)}", flush=True)
        check(ok, f"K2 disagrees at {shape} {dtype}")
        check(per_call == 1, f"K2 at {shape} {dtype} ran {per_call} kernels "
              f"a call, not one")
        check(torch.equal(y, again), f"K2 at {shape} {dtype}: two calls "
              f"on one input differ")
        record("K2", err if dtype == bf16 else 0.0, i == 0,
               device_ms=device_ms, **times)
        results["K2 shapes"].append(dict(
            shape=list(shape), act=act, dtype=dt,
            regime=regime, max_abs_err=err, device_ms=device_ms,
            kernels_per_call=per_call, **times))

    # The GroupNorm backward (a plain port of the JAX _fused_bwd, no
    # kernel) at the tiny-SD 64^2 shape, as the trainer runs it.
    x = (rnd(32, 64, 64, 128) * 2.0 + 0.5).to(bf16)
    scale, bias, dy = 1.0 + 0.1 * rnd(128), 0.1 * rnd(128), rnd(
        32, 64, 64, 128).to(bf16)
    ms = cuda_ms(lambda: gn.group_norm_bwd_plain(x, scale, bias, dy, 32,
                                                 1e-5, "silu"), 10, 2)
    print(f"GroupNorm backward (plain, autograd Function) (32,64,64,128) "
          f"act=silu bf16: {ms:.4f} ms [{card}]", flush=True)
    del x, dy

    # K5 at the four shapes of the SD3 joint attention (CFG batch 2, 24
    # heads of 64): q, k, v are slices of the fused (B, L, 3, H, D)
    # projections, as the MMDiT passes them. The x-by-x call is reported;
    # every shape is recorded with its device time (profiler).
    b, h, d = 2, 24, 64
    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    fused = {n: rnd(b, n, 3 * h * d).to(bf16).reshape(b, n, 3, h, d)
             for n in (154, 4096)}
    pick = lambda n, i: fused[n][:, :, i].transpose(1, 2)
    results["K5 shapes"] = []
    for lq, lk in SD3_JOINT_SHAPES:
        q, k, v = pick(lq, 0), pick(lk, 1), pick(lk, 2)
        ref, ref_lse = fa.flash_attention_pos_plain(q, k, v, z, z)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_pos_plain(q, k, v, z, z), 5, 1)
        library_ms = cuda_ms(lambda: sdpa(q, k, v), 10, 2)
        bound_ms, bound_by = attn_bound(b, h, lq, lk, d)
        for stability in ("online", "bounded"):
            run = lambda: fa.flash_attention_pos_cuda(q, k, v, z, z,
                                                      stability=stability)
            out, lse = run()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            times = dict(ms=cuda_ms(run), plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
            device_ms = kernel_device_ms(run, "K5 flash fwd pos")
            print(f"K5 flash fwd pos (B,H,Lq,Lk,D)=({b},{h},{lq},{lk},{d}) "
                  f"{stability} bf16: max|out err|={err:.3e} (atol 2e-2) "
                  f"max|lse err|={lse_err:.3e} (atol 1e-3); {tail(**times)}, "
                  f"kernel device time {fmt_ms(device_ms)} (profiler)",
                  flush=True)
            check(err <= 2e-2 and lse_err <= 1e-3, f"K5 {stability} disagrees "
                  f"at {(b, h, lq, lk, d)}: {err} / {lse_err}")
            record("K5", err, (lq, lk, stability) == (4096, 4096, "online"),
                   **times)
            results["K5 shapes"].append(dict(
                shape=[b, h, lq, lk, d], stability=stability,
                max_abs_err=err, device_ms=device_ms, **times))
        del ref, ref_lse

    # K5's masks at a smaller size: (B, H, Lq, Lk, D), query and key
    # offsets, segment boundaries, causal, valid_len.
    off = lambda a, c: torch.tensor([a, c], dtype=torch.int32, device="cuda")
    mask_cases = [
        ("two segments, causal", (1, 4, 1000, 1000, 64), (1000, 3000),
         (0, 2000), 512, 500, True, None),
        ("two segments, valid_len", (1, 4, 1000, 1000, 64), (1000, 3000),
         (0, 2000), 512, 500, False, 2300),
        ("two segments, causal and valid_len", (1, 4, 1000, 1000, 64),
         (1000, 3000), (0, 2000), 512, 500, True, 2300),
        ("ragged key tail", (2, 3, 300, 777, 64), (0, 0), (0, 0), None, None,
         False, None),
        ("head dim 128, causal", (1, 2, 1000, 777, 128), (500, 2000),
         (0, 1500), 600, 400, True, None),
        ("fully masked rows", (1, 4, 1000, 1000, 64), (100, 5000),
         (3000, 4000), 512, 500, True, None),
    ]
    for what, (b_, h_, lq, lk, d_), qo, ko, seg_q, seg_k, causal, valid in \
            mask_cases:
        q, k, v = (rnd(b_, h_, n, d_).to(bf16) for n in (lq, lk, lk))
        kw = dict(causal=causal, valid_len=valid, seg_q=seg_q, seg_k=seg_k)
        ref, ref_lse = fa.flash_attention_pos_plain(q, k, v, off(*qo),
                                                    off(*ko), **kw)
        seen = ref_lse > -1e29
        for stability in ("online", "bounded"):
            out, lse = fa.flash_attention_pos_cuda(
                q, k, v, off(*qo), off(*ko), stability=stability, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float())[seen].abs().max().item()
            lse_err = (lse - ref_lse)[seen].abs().max().item()
            blank = bool((lse[~seen] <= -1e29).all()) and not bool(
                out[~seen].any())
            print(f"K5 {what} ({b_},{h_},{lq},{lk},{d_}) {stability}: "
                  f"max|out err|={err:.3e} (atol 2e-2) max|lse err|="
                  f"{lse_err:.3e} (atol 1e-3) on {int(seen.sum())} rows that "
                  f"see a key; {int((~seen).sum())} rows that see none give "
                  f"out = 0, lse <= -1e29: {blank}", flush=True)
            check(err <= 2e-2 and lse_err <= 1e-3 and blank,
                  f"K5 {stability} disagrees at {what}: {err} / {lse_err} / "
                  f"{blank}")
            record("K5", err, False)
        if what == "fully masked rows":
            check(int((~seen).sum()) == 4 * 512, "expected 512 blank rows")

    # The joint attention of one MMDiT block: four K5 launches and two
    # merges against plain attention over the concatenated 4250 tokens.
    b, h, d = 2, 24, 64
    ctx = [pick(154, i) for i in range(3)]
    xs = [pick(4096, i) for i in range(3)]
    cat = [torch.cat([c_, x_], dim=2) for c_, x_ in zip(ctx, xs)]
    ref = attn.plain_attention(*cat)
    for stability in ("online", "bounded"):
        run = lambda: fa.joint_flash_attention(*ctx, *xs, d ** -0.5, stability)
        n0 = fa.flash_attention_pos_cuda.launches
        oc, ox = run()
        torch.cuda.synchronize()
        check(fa.flash_attention_pos_cuda.launches == n0 + 4,
              "joint attention did not launch K5 four times")
        err = (torch.cat([oc, ox], dim=2).float() - ref.float()).abs().max(
            ).item()
        print(f"joint attention (2,24,154+4096,64) {stability}: max|err|="
              f"{err:.3e} (atol 2e-2) against plain attention over the "
              f"concatenated sequence; 4 x K5 + 2 merges "
              f"{cuda_ms(run, 10, 2):.4f} ms, plain "
              f"{cuda_ms(lambda: attn.plain_attention(*cat), 3, 1):.4f} ms, "
              f"library (one call, concatenated) "
              f"{cuda_ms(lambda: sdpa(*cat), 10, 2):.4f} ms [{card}]",
              flush=True)
        check(err <= 2e-2, f"joint attention {stability} disagrees: {err}")
    del ref, cat
    for name, e in phase_kernels_pos_bwd(card, ctx, xs, rnd, off,
                                         tail).items():
        record(name, e.pop("err"), True, **e)
    del ctx, xs, fused
    torch.cuda.empty_cache()
    forms = phase_kernels_masks(card, rnd, tail)
    for case in forms:
        for name in ("K1", "K3", "K4"):
            record(name, case[name]["max_abs_err"], False)
    results["forms"] = forms
    return results, tail


def phase_kernels_masks(card, rnd, tail):
    """The causal, bias and segment-id forms of K1, K3 and K4 (and their
    no-mask form at head dim 64) against the plain versions under the same
    masks. Returns one record per timed case: the shape, the form, and for
    each kernel its error, time, plain time, library time and bound."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    sdpa = F.scaled_dot_product_attention
    records = []

    def run(what, b, h, lq, lk, d, causal=False, bias_bh=None, ids=None,
            scale=None, timed=True, blank_rows=False):
        if lq == lk:    # q|k|v column slices of one fused projection
            q, k, v = (t.reshape(b, lq, h, d).transpose(1, 2) for t in
                       rnd(b, lq, 3 * h * d).to(bf16).chunk(3, -1))
        else:
            q, k, v = (rnd(b, h, n, d).to(bf16) for n in (lq, lk, lk))
        g = rnd(b, lq, h * d).to(bf16).reshape(b, lq, h, d).transpose(1, 2)
        bias = (None if bias_bh is None
                else (0.5 * rnd(*bias_bh, lq, lk)).to(bf16))
        masks = dict(bias=bias, segment_ids=ids, causal=causal)
        need = bias is not None
        out, lse = fa.flash_attention_cuda(q, k, v, scale, **masks)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, scale, **masks)
        seen = ref_lse > -1e29
        n_blank = int((~seen).sum())
        err = (out.float() - ref.float())[seen].abs().max().item()
        lse_err = (lse - ref_lse)[seen].abs().max().item()
        blank = bool((lse[~seen] <= -1e29).all()) and not bool(
            out[~seen].any())
        check(err <= 2e-2 and lse_err <= 1e-3 and blank
              and (n_blank > 0) == blank_rows,
              f"K1 {what} disagrees: {err} / {lse_err} / blank rows "
              f"{n_blank} zero: {blank}")
        del ref, ref_lse
        if need:    # NaNs in the allocator's pool: an unwritten tile shows
            junk = torch.full((b, h, lq, lk), float("nan"), device="cuda")
            del junk
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, scale,
                                          **masks, need_dbias=need)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, scale,
                                            **masks, need_dbias=need)
        torch.cuda.synchronize()
        errs, line = {}, []
        for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
            e = (a.float() - w.float()).abs().max().item()
            top = w.float().abs().max().item()
            finite = bool(torch.isfinite(a).all())
            check(finite and e <= 2e-2 * top + 1e-6 and a.shape == w.shape,
                  f"{name} {what} disagrees: {e} > 2e-2 * {top} (finite: "
                  f"{finite})")
            errs[name] = e
            line.append(f"{name} {e:.3e}/{top:.3e}")
        head = (f"masks {what} (B,H,Lq,Lk,D)=({b},{h},{lq},{lk},{d}): K1 "
                f"max|out err|={err:.3e} (atol 2e-2) max|lse err|="
                f"{lse_err:.3e} (atol 1e-3), {n_blank} rows see no key (out "
                f"= 0, lse <= -1e29: {blank}); K3/K4 max|err|/max|grad| "
                f"{', '.join(line)} (tol 2e-2)")
        if not timed:
            print(head, flush=True)
            return (q, k, v, g, bias, out, lse), got, want
        del got, want

        # The bound counts the pairs the mask admits: products of 2*d flop
        # each over them; q, k, v, dO, the outputs, the row statistics, the
        # bias (and dbias in its shape) and the ids moved once.
        vis = fa._visible_pairs(lq, lk, ids, causal, "cuda")
        pairs = (b * lq * lk if vis is None
                 else int(vis.sum()) * (b // vis.shape[0]))
        del vis
        side = (0 if bias is None else bias.numel() * bias.element_size()) + (
            0 if ids is None else 4 * b * (lq + lk))

        def bnd(n_products, n_q_like, n_k_like, n_stats, n_bias):
            return dict(zip(("bound_ms", "bound_by"), bound(
                2.0 * n_products * pairs * h * d,
                b * h * (2.0 * d * (n_q_like * lq + n_k_like * lk)
                         + 4.0 * n_stats * lq) + n_bias * side)))

        # the library call: one mask argument that says the same
        lib = dict(scale=scale)
        if ids is None and bias is None:
            lib["is_causal"] = causal
        else:
            mask = fa._visible_pairs(lq, lk, ids, causal, "cuda")
            if bias is None:
                lib["attn_mask"] = mask
            elif mask is None:
                lib["attn_mask"] = bias
            else:
                lib["attn_mask"] = bias.expand(b, h, lq, lk).masked_fill(
                    ~mask, float("-inf"))
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = sdpa(ql, kl, vl, **lib)
        delta = (g.float() * out.float()).sum(-1)
        fwd = dict(ms=cuda_ms(lambda: fa.flash_attention_cuda(
                       q, k, v, scale, **masks)),
                   plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                       q, k, v, scale, **masks), 3, 1),
                   library_ms=cuda_ms(lambda: sdpa(q, k, v, **lib), 10, 2),
                   **bnd(2, 2, 2, 1, 1))
        # the kernel's own device time (profiler kernel rows): the wall time
        # of a segment-id call also holds the wrapper's tile ranges
        device_ms = kernel_device_ms(lambda: fa.flash_attention_cuda(
            q, k, v, scale, **masks), "K1 flash fwd")
        shared = dict(
            plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, lse, g, scale, **masks, need_dbias=need), 3, 1),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                ol, (ql, kl, vl), g, retain_graph=True), 5, 1))
        t3 = dict(ms=cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(
                      q, k, v, g, lse, delta, scale, **masks,
                      need_dbias=need), 10, 2),
                  **shared, **bnd(3, 3, 2, 2, 2 if need else 1))
        t4 = dict(ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
                      q, k, v, g, lse, delta, scale, **masks), 10, 2),
                  **shared, **bnd(4, 2, 4, 2, 1))
        t4["device_ms"] = kernel_device_ms(
            lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, g, lse, delta,
                                                    scale, **masks),
            "K4 flash bwd dk/dv")
        dev, dev4 = fmt_ms(device_ms), fmt_ms(t4["device_ms"])
        print(f"{head}; {100.0 * pairs / (b * lq * lk):.1f} % of the pairs "
              f"visible; K1: {tail(**fwd)}, kernel device time {dev} "
              f"(profiler); the plain backward computes dq, "
              f"dk, dv{' and dbias' if need else ''} together, the library's "
              f"dq, dk and dv; K3{' with dbias' if need else ''}: "
              f"{tail(**t3)}; K4: "
              f"{tail(**{k: x for k, x in t4.items() if k != 'device_ms'})}, "
              f"kernel device time {dev4} (profiler)", flush=True)
        records.append(dict(
            form=what, shape=[b, h, lq, lk, d],
            visible_share=pairs / (b * lq * lk),
            K1=dict(max_abs_err=err, device_ms=device_ms, **fwd),
            K3=dict(max_abs_err=max(errs["dq"], errs.get("dbias", 0.0)), **t3),
            K4=dict(max_abs_err=max(errs["dk"], errs["dv"]), **t4)))
        return (q, k, v, g, bias, out, lse), None, None

    for what, shape, m in K1_FORMS:
        ids = m.get("ids")
        ids = None if ids is None else (k1_segment_ids(ids, shape[0],
                                                       shape[2]),) * 2
        kept, _, _ = run(what, *shape, causal=m.get("causal", False),
                         bias_bh=m.get("bias_bh"), ids=ids,
                         scale=m.get("scale"))
        if what == "causal, TinyVLM decoder":
            q, k, v, *_, out, _ = kept
        del kept
    torch.cuda.empty_cache()
    # Planted fault: a causal mask off by one (col < row) must be caught.
    diag = torch.zeros(584, 584, device="cuda").fill_diagonal_(-1e30)
    strict, _ = fa.flash_attention_plain(q, k, v, bias=diag[None, None],
                                         causal=True)
    off_by_one = (out.float() - strict.float()).abs().max().item()
    print(f"masks control (causal off by one: the kernel against a plain "
          f"version that hides the diagonal): max|out err|={off_by_one:.3e}: "
          f"{'caught' if off_by_one > 2e-2 else 'MISSED'}", flush=True)
    check(off_by_one > 2e-2, "a causal mask off by one was not caught")
    del q, k, v, out, strict, diag

    # Smaller cases, errors only: causal at Lq != Lk (the kernels count rows
    # and columns from 0), rows that see no key, every form at once.
    run("causal, Lq > Lk", 2, 3, 777, 300, 64, causal=True, timed=False)
    run("causal, Lq < Lk", 2, 3, 300, 777, 128, causal=True, timed=False)
    iq = torch.arange(600, device="cuda")
    lonely = torch.where(iq % 50 == 3, 7, iq // 200).int()[None]
    run("segments, rows that see no key", 1, 4, 600, 600, 64,
        ids=(lonely, (iq // 200).int()[None]), timed=False, blank_rows=True)
    ids = packed_ids(2, 333, 3, seed=6)
    (q, k, v, g, bias, out, lse), got, want = run(
        "causal + bias + segments", 2, 3, 333, 333, 128, causal=True,
        bias_bh=(2, 3), ids=(ids, ids), timed=False)
    # Planted fault: a dbias tile that K3 skips (keys 64..95 of the first 32
    # queries lie above the diagonal) left as the allocator had it.
    delta = (g.float() * out.float()).sum(-1)
    _, ds = fa.flash_attention_bwd_dq_cuda(
        q, k, v, g, lse.contiguous(), delta, bias=bias, segment_ids=(ids, ids),
        causal=True, need_dbias=True)
    clean = (ds.sum_to_size(bias.shape).to(bf16).float()
             - want[3].float()).abs().max().item()
    check(not bool(ds[:, :, :32, 64:96].any()), "K3 wrote dbias above the "
          "diagonal")
    ds[:, :, :32, 64:96] = 1.0
    dirty = (ds.sum_to_size(bias.shape).to(bf16).float()
             - want[3].float()).abs().max().item()
    top = want[3].float().abs().max().item()
    print(f"masks control (a skipped dbias tile left unwritten): max|dbias "
          f"err| {clean:.3e} as the kernel writes it, {dirty:.3e} with the "
          f"tile at 1 (tol 2e-2 * {top:.3e}): "
          f"{'caught' if dirty > 2e-2 * top else 'MISSED'}", flush=True)
    check(clean <= 2e-2 * top and dirty > 2e-2 * top,
          "an unwritten dbias tile was not caught")
    return records


def k1_launch_path(card, where, n=2000):
    """The host's part of a K1 call, at small shapes whose kernels take a
    few microseconds, so that back-to-back calls run at the host's pace:
    the wrapper (``flash_attention_cuda``) and its C entry alone
    (``fdsd_flash_fwd`` on arguments made once), each ``n`` calls on the
    host clock, and the kernel's own device time (profiler). Returns
    {case: (wrapper us, C entry us, kernel us)}."""
    import ctypes

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(7)
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    out_us = {}
    for what, (b, h, n_tok, d), biased in (
            ("d=64, no mask", (1, 2, 128, 64), False),
            ("d=80, no mask", (1, 2, 128, 80), False),
            ("d=64, bias shared over the batch", (2, 2, 128, 64), True)):
        q, k, v = (t.reshape(b, n_tok, h, d).transpose(1, 2) for t in
                   torch.randn(b, n_tok, 3 * h * d, generator=gen,
                               device="cuda").to(torch.bfloat16).chunk(3, -1))
        bias = (torch.randn(1, h, n_tok, n_tok, generator=gen, device="cuda")
                .to(torch.bfloat16).expand(b, -1, -1, -1) if biased else None)
        call = lambda: fa.flash_attention_cuda(q, k, v, bias=bias)
        out = torch.empty(b, n_tok, h, d, device="cuda",
                          dtype=torch.bfloat16).transpose(1, 2)
        lse = torch.empty(b, h, n_tok, device="cuda")
        flat = [st for x in (q, k, v, out) for st in x.stride()[:3]]
        flat += [0] * 4 if bias is None else list(bias.stride())
        strides = (ctypes.c_longlong * 16)(*flat)
        args = ([x.data_ptr() for x in (q, k, v, out, lse)]
                + [None if bias is None else bias.data_ptr()] + [None] * 6
                + [b, h, n_tok, n_tok, d, ctypes.cast(strides,
                                                      ctypes.c_void_p),
                   d ** -0.5, 0, int(biased), stream])
        entry = lambda: _build.check(lib.fdsd_flash_fwd(*args),
                                     "fdsd_flash_fwd")
        us = []
        for fn in (call, entry):
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            us.append((time.perf_counter() - t) * 1e6 / n)
        kernel_ms = kernel_device_ms(entry, "K1 flash fwd", 100)
        us.append(float("nan") if kernel_ms is None else 1e3 * kernel_ms)
        print(f"K1 launch path ({where}), {what}, (B,H,L,D)=({b},{h},{n_tok},"
              f"{d}): wrapper {us[0]:.2f} us/call, C entry alone "
              f"{us[1]:.2f} us/call ({n} calls back to back, host clock), "
              f"kernel {us[2]:.2f} us (profiler) [{card}]", flush=True)
        out_us[what] = tuple(us)
    return out_us


def k2_launch_path(card, where, n=2000):
    """The host's part of a K2 call at the SD1 UNet's (2, 64, 64, 320) +
    SiLU, whose kernel takes a few microseconds: the wrapper
    (``group_norm_cuda``) and its C entry alone (``fdsd_group_norm`` on
    arguments made once), each ``n`` calls back to back on the host clock,
    and the kernel's own device time (profiler). Returns (wrapper us, C
    entry us, kernel us)."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(2, 64, 64, 320, generator=gen, device="cuda").to(
        torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(320, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(320, generator=gen, device="cuda")
    call = lambda: gn.group_norm_cuda(x, 32, scale, bias, 1e-5, "silu")
    call()
    dev = x.get_device()
    _, n_part, _, plan_args, lib = gn._launch_plan(x, dev, 2, 64 * 64, 320,
                                                   32)
    y = torch.empty_like(x)
    part = torch.empty(n_part, device="cuda")
    args = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            part.data_ptr(), plan_args, 1e-5, 1,
            torch.cuda.current_stream().cuda_stream)
    entry = lambda: gn._build.check(lib.fdsd_group_norm(*args),
                                    "fdsd_group_norm")
    us = []
    for fn in (call, entry):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t) * 1e6 / n)
    kernel_ms = kernel_device_ms(entry, "K2 group norm", 100)
    us.append(float("nan") if kernel_ms is None else 1e3 * kernel_ms)
    print(f"K2 launch path ({where}), (2,64,64,320) + SiLU bf16: wrapper "
          f"{us[0]:.2f} us/call, C entry alone {us[1]:.2f} us/call ({n} "
          f"calls back to back, host clock), kernel {us[2]:.2f} us "
          f"(profiler) [{card}]", flush=True)
    return tuple(us)


def phase_kernels_pos_bwd(card, ctx, xs, rnd, off, tail):
    """K6 and K7 against ``flash_bwd_pos_plain``: at the four shapes of the
    joint attention under the merged (global) lse and delta, at small masked
    cases, and the joint backward as a whole against autograd through plain
    attention over the concatenated sequence. Returns the largest errors and
    the times at the x-by-x shape."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as attn
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    z = off(0, 0)
    worst = dict(K6=0.0, K7=0.0)
    reported = {}

    def compare(what, q, k, v, g, lse, delta, qo, ko, **kw):
        """Errors of (dq, dk, dv) relative to each gradient's largest
        magnitude; tolerance 2e-2 of it (five bf16 ulps, as K3 / K4), with
        an absolute floor of 1e-6 where a gradient is zero everywhere."""
        got = (fa.flash_bwd_pos_dq_cuda(q, k, v, g, lse, delta, qo, ko, **kw),
               *fa.flash_bwd_pos_dkv_cuda(q, k, v, g, lse, delta, qo, ko,
                                          **kw))
        want = fa.flash_bwd_pos_plain(q, k, v, g, lse, delta, qo, ko, **kw)
        torch.cuda.synchronize()
        line = []
        for name, kern, a, w in zip(("dq", "dk", "dv"), ("K6", "K7", "K7"),
                                    got, want):
            err = (a.float() - w.float()).abs().max().item()
            ref = w.float().abs().max().item()
            finite = bool(torch.isfinite(a).all())
            check(finite and err <= 2e-2 * ref + 1e-6,
                  f"{kern} {name} disagrees at {what}: {err} > 2e-2 * {ref} "
                  f"(finite: {finite})")
            worst[kern] = max(worst[kern], err)
            line.append(f"max|{name} err|={err:.3e} (max|{name}|={ref:.3e})")
        return "; ".join(line) + "; tol 2e-2 of the largest magnitude"

    # The four partials of one MMDiT block (CFG-free batch 2, 24 heads of
    # 64): q, k, v are slices of the fused projections; dO is a (B, H, L, D)
    # view of (B, L, H*D) memory, as the out-projection's gradient arrives;
    # lse and delta are those of the merged forward over both key streams.
    b, h, d = 2, 24, 64
    streams = dict(c=ctx, x=xs)
    stats, shapes = {}, dict(K6=[], K7=[])
    for s_, (q, _, _) in streams.items():
        n = q.shape[2]
        g = rnd(b, n, h * d).to(bf16).reshape(b, n, h, d).transpose(1, 2)
        out, lse = fa.merge_attention_partials(
            *fa.flash_attention_pos(q, ctx[1], ctx[2], z, z),
            *fa.flash_attention_pos(q, xs[1], xs[2], z, z))
        stats[s_] = (g, lse.contiguous(), (g.float() * out.float()).sum(-1))
    name_of = {154: "c", 4096: "x"}
    for lq_, lk_ in SD3_JOINT_SHAPES:
        sq, sk = name_of[lq_], name_of[lk_]
        q, (_, k, v) = streams[sq][0], streams[sk]
        g, lse, delta = stats[sq]
        lq, lk = q.shape[2], k.shape[2]
        errs = compare((b, h, lq, lk, d), q, k, v, g, lse, delta, z, z)
        # the library's backward gives dq, dk and dv in one call
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl)
        shared = dict(
            plain_ms=cuda_ms(lambda: fa.flash_bwd_pos_plain(
                q, k, v, g, lse, delta, z, z), 3, 1),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                ol, (ql, kl, vl), g, retain_graph=True), 5, 1))
        # K6: S, dP and dQ products; reads q, k, v, dO, writes dq.
        # K7: S, dP, dV and dK products; reads q, k, v, dO, writes dk, dv.
        t6 = dict(zip(("bound_ms", "bound_by"),
                      attn_bound(b, h, lq, lk, d, 3, 3, 2, 2)), **shared,
                  ms=cuda_ms(lambda: fa.flash_bwd_pos_dq_cuda(
                      q, k, v, g, lse, delta, z, z), 10, 2))
        t7 = dict(zip(("bound_ms", "bound_by"),
                      attn_bound(b, h, lq, lk, d, 4, 2, 4, 2)), **shared,
                  ms=cuda_ms(lambda: fa.flash_bwd_pos_dkv_cuda(
                      q, k, v, g, lse, delta, z, z), 10, 2))
        dev6 = kernel_device_ms(lambda: fa.flash_bwd_pos_dq_cuda(
            q, k, v, g, lse, delta, z, z), "K6 flash bwd pos dq")
        dev7 = kernel_device_ms(lambda: fa.flash_bwd_pos_dkv_cuda(
            q, k, v, g, lse, delta, z, z), "K7 flash bwd pos dk/dv")
        print(f"K6/K7 flash bwd pos (B,H,Lq,Lk,D)=({b},{h},{lq},{lk},{d}) "
              f"bf16, global lse: {errs}; plain and library compute dq, dk "
              f"and dv together; K6: {tail(**t6)}, kernel device time "
              f"{fmt_ms(dev6)}; K7: {tail(**t7)}, kernel device time "
              f"{fmt_ms(dev7)} (profiler)", flush=True)
        del ol, ql, kl, vl
        for name, t, dev in (("K6", t6, dev6), ("K7", t7, dev7)):
            shapes[name].append(dict(shape=[b, h, lq, lk, d], device_ms=dev,
                                     **t))
        if (sq, sk) == ("x", "x"):
            reported = dict(K6=t6, K7=t7)

    # Masks at a smaller size, under a lse that is global over TWO key
    # blocks at different positions: (B, H, Lq, Lk, D), query offsets, the
    # two blocks' key offsets, segment boundaries, causal, valid_len.
    mask_cases = [
        ("two segments, causal", (1, 4, 1000, 1000, 64), (1000, 3000),
         [(0, 2000), (500, 2500)], 512, 500, True, None),
        ("two segments, valid_len", (1, 4, 1000, 1000, 64), (1000, 3000),
         [(0, 2000), (500, 2500)], 512, 500, False, 2300),
        ("two segments, causal and valid_len", (1, 4, 1000, 1000, 64),
         (1000, 3000), [(0, 2000), (500, 2500)], 512, 500, True, 2300),
        ("ragged x length 529 against 154", (2, 3, 529, 154, 64), (0, 0),
         [(0, 0), (154, 154)], None, None, False, None),
        ("head dim 128, causal", (1, 2, 1000, 777, 128), (500, 2000),
         [(0, 1500), (300, 1700)], 600, 400, True, None),
        ("rows masked in one partial only", (1, 4, 1000, 1000, 64),
         (100, 5000), [(3000, 4000), (0, 50)], 512, 500, True, None),
        ("rows masked everywhere", (1, 4, 1000, 1000, 64), (100, 5000),
         [(3000, 4000), (3500, 4500)], 512, 500, True, None),
    ]
    for what, (b_, h_, lq, lk, d_), qo, kos, seg_q, seg_k, causal, valid in \
            mask_cases:
        q, g = (rnd(b_, h_, lq, d_).to(bf16) for _ in range(2))
        blocks = [tuple(rnd(b_, h_, lk, d_).to(bf16) for _ in range(2))
                  for _ in kos]
        kw = dict(causal=causal, valid_len=valid, seg_q=seg_q, seg_k=seg_k)
        parts = [fa.flash_attention_pos_plain(q, k, v, off(*qo), off(*ko),
                                              **kw)
                 for (k, v), ko in zip(blocks, kos)]
        out, lse = fa.merge_attention_partials(*parts[0], *parts[1])
        delta = (g.float() * out.float()).sum(-1)
        blank = int((lse <= -1e29).sum())
        one_only = int(((parts[0][1] <= -1e29) & (lse > -1e29)).sum())
        for i, ((k, v), ko) in enumerate(zip(blocks, kos)):
            errs = compare(f"{what}, block {i}", q, k, v, g, lse, delta,
                           off(*qo), off(*ko), **kw)
            print(f"K6/K7 {what} ({b_},{h_},{lq},{lk},{d_}) key block {i}: "
                  f"{errs}; {blank} rows see no key anywhere, {one_only} "
                  f"see none in block 0 only", flush=True)
        if what == "rows masked everywhere":
            check(blank == 4 * 512, f"expected 2048 blank rows, got {blank}")
        if what == "rows masked in one partial only":
            check(blank == 0 and one_only == 4 * 512,
                  f"expected 2048 rows masked in block 0 only: {one_only}, "
                  f"{blank} blank")

    # The joint backward of one MMDiT block: 4 x K5, then 4 x K6 + 4 x K7 and
    # the sums, against autograd through plain attention over the
    # concatenated 4250 tokens. Tolerance 3e-2 of each gradient's largest
    # magnitude: two bf16 partials summed on top of the kernels' own 2e-2.
    b, h, d = 2, 24, 64
    leaves = [t.detach().requires_grad_() for t in (*ctx, *xs)]
    g_c, g_x = stats["c"][0], stats["x"][0]
    before = read_counts()
    oc, ox = fa.joint_flash_attention(*leaves, d ** -0.5, "online")
    got = torch.autograd.grad((oc, ox), leaves, (g_c, g_x),
                              retain_graph=True)
    torch.cuda.synchronize()
    after = read_counts()
    check([after[k] - before[k] for k in ("K5", "K6", "K7")] == [4, 4, 4],
          "joint attention forward + backward did not launch K5, K6 and K7 "
          "four times each")
    ms = cuda_ms(lambda: torch.autograd.grad((oc, ox), leaves, (g_c, g_x),
                                             retain_graph=True), 5, 1)
    del oc, ox
    ref_leaves = [t.detach().requires_grad_() for t in leaves]
    cat = [torch.cat([c_, x_], dim=2)
           for c_, x_ in zip(ref_leaves[:3], ref_leaves[3:])]
    ref = attn.plain_attention(*cat)
    want = torch.autograd.grad(ref, ref_leaves, torch.cat([g_c, g_x], dim=2))
    del ref
    ql, kl, vl = (t.detach().requires_grad_() for t in cat)
    ol = F.scaled_dot_product_attention(ql, kl, vl)
    gl = torch.cat([g_c, g_x], dim=2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), gl, retain_graph=True), 5, 1)
    line = []
    for name, a, w in zip(("dq_c", "dk_c", "dv_c", "dq_x", "dk_x", "dv_x"),
                          got, want):
        err = (a.float() - w.float()).abs().max().item()
        ref_max = w.float().abs().max().item()
        check(bool(torch.isfinite(a).all()) and err <= 3e-2 * ref_max,
              f"joint backward {name} disagrees: {err} > 3e-2 * {ref_max}")
        line.append(f"{name} {err:.3e}/{ref_max:.3e}")
    print(f"joint attention backward (2,24,154+4096,64): max|err| / max|grad| "
          f"{', '.join(line)} (tol 3e-2) against autograd through plain "
          f"attention over the concatenated sequence; 4 x K6 + 4 x K7 + "
          f"deltas and sums {ms:.4f} ms, library backward (one call, "
          f"concatenated) {library_ms:.4f} ms [{card}]", flush=True)
    return {k: dict(err=worst[k], shapes=shapes[k], **reported[k])
            for k in ("K6", "K7")}


def phase_kernels_bwd(card, q, k, v, out, lse, gen, tail):
    """K3 and K4 against the plain backward on K1's inputs and outputs."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    b, h, lq, d = q.shape
    lk = k.shape[2]
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
    del got, want
    delta = (g.float() * out.float()).sum(-1)
    # the library's backward gives dq, dk and dv in one call
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    ol = F.scaled_dot_product_attention(ql, kl, vl)
    shared = dict(
        plain_ms=cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, g), 3, 1),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), g, retain_graph=True), 5, 1))
    # K3: S, dP and dQ products; reads q, k, v, dO, writes dq.
    # K4: S, dP, dV and dK products; reads q, k, v, dO, writes dk, dv.
    t3 = dict(zip(("bound_ms", "bound_by"),
                  attn_bound(b, h, lq, lk, d, 3, 3, 2, 2)), **shared,
              ms=cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(
                  q, k, v, g, lse, delta), 10, 2))
    t4 = dict(zip(("bound_ms", "bound_by"),
                  attn_bound(b, h, lq, lk, d, 4, 2, 4, 2)), **shared,
              ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
                  q, k, v, g, lse, delta), 10, 2))
    print(f"K3/K4 flash bwd (B,H,Lq,Lk,D)=({b},{h},{lq},{lk},{d}) bf16: "
          f"{'; '.join(line)}; plain and library compute dq, dk and dv "
          f"together; K3: {tail(**t3)}; K4: {tail(**t4)}", flush=True)
    return dict(K3=dict(err=errs["dq"], **t3),
                K4=dict(err=max(errs["dk"], errs["dv"]), **t4))


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
    wall = {}   # batch -> s of its last unprofiled request
    first_image = None   # the checkpoint phase answers this request again
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
        wall[b] = secs
        if first_image is None:
            first_image = images
    launches = read_counts()
    routes = dict(kernel_counters()["K1"].routes)
    print(f"SD1 K1 launches by kernel over the {len(requests)} requests: "
          f"{routes}", flush=True)
    check(routes == {"sm90": 500 * len(requests), "d512": len(requests)},
          f"SD1's K1 launches did not take the sm90 kernel (d = 512 aside): "
          f"{routes}")
    for h in hooks:
        h.remove()
    # One profiled request at batch 1 and at batch 4 (after the counted
    # ones): device busy time, idle share against the unprofiled request of
    # the same batch, and K1's share of the device time.
    for prompt_batch, seed in ((prompts[:1], 1), (prompts, 3)):
        b = len(prompt_batch)
        for _ in range(3):  # a profile that recorded no kernel is run again
            n0 = read_counts()["K1"]
            images, wall_ms, fams, n_kernels, rows = profile_device(
                lambda: sd(prompt_batch, seed=seed))
            if fams:
                break
        check(bool(fams), f"torch.profiler recorded no kernel of the SD1 "
              f"request at bs={b}")
        busy = sum(fams.values()) or float("nan")
        k1_ms = fams.get("K1 flash fwd", 0.0)
        print(f"SD1 profile of one request bs={b} (torch.profiler, kernel rows "
              f"only): device busy {busy:.1f} ms over {n_kernels} kernels, K1 "
              f"{k1_ms:.1f} ms ({100 * k1_ms / busy:.1f} % of busy); wall under "
              f"the profiler {wall_ms:.1f} ms, unprofiled {1e3 * wall[b]:.1f} "
              f"ms; device idle share {1.0 - busy / (1e3 * wall[b]):.3f} (1 - "
              f"busy / unprofiled request) [{card}]", flush=True)
        print_profile(fams, rows, 1, "request")
        check(read_counts()["K1"] - n0 == K1_PER_REQUEST
              and images.shape == (b, 512, 512, 3),
              "the profiled SD1 request did not run its K1 launches")
    return launches, models, first_image


def phase_sd3(card):
    """SD3-medium at full width and depth: 1024^2, 50 flow-Euler steps,
    CFG 5 as one batch-2 MMDiT forward, shift 3, bf16, zero tokens."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer, SD3Models)

    t0 = time.perf_counter()
    models = SD3Models.initialize(
        torch.Generator(device="cuda").manual_seed(0), "cuda", "bf16",
        depth=SD3_DEPTH, pos_embed_max_size=192)
    torch.cuda.synchronize()
    groups = {f.name: getattr(models, f.name)
              for f in dataclasses.fields(models)}
    sizes = {n: sum(p.numel() for p in m.parameters())
             for n, m in groups.items()}
    held = torch.cuda.memory_allocated() / 2 ** 30
    print(f"SD3: random-init SD3-medium bundle, {sum(sizes.values())} params "
          f"{sizes}, bf16, {held:.2f} GiB resident, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    inf = SD3Inferencer(models, shift=3.0)

    step_events, final_latents, first_inputs = [], [], []
    hooks = request_hooks(models, step_events, final_latents, first_inputs)
    tokens = np.zeros((1, 77), np.int32)
    request = lambda seed: inf.gen_image(
        tokens, width=1024, height=1024, steps=SD3_STEPS, cfg_scale=5.0,
        seed=seed)

    reset_counts()
    warm_ms = None
    for what, seed in (("cold", 1), ("warm", 2), ("profiled", 3)):
        n0 = read_counts()
        step_events.clear()
        final_latents.clear()
        first_inputs.clear()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if what == "profiled":
            images, wall_ms, fams, n_kernels, rows = profile_device(
                lambda: request(seed))
        else:
            images = request(seed)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        n1 = read_counts()
        got = {k: n1[k] - n0[k] for k in n1}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"SD3 request ({what}) seed={seed}: {wall_ms / 1e3:.3f} "
              f"s/image, {step_ms(step_events):.2f} ms/denoise step (MMDiT "
              f"batch 2, 154 + "
              f"4096 tokens), peak {peak:.2f} GiB, launches {got} [{card}]",
              flush=True)
        check(images.shape == (1, 1024, 1024, 3) and str(images.dtype) ==
              "uint8", f"SD3 image shape/dtype {images.shape} {images.dtype}")
        check(float(images.std()) > 0.0, "constant SD3 image")
        check(len(final_latents) == 1 and final_latents[0].shape
              == (1, 128, 128, 16)
              and bool(torch.isfinite(final_latents[0]).all()),
              "SD3 final latents not finite or misshaped")
        check(len(step_events) == SD3_STEPS,
              f"{len(step_events)} MMDiT calls, not {SD3_STEPS}")
        check(got == SD3_PER_REQUEST,
              f"SD3 launches {got} != {SD3_PER_REQUEST}")
        if what == "warm":
            warm_ms, warm_image, warm_seed = wall_ms, images, seed
            warm_latents, warm_noise = final_latents[0], first_inputs[0]
    busy = sum(fams.values())
    print(f"SD3 profile of one request (torch.profiler, kernel rows only): "
          f"device busy {busy:.1f} ms over {n_kernels} kernels; wall under "
          f"the profiler {wall_ms:.1f} ms, unprofiled warm {warm_ms:.1f} ms; "
          f"device idle share {1.0 - busy / warm_ms:.3f} (1 - busy / "
          f"unprofiled warm request) [{card}]", flush=True)
    print_profile(fams, rows, 1, "request")
    launches = read_counts()
    for hook in hooks:
        hook.remove()
    # the bundle and the warm request go on to the serving and checkpoint
    # phases: its image, seed, final latents and starting noise
    return ([launches, phase_t5(card, models.t5)],
            dict(models=models, image=warm_image, seed=warm_seed,
                 latents=warm_latents, noise=warm_noise, ms=warm_ms,
                 resident=held))


def request_hooks(models, step_events, final_latents, first_inputs=None):
    """Forward pre-hooks on an SD3 bundle: a CUDA event at each MMDiT call
    (ms per denoise step), the final latents at each whole-image decode,
    and the MMDiT's first input of a request (at sigma 1 the starting noise
    itself) once ``first_inputs`` is empty. Returns the handles."""
    import torch

    def on_mmdit(module, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if first_inputs is not None and not step_events:
            first_inputs.append(args[0].detach().clone())
        step_events.append(ev)

    def on_decoder(module, args):
        final_latents.append(args[0].detach().clone())

    return [models.mmdit.register_forward_pre_hook(on_mmdit),
            models.vae_decoder.register_forward_pre_hook(on_decoder)]


def step_ms(step_events):
    return (step_events[0].elapsed_time(step_events[-1])
            / max(1, len(step_events) - 1))


def phase_t5(card, t5):
    """The T5-XXL encoder on (2, 512) token ids: every block's attention
    over 512 tokens takes K1 with the shared bucket bias (scale 1.0). Each
    block's attention sub-layer is held against the same sub-layer through
    plain attention on the same input (the plain path's activations), and
    the whole encoder is timed both ways."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as attn
    from from_ddpm_to_stable_diffusion_tpu_torch.ops.groupnorm import rms_norm

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, t5.config.vocab_size, (2, 512))).cuda()
    eligible = attn._flash_eligible

    def plainly(fn):
        attn._flash_eligible = lambda q, k: False
        try:
            return fn()
        finally:
            attn._flash_eligible = eligible

    reset_counts()
    with torch.no_grad():
        out = t5(tokens)
        torch.cuda.synchronize()
        launches = read_counts()
        forms = dict(kernel_counters()["K1"].forms)
        ms = cuda_ms(lambda: t5(tokens), 10, 1)
        busy = device_families(lambda: t5(tokens), "K1 flash fwd")
        ref = plainly(lambda: t5(tokens))
        plain_ms = plainly(lambda: cuda_ms(lambda: t5(tokens), 10, 1))
        plain_busy = plainly(lambda: device_families(lambda: t5(tokens)))
        # block by block, both paths fed the plain path's activations
        x, bias, worst = t5.embed_tokens(tokens), None, (0.0, 1.0, 0)
        for i in range(t5.config.num_layers):
            block = getattr(t5, f"block{i}")
            h = rms_norm(x, block.ln1_scale, eps=1e-6)
            got, shared_bias = block.attn(h, bias)
            want, _ = plainly(lambda: block.attn(h, bias))
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            if err / top > worst[0] / worst[1]:
                worst = (err, top, i)
            bias = shared_bias
            x, _ = plainly(lambda: block(x, bias))
    free = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    # Both paths round P and the attention output to bf16 (8 significant
    # bits) and sum in another order: the sub-layer's output (after the
    # bf16 out-projection) agrees to a few bf16 ulps of its largest entry.
    # Over 24 blocks the two encoders drift apart all the same: with random
    # weights and unscaled logits (q.k has a standard deviation near 8) the
    # softmax is sharp, each block multiplies a rounding difference, and the
    # residual stream grows until one of its bf16 ulps is 0.25; that drift
    # is printed, not judged.
    def busy_of(fams):
        return (f"device busy {sum(fams.values()):.2f} ms, K1 "
                f"{fams.get('K1 flash fwd', 0.0):.2f} ms" if fams
                else "device busy not measured")

    print(f"T5-XXL encoder (24 blocks, 64 heads of 64) on (2, 512) tokens, "
          f"bf16: {ms:.2f} ms/call through K1 with bias ({busy_of(busy)}; "
          f"profiler, one call), {plain_ms:.2f} ms/call through plain "
          f"attention ({busy_of(plain_busy)}); block by block on the same "
          f"input the worst attention sub-layer differs by max|err|="
          f"{worst[0]:.3e} of max|output|={worst[1]:.3e} (block {worst[2]}, "
          f"tol 3e-2 of it); "
          f"free-running, the two encoders' outputs differ by rel L2 "
          f"{free:.3e} (not judged); launches {launches}, forms {forms} "
          f"[{card}]", flush=True)
    check(tuple(out.shape) == (2, 512, t5.config.d_model)
          and bool(torch.isfinite(out).all()), "T5 output misshaped")
    check(worst[0] <= 3e-2 * worst[1], f"a T5 attention through K1 disagrees "
          f"with the plain path: {worst[0]} > 3e-2 * {worst[1]} at block "
          f"{worst[2]}")
    check(launches == T5_PER_CALL and forms == {BIASED: 24},
          f"T5 launches {launches} forms {forms}")
    # the same host path in this process, after the SD3 requests: where the
    # T5 call idles, is it K1's launch?
    k1_launch_path(card, "after the SD3 requests, beside T5")
    return launches


# --------------------------------------------------------------------------
# The rest of SD3 serving on the SD3-medium bundle: img2img, batch 2 with
# per-sample seeds decoded tiled and whole, the text entry points, int8 and
# the text-encoder offload; and SD1 in int8.
# --------------------------------------------------------------------------
# img2img at strength 0.6 runs the last 30 of the 50 steps; the VAE encoder
# runs one mid attention over 128 x 128 tokens (K1 at d = 512) and 22
# GroupNorms; the tiled decode's head runs the decoder's mid attention (K1,
# at batch 2) and 5 GroupNorms, its ladder none (XLA code in JAX, plain
# PyTorch here).
SD3_STRENGTH = 0.6
SD3_IMG2IMG_STEPS = SD3_STEPS - int(SD3_STEPS * (1.0 - SD3_STRENGTH))
SD3_ENCODER_GN, SD3_TILED_HEAD_GN = 22, 5
# int8 products a request: 4 in each of the 24 x blocks and 23 context
# blocks and the last context block's qkv, per MMDiT call; 7 in each of
# T5's 24 blocks, two T5 calls (prompt and negative prompt). SD1: 8 in each
# of the UNet's 16 TransformerBlocks a call.
SD3_INT8_MM_PER_REQUEST = ((4 * (2 * SD3_DEPTH - 1) + 1) * SD3_STEPS
                           + 2 * 7 * 24)
SD1_INT8_MM_PER_REQUEST = 16 * 8 * 50
# Image levels, batch-2 sample against its batch-1 request: cuBLAS and
# cuDNN pick their algorithms by batch, which moves bf16 roundings; PERF.md
# section 7 records up to 11 levels (mean 1.2) for SD1 between batch 1 and
# 4. The tiled decode against the whole one differs by the same kind of
# rounding (fp32 statistics summed in another order, convs over strips).
# SD3-medium at 1024^2 / 50 steps is a longer chain over a larger batch
# change (MMDiT batch 2 -> 4): a first run measured sample 0 against its
# batch-1 request at 11 levels, mean 1.27 (PERF.md section 6, PR 14); the
# bound keeps SD1's record for the tiled decode and room above that
# measurement for the batch.
BATCH_LEVELS_MAX, BATCH_LEVELS_MEAN = 16, 2.0
TILED_LEVELS_MAX, TILED_LEVELS_MEAN = 11, 1.2
# int8 against bf16 final latents of one seed (relative L2): a sanity bound
# on a random-weight flow, not a quality claim.
INT8_LATENT_REL_BOUND = 0.5


def sd3_counts(k1, k2, k5_steps):
    return dict(K1=k1, K2=k2, K3=0, K4=0, K5=4 * SD3_DEPTH * k5_steps, K6=0,
                K7=0)


def levels(a, b):
    """(max, mean) absolute difference of two uint8 images, in levels."""
    import numpy as np

    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float(d.mean())


def phase_sd3_img2img(card, source):
    """img2img on the SD3-medium bundle: the warm request's image back in as
    ``init_image`` (scaled to [-1, 1] as the JAX CLI does) at strength 0.6,
    1024^2, the last 30 of 50 flow-Euler steps, CFG 5, shift 3: the VAE
    encoder (K1 at d = 512, K2) in front of the request."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer)

    models = source["models"]
    inf = SD3Inferencer(models, shift=3.0)
    step_events, final_latents = [], []
    hooks = request_hooks(models, step_events, final_latents)
    init = source["image"].astype(np.float32) / 255.0 * 2.0 - 1.0
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    images = inf.gen_image(np.zeros((1, 77), np.int32), steps=SD3_STEPS,
                           cfg_scale=5.0, seed=source["seed"],
                           init_image=init, denoise_strength=SD3_STRENGTH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = read_counts()
    for h in hooks:
        h.remove()
    got = {k: launches[k] for k in SD3_PER_REQUEST}
    want = sd3_counts(2, SD3_ENCODER_GN + 30, SD3_IMG2IMG_STEPS)
    moved = levels(images, source["image"])
    print(f"SD3 img2img (1024^2, strength {SD3_STRENGTH}, {len(step_events)}"
          f" of {SD3_STEPS} steps, seed {source['seed']}): {secs:.3f} "
          f"s/image, {step_ms(step_events):.2f} ms/denoise step, launches "
          f"{got}, K1 {launches.k1_routes} {launches.k1_head_dims}, K5 "
          f"{launches.k5_routes}; against the init image max "
          f"{moved[0]} mean {moved[1]:.2f} levels [{card}]", flush=True)
    check(images.shape == (1, 1024, 1024, 3) and float(images.std()) > 0,
          "SD3 img2img image misshaped or constant")
    check(len(final_latents) == 1
          and bool(torch.isfinite(final_latents[0]).all()),
          "SD3 img2img final latents not finite")
    check(len(step_events) == SD3_IMG2IMG_STEPS,
          f"SD3 img2img: {len(step_events)} MMDiT calls")
    check(got == want, f"SD3 img2img launches {got} != {want}")
    check(launches.k1_routes == {"d512": 2},
          f"SD3 img2img K1 routes {launches.k1_routes}")
    return launches


def phase_sd3_tiled(card, source):
    """Batch 2 with ``per_sample_seeds=[warm seed, None]`` through
    ``SD3Inferencer(decode_mode="tiled")``, its final latents decoded tiled
    again and whole (each timed, with its peak memory above the resident
    bundle): the tiled image against the whole one; sample 0's starting
    noise against the warm request's, bit for bit; sample 0's whole image
    against the warm request's image."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer)

    models = source["models"]
    inf = SD3Inferencer(models, shift=3.0, decode_mode="tiled")
    step_events, final_latents, first_inputs = [], [], []
    hooks = request_hooks(models, step_events, final_latents, first_inputs)
    captured = []
    decode = inf.vae_decode

    def keep_latents(latent, mode=None):
        captured.append(latent.clone())
        return decode(latent, mode)

    inf.vae_decode = keep_latents
    seeds = [source["seed"], None]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    tiled = inf.gen_image(np.zeros((2, 77), np.int32), steps=SD3_STEPS,
                          cfg_scale=5.0, seed=source["seed"],
                          per_sample_seeds=seeds)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    request_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_request = read_counts()
    latent = captured[0]

    def timed(mode):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        img = decode(latent, mode)
        torch.cuda.synchronize()
        return (img, time.perf_counter() - t,
                (torch.cuda.max_memory_allocated() - base) / 2 ** 30)

    again, tiled_s, tiled_peak = timed("tiled")
    whole, whole_s, whole_peak = timed("whole")
    launches = read_counts()
    for h in hooks:
        h.remove()
    req = {k: n_request[k] for k in SD3_PER_REQUEST}
    got = {k: launches[k] for k in SD3_PER_REQUEST}
    want_req = sd3_counts(1, SD3_TILED_HEAD_GN, SD3_STEPS)
    want = sd3_counts(1 + 1 + 2, 2 * SD3_TILED_HEAD_GN + 60, SD3_STEPS)
    tw = levels(tiled, whole)
    bw = levels(whole[:1], source["image"])
    same_noise = bool(torch.equal(first_inputs[0][:1], source["noise"][:1]))
    print(f"SD3 batch 2 (per_sample_seeds {seeds}, decode tiled): "
          f"{secs:.3f} s for 2 images, {secs / 2:.3f} s/image, "
          f"{step_ms(step_events):.2f} ms/denoise step (MMDiT batch 4), peak "
          f"{request_peak:.2f} GiB; decode of the two final latents: tiled "
          f"{tiled_s:.3f} s (peak {tiled_peak:.2f} GiB above the resident "
          f"state), whole {whole_s:.3f} s (peak {whole_peak:.2f} GiB); tiled "
          f"against whole: max {tw[0]} mean {tw[1]:.4f} levels (bound "
          f"{TILED_LEVELS_MAX} / {TILED_LEVELS_MEAN}); sample 0 against the "
          f"batch-1 warm request: starting noise bit-identical {same_noise},"
          f" image max {bw[0]} mean {bw[1]:.4f} levels (bound "
          f"{BATCH_LEVELS_MAX} / {BATCH_LEVELS_MEAN}); launches request "
          f"{req}, with both decodes {got}, K1 {launches.k1_routes} "
          f"[{card}]", flush=True)
    check(tiled.shape == (2, 1024, 1024, 3) and float(tiled.std()) > 0,
          "SD3 tiled images misshaped or constant")
    check(bool(torch.isfinite(latent).all()) and latent.shape
          == (2, 128, 128, 16), "SD3 batch-2 final latents")
    check(len(step_events) == SD3_STEPS,
          f"SD3 batch 2: {len(step_events)} MMDiT calls")
    check(np.array_equal(again, tiled), "the tiled decode is not repeatable")
    check(tw[0] <= TILED_LEVELS_MAX and tw[1] <= TILED_LEVELS_MEAN,
          f"tiled decode against whole: {tw}")
    check(same_noise, "sample 0's starting noise differs from its batch-1 "
          "request's")
    check(bw[0] <= BATCH_LEVELS_MAX and bw[1] <= BATCH_LEVELS_MEAN,
          f"sample 0 against its batch-1 request: {bw}")
    check(req == want_req and got == want,
          f"SD3 batch-2 launches {req} / {got} != {want_req} / {want}")
    check(launches.k1_routes == {"d512": want["K1"]},
          f"SD3 batch-2 K1 routes {launches.k1_routes}")
    return launches


def phase_sd3_text(card, source):
    """The text entry points with a synthetic CLIP vocabulary and a
    synthetic SentencePiece model written by the port's
    ``build_spm_model``: ``gen_image_text`` against ``gen_image`` on the
    tokenizer's ids (0 values may differ), then a ``(word:1.3)`` prompt with
    ``prompt_weighting=True``; 1024^2, 50 steps, the warm seed."""
    import os
    import tempfile

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io import spm_tokenizer as S
    from from_ddpm_to_stable_diffusion_tpu_torch.io.tokenizer import (
        CLIPTokenizer, build_simple_vocab)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer)

    pieces = ([("<pad>", 0.0, S.CONTROL), ("</s>", 0.0, S.CONTROL),
               ("<unk>", 0.0, S.UNKNOWN), ("▁", -3.0, S.NORMAL)]
              + [("▁" + w, -1.0 - 0.1 * i, S.NORMAL)
                 for i, w in enumerate(SLICE_WORDS)]
              + [(c, -5.0, S.NORMAL) for c in "abcdefghijklmnopqrstuvwxyz"])
    fd, path = tempfile.mkstemp(suffix=".model")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(S.build_spm_model(pieces))
        t5_tok = S.T5XXLTokenizer.from_file(path)
    finally:
        os.remove(path)
    trio = S.SD3Tokenizer(CLIPTokenizer(*build_simple_vocab(SLICE_WORDS)),
                          t5_tok)
    inf = SD3Inferencer(source["models"], shift=3.0, tokenizer=trio)
    prompt = "a watercolor fox riding a horse in the snow"
    weighted = "a (watercolor:1.3) fox riding a [horse] in the snow"
    kw = dict(steps=SD3_STEPS, cfg_scale=5.0, seed=source["seed"])
    ids, neg = inf.tokenize(prompt), inf.tokenize("")
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    text = inf.gen_image_text(prompt, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    by_ids = inf.gen_image(ids[0], t5_tokens=ids[2], neg_clip_tokens=neg[0],
                           neg_t5_tokens=neg[2], clip_g_tokens=ids[1],
                           neg_clip_g_tokens=neg[1], **kw)
    heavy = inf.gen_image_text(weighted, prompt_weighting=True, **kw)
    torch.cuda.synchronize()
    launches = read_counts()
    got = {k: launches[k] for k in SD3_PER_REQUEST}
    want = {k: 3 * n for k, n in SD3_PER_REQUEST.items()}
    same = levels(text, by_ids)
    moved = levels(heavy, text)
    print(f"SD3 text entry (synthetic CLIP vocabulary, synthetic "
          f"SentencePiece model of {len(pieces)} pieces): gen_image_text "
          f"{secs:.3f} s/image; against gen_image on the tokenizer's ids "
          f"{int((text != by_ids).sum())} values differ; the weighted "
          f"prompt against the plain one max {moved[0]} mean {moved[1]:.2f} "
          f"levels; t5 ids {ids[2][0, :12].tolist()}, launches of the 3 "
          f"requests {got} [{card}]", flush=True)
    check(text.shape == (1, 1024, 1024, 3) and float(text.std()) > 0,
          "SD3 text image misshaped or constant")
    check(same == (0, 0.0), f"gen_image_text against gen_image: {same}")
    check(float(heavy.std()) > 0 and moved[0] > 0,
          "the weighted prompt did not move the image")
    check(got == want, f"SD3 text launches {got} != {want}")
    return launches


def int8_exact(what, layers):
    """The int32 accumulators of ``int8_matmul`` on the card against the
    exact product (fp64 of the same int8 operands) for each (rows, layer):
    random int8 activations against the layer's own quantized weight."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import quantize as Q

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for m, layer in layers:
        xq = torch.randint(-127, 128, (m, layer.in_features), generator=gen,
                           device="cuda", dtype=torch.int8)
        acc = Q.int8_matmul(xq, layer.q.t())
        exact = xq.double() @ layer.q.t().double()
        ok = acc.dtype == torch.int32 and torch.equal(acc.double(), exact)
        shapes.append((m, layer.in_features, layer.out_features))
        check(ok, f"{what} int8 accumulators differ from the exact product "
              f"at {shapes[-1]}")
    print(f"{what} int8 accumulators (torch._int_mm) equal to the exact "
          f"product at (M, K, N) {shapes}", flush=True)


def quantized_layers(module):
    """One QuantLinear of ``module`` for each (K, N) it holds."""
    from from_ddpm_to_stable_diffusion_tpu_torch.ops.quantize import (
        QuantLinear)

    found = {}
    for m in module.modules():
        if isinstance(m, QuantLinear):
            found.setdefault((m.in_features, m.out_features), m)
    return found


def quantize_timed(what, quantize, card):
    """Run ``quantize()`` and print the resident GiB before and after and
    the peak during it."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    quantize()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    after = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}: quantize_int8() {secs:.2f} s; resident "
          f"{before / 2 ** 30:.2f} -> {after / 2 ** 30:.2f} GiB, peak during "
          f"the quantization {peak / 2 ** 30:.2f} GiB [{card}]", flush=True)
    check(after < before, f"{what}: quantize_int8 freed nothing")
    return before, after


def phase_sd3_int8(card, source):
    """``SD3Models.quantize_int8()`` on the bundle (the MMDiT's block
    projections and T5's, one linear at a time on the card), the int8
    product's accumulators against the exact product at the MMDiT's and
    T5's operand shapes, then the warm request in int8: s/image, ms/step,
    launches, ``torch._int_mm`` calls, and the final latents against the bf16
    request's."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.models.sd3_vae import (
        SD3LatentFormat)
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import quantize as Q
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer)

    models = source["models"]
    quantize_timed("SD3", models.quantize_int8, card)
    x_rows, ctx_rows, t5_rows = 2 * 4096, 2 * 154, 77
    layers = [(x_rows, m) for m in quantized_layers(models.mmdit).values()]
    layers += [(ctx_rows, m) for m in quantized_layers(models.mmdit).values()]
    for m in quantized_layers(models.t5).values():
        layers += [(t5_rows, m), (5, m)]
    int8_exact("SD3", layers)
    inf = SD3Inferencer(models, shift=3.0)
    step_events, final_latents = [], []
    hooks = request_hooks(models, step_events, final_latents)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    Q.int8_matmul.launches = 0
    t = time.perf_counter()
    images = inf.gen_image(np.zeros((1, 77), np.int32), steps=SD3_STEPS,
                           cfg_scale=5.0, seed=source["seed"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = read_counts()
    int_mm = Q.int8_matmul.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for h in hooks:
        h.remove()
    got = {k: launches[k] for k in SD3_PER_REQUEST}
    rel = rel_l2(SD3LatentFormat.process_in(final_latents[0]),
                 SD3LatentFormat.process_in(source["latents"]))
    print(f"SD3 int8 request seed={source['seed']}: {secs:.3f} s/image "
          f"(bf16 warm {source['ms'] / 1e3:.3f}), "
          f"{step_ms(step_events):.2f} ms/denoise step, peak {peak:.2f} GiB, "
          f"torch._int_mm calls {int_mm}, launches {got}, K5 "
          f"{launches.k5_routes}; final latents against the bf16 request's: "
          f"rel L2 {rel:.4f} (sanity bound {INT8_LATENT_REL_BOUND}) "
          f"[{card}]", flush=True)
    check(images.shape == (1, 1024, 1024, 3) and float(images.std()) > 0,
          "SD3 int8 image misshaped or constant")
    check(len(final_latents) == 1
          and bool(torch.isfinite(final_latents[0]).all()),
          "SD3 int8 final latents not finite")
    check(got == SD3_PER_REQUEST, f"SD3 int8 launches {got}")
    check(int_mm == SD3_INT8_MM_PER_REQUEST,
          f"SD3 int8: {int_mm} torch._int_mm calls, not "
          f"{SD3_INT8_MM_PER_REQUEST}")
    check(rel <= INT8_LATENT_REL_BOUND, f"SD3 int8 latents rel L2 {rel}")
    source["int8_image"] = images
    # where the int8 request's device time goes (after the counted run)
    _, wall_ms, fams, n_kernels, rows = profile_device(
        lambda: inf.gen_image(np.zeros((1, 77), np.int32), steps=SD3_STEPS,
                              cfg_scale=5.0, seed=source["seed"]))
    busy = sum(fams.values()) or float("nan")
    print(f"SD3 int8 profile of one request (torch.profiler, kernel rows "
          f"only): device busy {busy:.1f} ms over {n_kernels} kernels; wall "
          f"under the profiler {wall_ms:.1f} ms, unprofiled {1e3 * secs:.1f} "
          f"ms; device idle share {1.0 - busy / (1e3 * secs):.3f} [{card}]",
          flush=True)
    print_profile(fams, rows, 1, "request")
    return launches


def phase_sd3_offload(card, source):
    """``gen_image(offload_text_encoders=True)`` on the int8 bundle, last:
    its image against the int8 request of the same seed (0 values may
    differ), ``hbm_bytes_live()`` against the text encoders' bytes, and the
    next ``get_cond`` must raise."""
    import itertools

    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer)

    models = source["models"]
    inf = SD3Inferencer(models, shift=3.0)
    text_bytes = sum(t.numel() * t.element_size()
                     for g in ("clip_l", "clip_g", "t5")
                     for t in itertools.chain(
                         getattr(models, g).parameters(),
                         getattr(models, g).buffers()))
    torch.cuda.synchronize()
    live_before = models.hbm_bytes_live()
    reset_counts()
    t = time.perf_counter()
    images = inf.gen_image(np.zeros((1, 77), np.int32), steps=SD3_STEPS,
                           cfg_scale=5.0, seed=source["seed"],
                           offload_text_encoders=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = read_counts()
    live_after = models.hbm_bytes_live()
    diff = int((images != source["int8_image"]).sum())
    try:
        inf.get_cond(np.zeros((1, 77), np.int32))
        raised = ""
    except ValueError as err:
        raised = str(err)
    got = {k: launches[k] for k in SD3_PER_REQUEST}
    drop = live_before - live_after
    print(f"SD3 offload_text_encoders=True (int8 bundle): {secs:.3f} "
          f"s/image; hbm_bytes_live {live_before / 2 ** 30:.2f} -> "
          f"{live_after / 2 ** 30:.2f} GiB, fell by {drop / 2 ** 30:.3f} GiB "
          f"against the text encoders' {text_bytes / 2 ** 30:.3f} GiB; "
          f"against the request without offload {diff} values differ; "
          f"get_cond afterwards raised: {raised!r}; launches {got} "
          f"[{card}]", flush=True)
    check(diff == 0, f"SD3 offload image: {diff} values differ")
    check(drop >= text_bytes - 2 ** 26,
          f"hbm_bytes_live fell by {drop}, not the text encoders' "
          f"{text_bytes}")
    check("freed" in raised, "get_cond after the offload did not raise")
    check(got == SD3_PER_REQUEST, f"SD3 offload launches {got}")
    return launches


def phase_sd1_int8(card, models, image):
    """``SD1Models.quantize_int8()`` on the SD1 bundle (the UNet's attention
    and GEGLU projections), the accumulators against the exact product at
    the UNet's operand shapes, then one request at 512^2, 50 k-LMS steps,
    CFG 7.5, batch 1, seed 1."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import quantize as Q
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SD1Generator)

    quantize_timed("SD1", models.quantize_int8, card)
    layers = [(154 if k == 768 else 2 * 4096, m)
              for (k, _), m in quantized_layers(models.unet).items()]
    int8_exact("SD1", layers)
    sd = SD1Generator(models, sampler="k_lms", n_inference_steps=50,
                      cfg_scale=7.5, height=512, width=512)
    torch.cuda.synchronize()
    reset_counts()
    Q.int8_matmul.launches = 0
    t = time.perf_counter()
    images = sd(["a photograph of an astronaut riding a horse"], seed=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = read_counts()
    int_mm = Q.int8_matmul.launches
    moved = levels(images, image)
    print(f"SD1 int8 request bs=1 seed=1: {secs:.3f} s/image, "
          f"torch._int_mm calls {int_mm}, K1 {launches['K1']} "
          f"{launches.k1_routes}, K2 {launches['K2']}; against the bf16 "
          f"request: max {moved[0]} mean {moved[1]:.2f} levels (not judged) "
          f"[{card}]", flush=True)
    check(images.shape == (1, 512, 512, 3) and float(images.std()) > 0,
          "SD1 int8 image misshaped or constant")
    check(launches["K1"] == K1_PER_REQUEST
          and launches["K2"] == K2_PER_REQUEST,
          f"SD1 int8 launches K1 {launches['K1']} K2 {launches['K2']}")
    check(int_mm == SD1_INT8_MM_PER_REQUEST,
          f"SD1 int8: {int_mm} torch._int_mm calls, not "
          f"{SD1_INT8_MM_PER_REQUEST}")
    return launches


# The fp32 forward (K1 and K5 in fp32) in the device profiles: its kernels,
# and the split pre-pass that writes the TF32 terms of the fp32 forward and
# backward.
F32_FWD, F32_SPLIT = "K1/K5 fp32 flash fwd", "fp32 split pre-pass"


# --------------------------------------------------------------------------
# Checkpoint phase: the resident SD1 and SD3-medium bundles written in the
# reference's published layouts, read back through the port's entry points,
# and a request answered from what was read.
# --------------------------------------------------------------------------
def checkpoint_tensors(module, rules):
    """The tensors of a checkpoint that ``rules`` read into ``module``, in
    the file's layout ({checkpoint key: view of a parameter}): the inverse
    of ``io/weights.py::apply_rules``. Raises if a parameter has no rule."""
    from from_ddpm_to_stable_diffusion_tpu_torch.io import weights as W

    own = module.state_dict()
    out, covered = {}, set()
    for key, flax_path, conv in rules:
        name = W.port_key(flax_path)
        if name not in own:
            continue        # a skip conv the module lacks, a smaller VAE
        covered.add(name)
        # apply_rules gives a kernel the file's layout; a leaf that is not a
        # kernel keeps the Flax one, so t_dense's transpose is undone here
        kernel = flax_path.rsplit("/", 1)[-1] == "kernel"
        out[key] = own[name].t() if conv is W.t_dense and not kernel \
            else own[name]
    if covered != set(own):
        raise ValueError(f"{type(module).__name__}: no rule for "
                         f"{sorted(set(own) - covered)[:4]}")
    return out


def _unfuse(state, fused, parts, conv1x1=False):
    """Split a fused q|k|v projection back into the three the file holds
    (1x1 convs where ``conv1x1``)."""
    for leaf in ("weight", "bias"):
        t = state.pop(f"{fused}.{leaf}", None)
        if t is not None:
            for part, chunk in zip(parts, t.chunk(3)):
                state[f"{part}.{leaf}"] = (chunk[:, :, None, None]
                                           if conv1x1 and leaf == "weight"
                                           else chunk)


def write_sd1_checkpoint(models, root, dtype):
    """``models`` (an ``SD1Models``) as the reference's layout
    ``root/ckpt/{clip,diffusion,encoder,decoder}.pt``, every tensor in
    ``dtype``, the attention projections under the ``*_proj_weight`` /
    ``*_proj_bias`` names that ``make_compatible`` renames. Returns the
    bytes written."""
    import os

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io import weights as W

    os.makedirs(os.path.join(root, "ckpt"))
    nbytes = 0
    for name, module, rules in (
            ("clip", models.clip, W.sd1_clip_rules()),
            ("diffusion", models.unet, W.sd1_unet_rules()),
            ("encoder", models.encoder, W.sd1_vae_encoder_rules()),
            ("decoder", models.decoder, W.sd1_vae_decoder_rules())):
        state = {k.replace("_proj.weight", "_proj_weight")
                  .replace("_proj.bias", "_proj_bias"):
                 v.to(device="cpu", dtype=dtype).contiguous()
                 for k, v in checkpoint_tensors(module, rules).items()}
        path = os.path.join(root, "ckpt", f"{name}.pt")
        torch.save(state, path)
        nbytes += os.path.getsize(path)
    return nbytes


def write_sd3_checkpoints(models, root):
    """``models`` (an ``SD3Models``) as the published files: ``sd3.
    safetensors`` (``model.diffusion_model.*``, ``first_stage_model.
    encoder.*`` and ``first_stage_model.decoder.*`` with the VAE
    attention's 1x1 convs), ``clip_l`` and
    ``clip_g`` (HF ``CLIPTextModel``, q / k / v apart) and, with a T5,
    ``t5xxl`` (HF T5 encoder); each tensor in its own dtype. Returns the
    paths, by name, and the bytes written."""
    import os

    from from_ddpm_to_stable_diffusion_tpu_torch.io import weights as W
    from from_ddpm_to_stable_diffusion_tpu_torch.io import weights_sd3 as W3

    cfg = models.mmdit.config
    mmdit = checkpoint_tensors(models.mmdit, W3.sd3_mmdit_rules(
        cfg.depth, qk_norm=cfg.qk_norm is not None))
    files = {"sd3": {f"model.diffusion_model.{k}": v
                     for k, v in mmdit.items()}}
    for side, module, rules in (
            ("encoder", models.vae_encoder, W3.sd3_vae_encoder_rules()),
            ("decoder", models.vae_decoder, W3.sd3_vae_decoder_rules())):
        if module is None:
            continue
        vae = checkpoint_tensors(module, rules)
        attn = "mid.attn_1"
        _unfuse(vae, f"{attn}.in_proj", [f"{attn}.{x}" for x in "qkv"],
                True)
        for leaf in ("weight", "bias"):
            t = vae.pop(f"{attn}.proj_out_dense.{leaf}")
            vae[f"{attn}.proj_out.{leaf}"] = (t[:, :, None, None]
                                              if leaf == "weight" else t)
        files["sd3"].update({f"first_stage_model.{side}.{k}": v
                             for k, v in vae.items()})
    for name in ("clip_l", "clip_g"):
        module = getattr(models, name)
        n = module.config.num_layers
        state = checkpoint_tensors(module, W3.hf_clip_text_rules(n))
        for i in range(n):
            p = f"text_model.encoder.layers.{i}.self_attn"
            _unfuse(state, f"{p}.in_proj", [f"{p}.{x}_proj" for x in "qkv"])
        files[name] = state
    if models.t5 is not None:
        files["t5xxl"] = checkpoint_tensors(
            models.t5, W3.sd3_t5_rules(models.t5.config.num_layers))
    paths, nbytes = {}, 0
    for name, state in files.items():
        paths[name] = os.path.join(root, f"{name}.safetensors")
        W.save_safetensors_dict(state, paths[name])
        nbytes += os.path.getsize(paths[name])
    return paths, nbytes


class PeakRSS:
    """The largest resident set of this process (``/proc/self/statm``),
    sampled every 10 ms on a thread while the ``with`` block runs."""

    def __enter__(self):
        import os
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.peak = self.start = self.rss()
        self.done = threading.Event()
        self.thread = threading.Thread(target=self.sample, daemon=True)
        self.thread.start()
        return self

    def rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def sample(self):
        while not self.done.wait(0.01):
            self.peak = max(self.peak, self.rss())

    def __exit__(self, *exc):
        self.done.set()
        self.thread.join(timeout=5)
        self.peak = max(self.peak, self.rss())
        return False


def same_parameters(what, pairs):
    """Every state entry of each (loaded, source) module pair equal in
    dtype, shape and bits; returns the number of tensors compared."""
    import torch

    n = 0
    for name, got, want in pairs:
        g, w = got.state_dict(), want.state_dict()
        check(set(g) == set(w), f"{what} {name}: parameter names differ: "
              f"{sorted(set(g) ^ set(w))[:4]}")
        bad = [k for k in set(g) & set(w)
               if g[k].dtype != w[k].dtype or not torch.equal(g[k], w[k])]
        check(not bad, f"{what} {name}: {len(bad)} parameters differ from "
              f"the source bundle's, e.g. {sorted(bad)[:4]}")
        n += len(g)
    return n


def image_levels(what, got, want, card):
    """The loaded bundle's image against the source bundle's: at most one
    level on any pixel."""
    import numpy as np

    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{what}: image against the source bundle's: max diff "
          f"{int(diff.max())} levels, {int((diff > 0).sum())} of "
          f"{diff.size} values differ [{card}]", flush=True)
    check(got.shape == want.shape and int(diff.max()) <= 1,
          f"{what}: image differs from the source bundle's by "
          f"{int(diff.max())} levels")


def phase_checkpoint_sd1(card, models, image):
    """The SD1 bundle written in the reference layout (fp32 .pt files),
    read back by ``SD1Models.from_checkpoint_dir`` (bf16), held to the
    source bit for bit, and the source's first request (batch 1, seed 1,
    512^2, 50 k-LMS steps, CFG 7.5) answered from it."""
    import shutil
    import tempfile

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SD1Generator, SD1Models)

    root = tempfile.mkdtemp(prefix="chip_smoke_sd1_")
    try:
        t = time.perf_counter()
        nbytes = write_sd1_checkpoint(models, root, torch.float32)
        write_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        with PeakRSS() as rss:
            loaded = SD1Models.from_checkpoint_dir(root, "bf16")
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        print(f"checkpoint SD1: wrote {nbytes} bytes (4 fp32 .pt files) in "
              f"{write_s:.2f} s, from_checkpoint_dir (bf16, on the card) "
              f"{load_s:.2f} s, peak host RSS {rss.peak / 2 ** 30:.2f} GiB "
              f"(before {rss.start / 2 ** 30:.2f}) [{card}]", flush=True)
        n = same_parameters("checkpoint SD1", [
            (g, getattr(loaded, g), getattr(models, g))
            for g in ("clip", "unet", "encoder", "decoder")])
        check(all(p.is_cuda for m in (loaded.clip, loaded.unet,
                                      loaded.encoder, loaded.decoder)
                  for p in m.parameters()),
              "checkpoint SD1: the loaded bundle is not on the card")
        sd = SD1Generator(loaded, sampler="k_lms", n_inference_steps=50,
                          cfg_scale=7.5, height=512, width=512)
        reset_counts()
        t = time.perf_counter()
        got = sd(["a photograph of an astronaut riding a horse"], seed=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"checkpoint SD1: {n} tensors bit-identical to the source bundle; "
          f"request bs=1 seed=1 from the loaded bundle {secs:.3f} s, "
          f"launches K1 {launches['K1']} {launches.k1_routes}, K2 "
          f"{launches['K2']} [{card}]", flush=True)
    check(launches["K1"] == K1_PER_REQUEST
          and launches.k1_routes == {"sm90": K1_PER_REQUEST - 1, "d512": 1},
          f"checkpoint SD1: K1 launches {launches['K1']} "
          f"{launches.k1_routes}")
    check(launches["K2"] == K2_PER_REQUEST,
          f"checkpoint SD1: K2 launches {launches['K2']}")
    image_levels("checkpoint SD1", got, image, card)
    return launches


def phase_checkpoint_sd3(card, source):
    """The SD3-medium bundle of the SD3 phase written as the published
    safetensors files (bf16 weights, fp32 norms), the source bundle freed,
    the files read back by ``SD3Models.from_checkpoints`` (its MMDiT config
    sniffed and held to the source's, every parameter to the source's bits
    before the source goes), the warm request (1024^2, 50 flow-Euler
    steps, CFG 5, shift 3, zero tokens, its seed) answered from them, and
    the warm image encoded by the loaded VAE encoder, bit for bit the
    source encoder's latent. The loaded bundle goes on in
    ``source["models"]``."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer, SD3Models)

    models = source.pop("models")
    root = tempfile.mkdtemp(prefix="chip_smoke_sd3_")
    try:
        t = time.perf_counter()
        paths, nbytes = write_sd3_checkpoints(models, root)
        write_s = time.perf_counter() - t
        torch.cuda.synchronize()
        t = time.perf_counter()
        with PeakRSS() as rss:
            loaded = SD3Models.from_checkpoints(
                paths["sd3"], paths["clip_l"], paths["clip_g"],
                paths["t5xxl"], "bf16")
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        print(f"checkpoint SD3: wrote {nbytes} bytes ({len(paths)} "
              f"safetensors files) in {write_s:.2f} s, from_checkpoints "
              f"(bf16, on the card) {load_s:.2f} s, peak host RSS "
              f"{rss.peak / 2 ** 30:.2f} GiB (before "
              f"{rss.start / 2 ** 30:.2f}) [{card}]", flush=True)
        check(loaded.mmdit.config == models.mmdit.config,
              f"checkpoint SD3: sniffed {loaded.mmdit.config} != source "
              f"{models.mmdit.config}")
        groups = ("mmdit", "vae_encoder", "vae_decoder", "clip_l", "clip_g",
                  "t5")
        n = same_parameters("checkpoint SD3", [
            (g, getattr(loaded, g), getattr(models, g)) for g in groups])
        check(all(p.is_cuda for g in groups
                  for p in getattr(loaded, g).parameters()),
              "checkpoint SD3: the loaded bundle is not on the card")
        # the warm image encoded by the source's VAE encoder, one draw of
        # noise, to hold the loaded encoder to
        init = source["image"].astype(np.float32) / 255.0 * 2.0 - 1.0
        enc_noise = torch.randn((1, 128, 128, 16), device="cuda",
                                generator=torch.Generator(
                                    device="cuda").manual_seed(5))
        want_latent = SD3Inferencer(models).vae_encode(init, enc_noise)
        del models
        gc.collect()
        torch.cuda.empty_cache()
        inf = SD3Inferencer(loaded, shift=3.0)
        reset_counts()
        t = time.perf_counter()
        got = inf.gen_image(np.zeros((1, 77), np.int32), width=1024,
                            height=1024, steps=SD3_STEPS, cfg_scale=5.0,
                            seed=source["seed"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        latent = inf.vae_encode(init, enc_noise)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    got_counts = {k: launches[k] for k in SD3_PER_REQUEST}
    want = dict(SD3_PER_REQUEST, K1=SD3_PER_REQUEST["K1"] + 1,
                K2=SD3_PER_REQUEST["K2"] + SD3_ENCODER_GN)
    same_latent = bool(torch.equal(latent, want_latent))
    print(f"checkpoint SD3: {n} tensors bit-identical to the source bundle; "
          f"request seed={source['seed']} from the loaded bundle "
          f"{secs:.3f} s; the warm image encoded by the loaded VAE encoder "
          f"equal to the source encoder's, bit for bit: {same_latent}; "
          f"launches {got_counts}, K5 {launches.k5_routes} [{card}]",
          flush=True)
    check(got_counts == want,
          f"checkpoint SD3: launches {got_counts} != {want}")
    check(same_latent and bool(torch.isfinite(latent).all()),
          "checkpoint SD3: the loaded encoder's latent differs")
    image_levels("checkpoint SD3", got, source["image"], card)
    source["models"] = loaded
    return launches


def _family(name: str) -> str:
    """Kernel family of a CUDA kernel name, for the device profiles."""
    n = name.lower()
    for key, fam in (("flash_fwd_pos", "K5 flash fwd pos"),
                     ("merge_d512", "K1 flash fwd"),
                     ("flash_fwd_f32", F32_FWD),
                     ("merge_f32_d512", F32_FWD),
                     ("split_f32", F32_SPLIT),
                     ("flash_bwd_pos_dq", "K6 flash bwd pos dq"),
                     ("flash_bwd_pos_dkv", "K7 flash bwd pos dk/dv"),
                     ("flash_fwd", "K1 flash fwd"),
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
                     ("xmma", "GEMMs"), ("nvjet", "GEMMs"),
                     ("copy", "copies / casts"),
                     ("cat", "copies / casts"),
                     ("elementwise", "elementwise")):
        if key in n:
            return fam
    return "other"


def profile_device(run):
    """Runs ``run()`` under torch.profiler. Returns its result, the wall
    time in ms, device time in ms by kernel family, the number of kernels,
    and the rows (ms, count, name) of the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, n_kernels, rows = {}, 0, []
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
        rows.append((us / 1e3, e.count, e.key[:90]))
    return result, wall_ms, fams, n_kernels, rows


def device_families(run, want=None):
    """Device ms by kernel family of one ``run()`` under torch.profiler.
    Now and then the profiler records no kernel row of a window (or none of
    family ``want``): up to three windows are profiled, so ``run`` must be
    safe to repeat. Returns {} when none recorded one."""
    fams = {}
    for _ in range(3):
        fams = profile_device(run)[2]
        if fams and (want is None or want in fams):
            break
    return fams


def print_profile(fams, rows, n, unit):
    busy = sum(fams.values())
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:24s} {ms / n:9.3f} ms/{unit} {100 * ms / busy:5.1f} %")
    for ms, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  top: {ms / n:8.3f} ms/{unit} x{count // n:5d}/{unit} {key}")


def profile_steps(trainer, state, batches, card):
    """Device time by kernel family over a few profiled steps; returns the
    state and the device busy time per step (sum of kernel time)."""
    def run():
        st = state
        for images, labels in batches:
            st, _ = trainer.train_step(st, images, labels)
        return st

    state, wall_ms, fams, n_kernels, rows = profile_device(run)
    busy = sum(fams.values())
    n = len(batches)
    print(f"training profile over {n} steps (torch.profiler, kernel rows "
          f"only): device busy {busy / n:.2f} ms/step, {n_kernels // n} "
          f"kernels/step; wall under the profiler {wall_ms / n:.2f} ms/step "
          f"[{card}]", flush=True)
    print_profile(fams, rows, n, "step")
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
    return trainer, state, launches, dict(step_ms=step_ms, host_ms=host_ms,
                                          busy_ms=busy, idle=idle,
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

    def swap_dk_dv(q, k, v, out, lse, g, scale, **masks):
        dq, dk, dv = bwd(q, k, v, out, lse, g, scale, **masks)
        return dq, dv, dk

    def unscaled_dq(q, k, v, out, lse, g, scale, **masks):
        dq, dk, dv = bwd(q, k, v, out, lse, g, scale, **masks)
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
    """CFG ancestral sampling of 4 labels, one batch-8 forward per step,
    with the trained weights under a config whose chain has SAMPLE_T steps."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        DDPMTrainer)

    cfg = dataclasses.replace(trainer.cfg, T=SAMPLE_T)
    sampler = DDPMTrainer(cfg, device="cuda")
    labels = [1, 2, 3, 1]
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    images = sampler.sample(state, labels)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = read_counts()
    s = cfg.img_size
    print(f"sampling: {len(labels)} images, T={cfg.T}, CFG w={cfg.w} (UNet "
          f"batch {2 * len(labels)}): {secs:.3f} s, "
          f"{1e3 * secs / cfg.T:.2f} ms/step, launches {launches} [{card}]",
          flush=True)
    check(tuple(images.shape) == (len(labels), s, s, 3),
          f"samples {tuple(images.shape)}")
    check(bool(torch.isfinite(images).all()) and
          images.abs().max().item() <= 1.0, "samples not finite in [-1, 1]")
    check(float(images.std()) > 0.0, "constant samples")
    check(launches == dict(K1=6 * SAMPLE_T, K2=39 * SAMPLE_T, K3=0, K4=0,
                           K5=0, K6=0, K7=0), f"sampling launches {launches}")
    return launches


# The qkv projections of both streams: where a fault of K6 or K7 lands first.
MMDIT_QKV_LEAVES = re.compile(r"^joint_block\d+\.(context|x)_block\.qkv\.")


def mmdit_batch(batch, img_size, context_len, model_cfg, seed):
    """Normal latents, context and pooled vectors from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    return (f32(batch, img_size, img_size, model_cfg.in_channels),
            f32(batch, context_len, model_cfg.context_dim),
            f32(batch, model_cfg.adm_in_channels))


def phase_mmdit_training(card):
    """``MMDiTTrainer`` at SD3-medium's width and depth, latent 128 (4096 x
    tokens + 154 context tokens), batch 2, bf16 over fp32 parameters."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.models.mmdit import MMDiTConfig
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
        MMDiTTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        FlowTrainConfig)

    model_cfg = MMDiTConfig()
    cfg = FlowTrainConfig(img_size=128, context_len=154, batch_size=2,
                          dtype="bf16")
    check((model_cfg.depth, model_cfg.hidden_size) == (SD3_DEPTH, 1536),
          "MMDiTConfig() is not SD3-medium's")
    warm, timed = 2, 5
    n_steps = warm + timed + 1          # the last one under the profiler
    t0 = time.perf_counter()
    trainer = MMDiTTrainer(model_cfg, cfg, device="cuda")
    state = trainer.create_state(steps_per_epoch=n_steps)
    latents, context, y = (torch.from_numpy(a).cuda() for a in mmdit_batch(
        cfg.batch_size, cfg.img_size, cfg.context_len, model_cfg, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(99)
    fixed = dict(
        t_lin=torch.sigmoid(torch.randn(2, generator=gen, device="cuda")),
        noise=torch.randn(latents.shape, generator=gen, device="cuda"),
        drop=torch.zeros(2, dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 30
    print(f"MMDiT training: {trainer.num_params(state)} params (fp32), batch "
          f"{cfg.batch_size}, latent {cfg.img_size} -> 4096 + "
          f"{cfg.context_len} tokens, bf16 compute, {held:.2f} GiB of fp32 "
          f"weights resident (AdamW makes its moments at step 1); set-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def fixed_loss():
        with torch.no_grad():
            return trainer.loss(state, latents, context, y, **fixed).item()

    loss_before = fixed_loss()
    reset_counts()
    losses = []
    for _ in range(warm):
        state, loss = trainer.train_step(state, latents, context, y)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(timed):
        state, loss = trainer.train_step(state, latents, context, y)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / timed
    step_ms = start.elapsed_time(end) / timed
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def one_step():
        return trainer.train_step(state, latents, context, y)

    (state, loss), wall_ms, fams, n_kernels, rows = profile_device(one_step)
    losses.append(loss)
    launches = read_counts()
    loss_after = fixed_loss()
    busy = sum(fams.values())
    idle = 1.0 - busy / step_ms
    losses = torch.stack(losses).float().cpu()
    print(f"MMDiT training: {timed} timed steps: {step_ms:.2f} ms/step (CUDA "
          f"events; host {host_ms:.2f} ms/step), "
          f"{1e3 * cfg.batch_size / step_ms:.3f} img/s, peak {peak:.2f} GiB, "
          f"losses {[round(v, 4) for v in losses.tolist()]}, the fixed "
          f"batch's loss {loss_before:.5f} before and {loss_after:.5f} after "
          f"{n_steps} steps, launches {launches} over {n_steps} steps "
          f"[{card}]", flush=True)
    print(f"MMDiT training profile of one step (torch.profiler, kernel rows "
          f"only): device busy {busy:.2f} ms over {n_kernels} kernels; wall "
          f"under the profiler {wall_ms:.2f} ms; device idle share "
          f"{idle:.3f} (1 - busy / unprofiled step) [{card}]", flush=True)
    print_profile(fams, rows, 1, "step")
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses}")
    check(loss_after < loss_before, f"the fixed batch's loss did not fall: "
          f"{loss_before} -> {loss_after}")
    params = state.params
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in params.values()), "missing or non-finite gradient")
    for name, per_step in MMDIT_PER_STEP.items():
        check(launches[name] == per_step * n_steps,
              f"{name} launches {launches[name]} != {per_step} x {n_steps}")
    step = dict(step_ms=step_ms, host_ms=host_ms, busy_ms=busy, idle=idle,
                peak_gib=peak)
    for fam in ("K5 flash fwd pos", "K6 flash bwd pos dq",
                "K7 flash bwd pos dk/dv"):
        step[fam.split()[0] + " device ms"] = fams.get(fam)
    return trainer, state, launches, step


def phase_mmdit_grad_check(card):
    """Loss and gradient of a depth-2 MMDiT (hidden 128, 2 heads of 64) at
    latent 46 (529 x tokens, ragged against the 64-row tiles) + 154 context
    tokens, batch 2: card (bf16 compute, K5 / K6 / K7) against CPU (fp32,
    plain versions), as the whole flattened gradient and the qkv leaves of
    both streams; then the same check on a planted fault of the joint
    backward (dk and dv swapped), which it must catch."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.models.mmdit import MMDiTConfig
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        TrainState)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
        MMDiTTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        flax_default_init_)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        FlowTrainConfig)

    model_cfg = MMDiTConfig(depth=2, adm_in_channels=64, context_dim=128,
                            pos_embed_max_size=32)
    cfg = FlowTrainConfig(img_size=46, context_len=154, batch_size=2,
                          dtype="bf16")
    on_card = MMDiTTrainer(model_cfg, cfg, device="cuda")
    on_cpu = MMDiTTrainer(model_cfg, dataclasses.replace(cfg, dtype="fp32"),
                          device="cpu")
    card_model = flax_default_init_(on_card.make_model(),
                                    torch.Generator("cuda").manual_seed(7))
    cpu_model = on_cpu.make_model()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               card_model.state_dict().items()})
    latents, context, y = mmdit_batch(2, cfg.img_size, cfg.context_len,
                                      model_cfg, seed=7)
    gen = torch.Generator().manual_seed(7)
    draws = dict(t_lin=torch.sigmoid(torch.randn(2, generator=gen)),
                 noise=torch.randn(latents.shape, generator=gen),
                 drop=torch.zeros(2, dtype=torch.bool))

    def loss_and_grads(trainer, model):
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = trainer.loss(TrainState(model.train(), None, None), latents,
                            context, y, **draws)
        loss.backward()
        grads = {n: p.grad.float().flatten().cpu()
                 for n, p in model.named_parameters()}
        return loss.item(), grads, time.perf_counter() - t0

    l_cpu, g_cpu, s_cpu = loss_and_grads(on_cpu, cpu_model)
    qkv = [n for n in g_cpu if MMDIT_QKV_LEAVES.search(n)]
    check(len(qkv) == 8, f"qkv leaves {qkv}")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()

    def errors(g_card):
        whole = rel(torch.cat(list(g_card.values())),
                    torch.cat(list(g_cpu.values())))
        leaves = {n: rel(g_card[n], g_cpu[n]) for n in g_cpu
                  if g_cpu[n].norm() > 0}
        return whole, leaves, max(qkv, key=leaves.get)

    def passes(whole, leaves, loss_rel):
        return (whole <= GRAD_REL_TOL and loss_rel <= GRAD_REL_TOL
                and all(leaves[n] <= GRAD_REL_TOL for n in qkv))

    n0 = read_counts()
    l_card, g_card, s_card = loss_and_grads(on_card, card_model)
    n1 = read_counts()
    got = {k: n1[k] - n0[k] for k in ("K5", "K6", "K7")}
    check(got == dict(K5=8, K6=8, K7=8),
          f"the small MMDiT launched {got}, not 4 per block of each")
    whole, leaves, worst_qkv = errors(g_card)
    worst = max(leaves, key=leaves.get)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    print(f"MMDiT gradient check (depth 2, 529 + 154 tokens, batch 2): loss "
          f"card {l_card:.6f} cpu {l_cpu:.6f} (rel {loss_rel:.3e}); flattened "
          f"gradient ({sum(g.numel() for g in g_cpu.values())} values) rel L2 "
          f"err {whole:.3e}; worst qkv leaf ({len(qkv)} leaves) {worst_qkv} "
          f"{leaves[worst_qkv]:.3e}; worst leaf of all {worst} "
          f"{leaves[worst]:.3e} (reported only); tol {GRAD_REL_TOL} on the "
          f"whole, the loss and each qkv leaf; card {s_card:.2f} s, cpu fp32 "
          f"{s_cpu:.2f} s", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in g_card.values()),
          "non-finite card gradient")
    check(passes(whole, leaves, loss_rel),
          f"card gradient off the CPU's: whole {whole}, loss rel {loss_rel}, "
          f"qkv leaf {worst_qkv} {leaves[worst_qkv]}")

    # Control: the same check must fail on a planted fault of the backward.
    bwd = fa.flash_bwd_pos

    def swap_dk_dv(*args, **kw):
        dq, dk, dv = bwd(*args, **kw)
        return dq, dv, dk

    fa.flash_bwd_pos = swap_dk_dv
    try:
        l_bad, g_bad, _ = loss_and_grads(on_card, card_model)
    finally:
        fa.flash_bwd_pos = bwd
    whole_b, leaves_b, worst_b = errors(g_bad)
    caught = not passes(whole_b, leaves_b, abs(l_bad - l_cpu) / abs(l_cpu))
    print(f"MMDiT gradient check control (dk/dv swapped in the joint "
          f"backward): whole {whole_b:.3e} "
          f"({'above' if whole_b > GRAD_REL_TOL else 'within'} tol), worst "
          f"qkv leaf {worst_b} {leaves_b[worst_b]:.3e}: "
          f"{'caught' if caught else 'MISSED'}", flush=True)
    check(caught, "the MMDiT gradient check missed the planted fault")
    return whole


def phase_mmdit_sampling(card, trainer, state):
    """``MMDiTTrainer.sample`` of 2 latents from the trained state: CFG as
    one batch-4 forward per flow-Euler step."""
    import torch

    cfg = trainer.cfg
    _, context, y = mmdit_batch(2, cfg.img_size, cfg.context_len,
                                trainer.model_cfg, seed=1)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    latents = trainer.sample(state, context, y, steps=MMDIT_SAMPLE_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = read_counts()
    print(f"MMDiT sampling: 2 latents, {MMDIT_SAMPLE_STEPS} flow-Euler steps, "
          f"CFG w={cfg.w} (MMDiT batch 4): {secs:.3f} s, "
          f"{1e3 * secs / MMDIT_SAMPLE_STEPS:.2f} ms/step, launches "
          f"{launches} [{card}]", flush=True)
    s_ = cfg.img_size
    check(tuple(latents.shape) == (2, s_, s_, 16), f"{tuple(latents.shape)}")
    check(bool(torch.isfinite(latents).all()), "sampled latents not finite")
    check(float(latents.std()) > 0.0, "constant sampled latents")
    want = dict.fromkeys(launches, 0)
    want["K5"] = MMDIT_PER_STEP["K5"] * MMDIT_SAMPLE_STEPS
    check(launches == want, f"MMDiT sampling launches {launches} != {want}")
    return launches


VLM_VOCAB_SIZE = 20
# The qkv projections of the tower and the decoder: where a fault of K3 or
# K4 (no-mask and causal form) lands first.
VLM_QKV_LEAVES = re.compile(r"^(vision\.layer|block)\d+\.attn\.qkv\.")


def vlm_trainer(device, dtype, layers, **kw):
    """``VLMTrainer`` with the SigLIP-base tower and a decoder of width 768,
    both cut to ``layers`` layers."""
    from from_ddpm_to_stable_diffusion_tpu_torch.models.siglip import (
        SiglipVisionConfig)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vlm_trainer import (
        VLMTrainer)

    if dtype is not None:       # None: the trainer's own default
        kw["dtype"] = dtype
    return VLMTrainer(VLM_VOCAB_SIZE, dim=768, depth=layers, num_heads=12,
                      max_text_len=8, device=device,
                      vision_cfg=SiglipVisionConfig(num_hidden_layers=layers),
                      **kw)


def vlm_batch(dataset, start, n):
    import numpy as np

    images, tokens = zip(*(dataset.load(i) for i in range(start, start + n)))
    return np.stack(images), np.stack(tokens)


def phase_vlm_training(card):
    """``VLMTrainer`` at SigLIP-base width and depth on 384^2 captioned
    shapes: 576 patch tokens in the tower, 584 causal tokens in the decoder,
    batch 16, bf16 over fp32 parameters."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.shapes_dataset import (
        VLM_VOCAB, CaptionedShapesDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.siglip import (
        SiglipVisionConfig)

    check(len(VLM_VOCAB) == VLM_VOCAB_SIZE and SiglipVisionConfig()
          == SiglipVisionConfig(768, 3072, 12, 12, 3, 224, 16, 1e-6),
          "the vocabulary or SiglipVisionConfig() is not the expected one")
    batch, warm, timed = 16, 2, 5
    n_steps = warm + timed + 1          # the last one under the profiler
    t0 = time.perf_counter()
    trainer = vlm_trainer("cuda", "bf16", VLM_LAYERS, warmup_steps=2,
                          total_steps=1000)
    state = trainer.create_state(384)
    data = CaptionedShapesDataset(batch * n_steps, img_size=384, seed=0)
    batches = [tuple(torch.from_numpy(a).cuda()
                     for a in vlm_batch(data, i * batch, batch))
               for i in range(n_steps)]
    fixed = batches[0]
    torch.cuda.synchronize()
    print(f"TinyVLM training: {trainer.num_params(state)} params (fp32), "
          f"SigLIP-base tower on 384^2 images (576 patch tokens), decoder "
          f"width 768 depth {VLM_LAYERS} over 576 + 8 tokens, batch {batch}, "
          f"bf16 compute; set-up {time.perf_counter() - t0:.2f} s",
          flush=True)

    def fixed_loss():
        with torch.no_grad():
            return trainer.loss(state, *fixed).item()

    loss_before = fixed_loss()
    reset_counts()
    losses = []
    for images, tokens in batches[:warm]:
        state, loss = trainer.train_step(state, images, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for images, tokens in batches[warm:warm + timed]:
        state, loss = trainer.train_step(state, images, tokens)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / timed
    step_ms = start.elapsed_time(end) / timed
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (state, loss), wall_ms, fams, n_kernels, rows = profile_device(
        lambda: trainer.train_step(state, *batches[-1]))
    losses.append(loss)
    launches = read_counts()
    forms = {k: dict(fn.forms) for k, fn in kernel_counters().items()
             if k in ("K1", "K3", "K4")}
    loss_after = fixed_loss()
    busy = sum(fams.values())
    idle = 1.0 - busy / step_ms
    losses = torch.stack(losses).float().cpu()
    print(f"TinyVLM training: {timed} timed steps: {step_ms:.2f} ms/step "
          f"(CUDA events; host {host_ms:.2f} ms/step), "
          f"{1e3 * batch / step_ms:.2f} img/s, peak {peak:.2f} GiB, losses "
          f"{[round(v, 4) for v in losses.tolist()]}, the fixed batch's loss "
          f"{loss_before:.5f} before and {loss_after:.5f} after {n_steps} "
          f"steps (the first at lr 0), launches {launches} over {n_steps} "
          f"steps, by form (causal, bias, segments) {forms} [{card}]",
          flush=True)
    print(f"TinyVLM training profile of one step (torch.profiler, kernel "
          f"rows only): device busy {busy:.2f} ms over {n_kernels} kernels; "
          f"wall under the profiler {wall_ms:.2f} ms; device idle share "
          f"{idle:.3f} (1 - busy / unprofiled step) [{card}]", flush=True)
    print_profile(fams, rows, 1, "step")
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses}")
    check(loss_after < loss_before, f"the fixed batch's loss did not fall: "
          f"{loss_before} -> {loss_after}")
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in state.params.values()),
          "missing or non-finite gradient")
    for name, per_step in VLM_PER_STEP.items():
        check(launches[name] == per_step * n_steps,
              f"{name} launches {launches[name]} != {per_step} x {n_steps}")
    half = {NO_MASK: VLM_LAYERS * n_steps, CAUSAL: VLM_LAYERS * n_steps}
    check(all(f == half for f in forms.values()),
          f"forms {forms}: not {VLM_LAYERS} no-mask and {VLM_LAYERS} causal "
          f"launches per step of each kernel")
    return trainer, state, launches, dict(step_ms=step_ms, host_ms=host_ms,
                                          busy_ms=busy, idle=idle,
                                          peak_gib=peak)


def phase_vlm_grad_check(card):
    """Loss and gradient of a TinyVLM of 2 tower layers and 2 decoder blocks
    at the full widths and lengths (576 and 584 tokens, 12 heads of 64),
    batch 4: card (bf16 compute, K1 / K3 / K4 without a mask and causal)
    against CPU (fp32, plain versions), as the whole flattened gradient and
    the qkv leaves; then the same check on a planted fault of the flash
    backward (dk and dv swapped), which it must catch."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.shapes_dataset import (
        CaptionedShapesDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        TrainState)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        flax_default_init_)

    on_card = vlm_trainer("cuda", "bf16", 2)
    on_cpu = vlm_trainer("cpu", "fp32", 2)
    card_model = flax_default_init_(on_card.make_model(384),
                                    torch.Generator("cuda").manual_seed(7))
    cpu_model = on_cpu.make_model(384)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               card_model.state_dict().items()})
    images, tokens = vlm_batch(CaptionedShapesDataset(4, 384, seed=7), 0, 4)

    def loss_and_grads(trainer, model):
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = trainer.loss(TrainState(model.train(), None, None), images,
                            tokens)
        loss.backward()
        grads = {n: p.grad.float().flatten().cpu()
                 for n, p in model.named_parameters()}
        return loss.item(), grads, time.perf_counter() - t0

    l_cpu, g_cpu, s_cpu = loss_and_grads(on_cpu, cpu_model)
    qkv = [n for n in g_cpu if VLM_QKV_LEAVES.search(n)]
    check(len(qkv) == 8, f"qkv leaves {qkv}")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()

    def errors(g_card):
        whole = rel(torch.cat(list(g_card.values())),
                    torch.cat(list(g_cpu.values())))
        leaves = {n: rel(g_card[n], g_cpu[n]) for n in g_cpu
                  if g_cpu[n].norm() > 0}
        return whole, leaves, max(qkv, key=leaves.get)

    def passes(whole, leaves, loss_rel):
        return (whole <= GRAD_REL_TOL and loss_rel <= GRAD_REL_TOL
                and all(leaves[n] <= GRAD_REL_TOL for n in qkv))

    n0 = read_counts()
    l_card, g_card, s_card = loss_and_grads(on_card, card_model)
    n1 = read_counts()
    got = {k: n1[k] - n0[k] for k in ("K1", "K3", "K4")}
    check(got == dict(K1=4, K3=4, K4=4),
          f"the small TinyVLM launched {got}, not one per layer of each")
    whole, leaves, worst_qkv = errors(g_card)
    worst = max(leaves, key=leaves.get)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    print(f"TinyVLM gradient check (2 + 2 layers, 576 and 584 tokens, batch "
          f"4): loss card {l_card:.6f} cpu {l_cpu:.6f} (rel {loss_rel:.3e}); "
          f"flattened gradient ({sum(g.numel() for g in g_cpu.values())} "
          f"values) rel L2 err {whole:.3e}; worst qkv leaf ({len(qkv)} "
          f"leaves) {worst_qkv} {leaves[worst_qkv]:.3e}; worst leaf of all "
          f"{worst} {leaves[worst]:.3e} (reported only); tol {GRAD_REL_TOL} "
          f"on the whole, the loss and each qkv leaf; card {s_card:.2f} s, "
          f"cpu fp32 {s_cpu:.2f} s", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in g_card.values()),
          "non-finite card gradient")
    check(passes(whole, leaves, loss_rel),
          f"card gradient off the CPU's: whole {whole}, loss rel {loss_rel}, "
          f"qkv leaf {worst_qkv} {leaves[worst_qkv]}")

    bwd = fa.flash_attention_bwd_cuda

    def swap_dk_dv(*args, **kw):
        dq, dk, dv = bwd(*args, **kw)
        return dq, dv, dk

    fa.flash_attention_bwd_cuda = swap_dk_dv
    try:
        l_bad, g_bad, _ = loss_and_grads(on_card, card_model)
    finally:
        fa.flash_attention_bwd_cuda = bwd
    whole_b, leaves_b, worst_b = errors(g_bad)
    caught = not passes(whole_b, leaves_b, abs(l_bad - l_cpu) / abs(l_cpu))
    print(f"TinyVLM gradient check control (dk/dv swapped): whole "
          f"{whole_b:.3e} ({'above' if whole_b > GRAD_REL_TOL else 'within'} "
          f"tol), worst qkv leaf {worst_b} {leaves_b[worst_b]:.3e}: "
          f"{'caught' if caught else 'MISSED'}", flush=True)
    check(caught, "the TinyVLM gradient check missed the planted fault")
    return whole


def phase_vlm_decoding(card, trainer, state):
    """``caption_accuracy`` on 8 held-out images through ``greedy_decode``:
    7 fixed-shape forwards of batch 8. The accuracy is printed, not judged:
    the model has taken a handful of steps."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.shapes_dataset import (
        CaptionedShapesDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.tiny_vlm import (
        greedy_decode)

    held_out = CaptionedShapesDataset(8, img_size=384, seed=1)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    accuracy = trainer.caption_accuracy(state, held_out, n=8, batch_size=8)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches = read_counts()
    forms = dict(kernel_counters()["K1"].forms)
    images, captions = vlm_batch(held_out, 0, 8)
    tokens = greedy_decode(state.model, images)
    shown = [held_out.decode(row) for row in tokens.cpu().numpy()[:2]]
    print(f"TinyVLM decoding: caption_accuracy on 8 held-out images "
          f"{accuracy:.3f} (not judged), {secs:.3f} s for "
          f"{VLM_DECODE_FORWARDS} forwards of batch 8 "
          f"({1e3 * secs / VLM_DECODE_FORWARDS:.2f} ms/forward, data made on "
          f"the host included); first decodes {shown} for "
          f"{[held_out.decode(c) for c in captions[:2]]}; launches "
          f"{launches}, forms {forms} [{card}]", flush=True)
    check(0.0 <= accuracy <= 1.0 and tuple(tokens.shape) == (8, 8)
          and bool((tokens[:, 0] == 1).all())
          and int(tokens.max()) < VLM_VOCAB_SIZE, "decoded tokens misshaped")
    want = dict.fromkeys(launches, 0)
    want["K1"] = VLM_PER_STEP["K1"] * VLM_DECODE_FORWARDS
    n = VLM_LAYERS * VLM_DECODE_FORWARDS
    check(launches == want and forms == {NO_MASK: n, CAUSAL: n},
          f"TinyVLM decoding launches {launches} != {want}, forms {forms}")
    return launches


# --------------------------------------------------------------------------
# The fp32 forms of the flash kernels
# --------------------------------------------------------------------------
FP32_ROUTE = "TF32 wgmma, three-term split"   # every fp32 flash kernel
FP32_FWD_DESIGN = (
    "a pre-pass splits q, k and v (transposed, keys permuted within groups "
    "of 8) into TF32 hi / lo terms; then K1's design in TF32: a producer "
    "issuing TMA (Q hi / lo once, K and V^T hi / lo tiles on rings of their "
    "own), two consumers of 64 query rows (one at d = 160, 64-query blocks) "
    "running S = QK^T and O += PV as three wgmma m64nNk8 TF32 passes each (lo "
    "hi + hi lo + hi hi), the softmax in fp32 registers and P split in "
    "registers as the RS A operand; T5's bias staged by the producer's 128 "
    "threads (cp.async) and added after the product; at d = 512 Q, K and V^T "
    "stream through three 64 KB slots, two consumers split S by keys and own "
    "256 output columns each, P hi / lo through shared memory, key splits "
    "merged by lse below 132 query tiles")
FP32_BWD_DESIGN = (
    "a pre-pass splits q, k, v and dO into TF32 hi / lo rows and k^T (for "
    "dq) or q^T and dO^T (for dk/dv) into transposed terms, the sequence "
    "permuted within groups of 8; dq: one block per 64 queries per consumer "
    "warpgroup (two at d = 64), Q and dO resident, K / V and K^T tiles of 32 "
    "keys on rings of their own, S and dP as three SS TF32 wgmma passes, P "
    "and dS in fp32 registers split into the RS A operand of dQ += dS K; "
    "dk/dv: one block per 64 keys per consumer (keys as M), K and V "
    "resident, Q / dO rows (two stages) and Q^T / dO^T (one) in tiles of 32 "
    "or 16 queries, S^T and dP^T SS, dV += P^T dO and dK += dS^T Q RS over "
    "64-column chunks; every tile's product into a fresh accumulator added "
    "in registers")
# K1 in fp32 at the shapes the fp32 defaults give it, (B, H, Lq, Lk, D),
# causal, with the backward; compare_revisions.py times them too.
FP32_CASES = [
    ((2, 8, 4096, 4096, 40), False, False),      # SD1 UNet at 64^2
    ((2, 8, 1024, 1024, 80), False, False),      # SD1 UNet at 32^2
    ((1, 1, 4096, 4096, 512), False, False),     # SD1 VAE mid attention
    ((1, 1, 16384, 16384, 512), False, False),   # SD3 VAE mid attention
    ((16, 12, 576, 576, 64), False, True),       # SigLIP tower
    ((16, 12, 584, 584, 64), True, True),        # TinyVLM decoder
    ((32, 1, 4096, 4096, 128), False, True),     # tiny-SD UNet at 64^2
]
# K1's fp32 forms beside them: d = 160 (K1_D160_SHAPE) and T5's bias
FP32_T5_SHAPE = (2, 64, 512, 512, 64)
# out and lse absolute, each gradient relative to its largest magnitude; the
# plain version fed operands rounded once to bf16 must fall outside it, and
# the kernel must stay ten times closer to the plain version than that fault.
# The forward (TF32 split) is held so against a second fault too: operands
# truncated once to TF32, what a single-pass kernel would compute. Its error
# against fp64 plain attention is reported and held to FP32_FP64_TOL: the
# split keeps ~2^-22 of each product, fp32 itself ~2^-24 per rounding.
FP32_TOL = 1e-4
FP32_FP64_TOL = 1e-5
# A whole fp32 request or train step through the fp32 kernels against the
# same through plain attention: relative L2 of the final latents, relative
# error of each loss, relative L2 of the last step's gradient. The two
# differ by fp32 summation order in every attention (~1e-6 each), carried
# through the network; an attention that rounded an operand to bf16 once
# would show ~1e-2.
E2E_FP32_TOL = 1e-4


def fp32_bound(b, h, lq, lk, d, n_products, n_q_like, n_k_like, n_stats,
               share=1.0, peak=PEAK_FP32_FLOPS, passes=1):
    """Attention-shaped work on fp32 tensors at ``peak``: ``n_products``
    products over the ``share`` of the Lq x Lk pairs the mask admits, each
    done in ``passes`` passes, (Lq, d) and (Lk, d) fp32 tensors and fp32 row
    statistics moved once. The backward's route is fp32 FMAs on the CUDA
    cores (67 TFLOP/s, one pass); the forward's the tensor cores, three
    TF32 passes at 495 TFLOP/s (:func:`tf32_bound`)."""
    flops = 2.0 * n_products * share * b * h * lq * lk * d
    nbytes = b * h * (4.0 * d * (n_q_like * lq + n_k_like * lk)
                      + 4.0 * n_stats * lq)
    return dict(zip(("bound_ms", "bound_by"),
                    bound(passes * flops, nbytes, peak)))


def tf32_bound(b, h, lq, lk, d, share=1.0, n_products=2, n_q_like=2,
               n_k_like=2, n_stats=1):
    """The bound of an fp32 flash kernel on the tensor cores: its products
    (two for the forward, three for dq, four for dk/dv) in TF32_PASSES passes
    at the dense TF32 rate, with the bytes floor, and beside it
    (``fma_bound_ms``) the same work in fp32 FMAs at 67 TFLOP/s, for
    comparison."""
    shape = (b, h, lq, lk, d, n_products, n_q_like, n_k_like, n_stats, share)
    return dict(**fp32_bound(*shape, peak=PEAK_TF32_FLOPS,
                             passes=TF32_PASSES),
                bound_basis=f"{TF32_PASSES} TF32 passes at 495 TFLOP/s",
                fma_bound_ms=fp32_bound(*shape)["bound_ms"])


def phase_kernels_fp32(card, tail):
    """Each fp32 form against its plain fp32 version (TF32 off) at the shape
    its path gives it, with the two planted single-rounding faults (bf16,
    one TF32 pass), the error against fp64 (out and lse absolute, each
    gradient of its largest magnitude), the times, device times and the
    bound. Returns kernel name -> list of records."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as attn
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    rounded = lambda *xs: [x.bfloat16().float() for x in xs]
    # one TF32 pass: each operand cut to its top 19 bits, the rest exact
    tf32 = lambda *xs: [(x.contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32) for x in xs]
    f64 = lambda *xs: [x.double() for x in xs]
    sdpa = F.scaled_dot_product_attention
    records = {k: [] for k in ("K1", "K3", "K4", "K5", "K6", "K7")}

    def judge(name, what, err, fault, scale=1.0):
        """The kernel inside the tolerance, the fault outside it, and ten
        times between them."""
        tol = FP32_TOL * scale
        ok = err <= tol and fault > tol and 10.0 * err <= fault
        check(ok, f"{name} fp32 {what}: err {err:.3e}, planted fault "
                  f"{fault:.3e}, tol {tol:.3e}")
        return f"{err:.3e} (fault {fault:.3e}, tol {tol:.3e})"

    def forward_errors(label, out, lse, plain, faulted):
        """The kernel's out / lse errors against plain fp32 and fp64
        attention (``plain``, ``faulted(f)``: the plain forward on the
        operands mapped by f), and the two planted faults' out errors. lse
        is compared on the rows that see a key; the others must hold out = 0
        and lse = -1e30."""
        ref, ref_lse = plain()
        seen = ref_lse > -1e29
        if not bool(seen.all()):
            check(bool((lse[~seen] <= -1e29).all())
                  and not bool(out[~seen].any()),
                  f"{label}: a row that sees no key has out != 0 or lse "
                  f"above -1e29")
        errs = dict(err=(out - ref).abs().max().item(),
                    lse_err=(lse - ref_lse)[seen].abs().max().item())
        for name, f in (("fault_err", rounded), ("tf32_fault_err", tf32)):
            bad, _ = faulted(f)
            errs[name] = (bad - ref).abs().max().item()
            del bad
        del ref, ref_lse
        r64, l64 = faulted(f64)
        errs["fp64_err"] = max((out.double() - r64).abs().max().item(),
                               (lse.double() - l64)[seen].abs().max().item())
        del r64, l64
        return errs

    def judge_forward(name, what, errs, fp64_tol=FP32_FP64_TOL):
        """Both planted faults caught, the error against fp64 stated and
        within ``fp64_tol``."""
        worst = max(errs["err"], errs["lse_err"])
        line = (f"bf16 rounding {judge(name, what, worst, errs['fault_err'])}"
                f"; one TF32 pass "
                f"{judge(name, what + ' (TF32)', worst, errs['tf32_fault_err'])}"
                f"; against fp64 {errs['fp64_err']:.3e} (tol {fp64_tol})")
        check(errs["fp64_err"] <= fp64_tol,
              f"{name} fp32 {what}: {errs['fp64_err']:.3e} from fp64")
        return line

    def fwd_tail(t):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return (f"{tail(**{k: t[k] for k in keys})}"
                f"; device {fmt_ms(t['device_ms'])} + split pre-pass "
                f"{fmt_ms(t['split_device_ms'])}; bound basis "
                f"{t['bound_basis']} (fp32 FMAs at 67 TFLOP/s: "
                f"{t['fma_bound_ms']:.4f} ms)")

    def fused(b, lq, lk, h, d):
        """q, k, v as column slices of fused projections, and dO."""
        split = lambda x, n: [t.reshape(b, n, h, d).transpose(1, 2)
                              for t in x.chunk(x.shape[-1] // (h * d), -1)]
        q = split(rnd(b, lq, h * d), lq)[0]
        k, v = split(rnd(b, lk, 2 * h * d), lk)
        g = rnd(b, lq, h * d).reshape(b, lq, h, d).transpose(1, 2)
        return q, k, v, g

    def backward_case(names, what, shape, share, run_dq, run_dkv, got, want,
                      bad, tf32_bad, ref64, plain, library):
        """The gradients against plain fp32 with both planted faults (bf16
        rounding, one TF32 pass) and against fp64; the times, device times
        and the TF32 bound of dq and dk/dv."""
        line, errs = [], {}
        for name, a, w, f, f1, w64 in zip(("dq", "dk", "dv"), got, want, bad,
                                          tf32_bad, ref64):
            top = w.abs().max().item()
            check(a.dtype == torch.float32 and bool(torch.isfinite(a).all()),
                  f"{names} fp32 {what}: {name} not finite fp32")
            errs[name] = (a - w).abs().max().item()
            rel64 = ((a.double() - w64).abs().max()
                     / w64.abs().max()).item()
            errs[name + "_fp64"] = rel64
            line.append(
                f"{name} bf16 rounding " + judge(
                    names, f"{what} {name}", errs[name],
                    (f - w).abs().max().item(), top)
                + "; one TF32 pass " + judge(
                    names, f"{what} {name} (TF32)", errs[name],
                    (f1 - w).abs().max().item(), top)
                + f"; against fp64 {rel64:.3e} of its largest (tol "
                  f"{FP32_FP64_TOL})")
            check(rel64 <= FP32_FP64_TOL,
                  f"{names} fp32 {what} {name}: {rel64:.3e} from fp64")
        shared = dict(plain_ms=cuda_ms(plain, 2, 1),
                      library_ms=cuda_ms(library, 3, 1))
        t_dq = dict(ms=cuda_ms(run_dq, 5, 1), **shared,
                    **fp32_fwd_device_ms(run_dq, family="K3 flash bwd dq"),
                    **tf32_bound(*shape, share, 3, 3, 2, 2))
        t_dkv = dict(ms=cuda_ms(run_dkv, 5, 1), **shared,
                     **fp32_fwd_device_ms(run_dkv,
                                          family="K4 flash bwd dk/dv"),
                     **tf32_bound(*shape, share, 4, 2, 4, 2))
        k_dq, k_dkv = names.split(" / ")
        print(f"{names} fp32 {what} (B,H,Lq,Lk,D)={shape}: max|err| "
              f"{'; '.join(line)}; the plain and library backward compute "
              f"dq, dk and dv together; {k_dq}: {fwd_tail(t_dq)}; {k_dkv}: "
              f"{fwd_tail(t_dkv)}", flush=True)
        base = dict(form=what, shape=list(shape), route=FP32_ROUTE)
        fp64 = lambda *ns: max(errs[n + "_fp64"] for n in ns)
        records[k_dq].append(dict(base, max_abs_err=errs["dq"],
                                  fp64_rel_err=fp64("dq"), **t_dq))
        records[k_dkv].append(dict(base, max_abs_err=max(errs["dk"],
                                                         errs["dv"]),
                                   fp64_rel_err=fp64("dk", "dv"), **t_dkv))

    def fp64_backward(q, k, v, g, **masks):
        """(dq, dk, dv) of plain attention in fp64 under its own fp64
        forward."""
        d64 = f64(q, k, v)
        o64, l64 = fa.flash_attention_plain(*d64, **masks)
        return fa.flash_attention_bwd_plain(*d64, o64, l64, g.double(),
                                            **masks)

    # K1, K3, K4: (B, H, Lq, Lk, D), causal, with the backward
    for shape, causal, with_bwd in FP32_CASES:
        b, h, lq, lk, d = shape
        q, k, v, g = fused(b, lq, lk, h, d)
        what = "causal" if causal else "none"
        share = (lq + 1) / (2.0 * lq) if causal else 1.0
        run = lambda: fa.flash_attention_cuda(q, k, v, causal=causal)
        plain = lambda: fa.flash_attention_plain(q, k, v, causal=causal)
        out, lse = run()
        torch.cuda.synchronize()
        check(out.dtype == lse.dtype == torch.float32, "K1 fp32 dtypes")
        errs = forward_errors(
            f"K1 fp32 {what} {shape}", out, lse, plain,
            lambda f: fa.flash_attention_plain(
                *f(q, k, v), causal=causal))
        verdict = judge_forward("K1", f"{what} {shape}", errs)
        times = dict(ms=cuda_ms(run, 5, 1),
                     **fp32_fwd_device_ms(run),
                     plain_ms=cuda_ms(plain, 2, 1),
                     library_ms=cuda_ms(
                         lambda: sdpa(q, k, v, is_causal=causal), 3, 1),
                     **tf32_bound(*shape, share))
        print(f"K1 fp32 {what} (B,H,Lq,Lk,D)={shape}: max|out err|="
              f"{errs['err']:.3e} max|lse err|={errs['lse_err']:.3e}; "
              f"{verdict}; {fwd_tail(times)}", flush=True)
        records["K1"].append(dict(form=what, shape=list(shape),
                                  route=FP32_ROUTE,
                                  max_abs_err=errs["err"],
                                  **{k: v for k, v in errs.items()
                                     if k != "err"}, **times))
        if not with_bwd:
            continue
        masks = dict(causal=causal)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **masks)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, **masks)
        bad = fa.flash_attention_bwd_plain(*rounded(q, k, v), out, lse,
                                           *rounded(g), **masks)
        tf32_bad = fa.flash_attention_bwd_plain(*tf32(q, k, v), out, lse,
                                                *tf32(g), **masks)
        ref64 = fp64_backward(q, k, v, g, **masks)
        delta = (g * out).sum(-1)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = sdpa(ql, kl, vl, is_causal=causal)
        backward_case(
            "K3 / K4", what, shape, share,
            lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, g, lse, delta,
                                                   **masks),
            lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, g, lse, delta,
                                                    **masks),
            got, want, bad, tf32_bad, ref64,
            lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                                 **masks),
            lambda: torch.autograd.grad(ol, (ql, kl, vl), g,
                                        retain_graph=True))
        del got, want, bad, tf32_bad, ref64, ol
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()

    # K1's fp32 forms that no earlier checkout had: head dim 160 (SD1's UNet
    # at level 2 from 768^2) and T5's bias shared over the batch (scale 1.0;
    # T5-XXL's 512 tokens), each held as the other K1 rows are.
    for what, shape in (("d160", K1_D160_SHAPE), ("bias", FP32_T5_SHAPE)):
        b, h, lq, lk, d = shape
        q, k, v, _ = fused(b, lq, lk, h, d)
        kw = dict(scale=1.0, bias=3.0 * rnd(1, h, lq, lk)) if what == "bias" \
            else {}
        run = lambda: fa.flash_attention_cuda(q, k, v, **kw)
        plain = lambda: fa.flash_attention_plain(q, k, v, **kw)
        n0 = fa.flash_attention_cuda.routes["fp32"]
        out, lse = run()
        torch.cuda.synchronize()
        check(fa.flash_attention_cuda.routes["fp32"] == n0 + 1,
              f"K1 fp32 {what} did not take the fp32 kernel")
        errs = forward_errors(f"K1 fp32 {what} {shape}", out, lse, plain,
                              lambda f: fa.flash_attention_plain(*f(q, k, v),
                                                                 **kw))
        # T5's logits are unscaled (scale 1.0): with unit q and k at d = 64
        # they spread ~8 wide, and the split's 2^-22 of each product moves
        # out ~8 x as far from fp64 as at the scaled forms' logits of ~1;
        # the bias form is held to FP32_TOL against fp64 as against fp32.
        verdict = judge_forward("K1", f"{what} {shape}", errs,
                                FP32_TOL if what == "bias" else FP32_FP64_TOL)
        library = (lambda: sdpa(q, k, v, attn_mask=kw["bias"], scale=1.0)) \
            if what == "bias" else (lambda: sdpa(q, k, v))
        times = dict(ms=cuda_ms(run, 5, 1), **fp32_fwd_device_ms(run),
                     plain_ms=cuda_ms(plain, 2, 1),
                     library_ms=cuda_ms(library, 3, 1),
                     **tf32_bound(*shape))
        if what == "bias":   # and the (1, H, Lq, Lk) fp32 bias read once
            times["bound_ms"], times["bound_by"] = bound(
                TF32_PASSES * 4.0 * b * h * lq * lk * d,
                b * h * 4.0 * d * (2 * lq + 2 * lk) + 4.0 * b * h * lq
                + 4.0 * h * lq * lk, PEAK_TF32_FLOPS)
        print(f"K1 fp32 {what} (B,H,Lq,Lk,D)={shape}: max|out err|="
              f"{errs['err']:.3e} max|lse err|={errs['lse_err']:.3e}; "
              f"{verdict}; {fwd_tail(times)}", flush=True)
        records["K1"].append(dict(form=what, shape=list(shape),
                                  route=FP32_ROUTE, max_abs_err=errs["err"],
                                  **{key: x for key, x in errs.items()
                                     if key != "err"}, **times))
        del q, k, v, out, lse, kw
    torch.cuda.empty_cache()

    # K5, K6, K7 at the four shapes of the SD3 joint attention, offsets 0
    b, h, d = 2, 24, 64
    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    for lq, lk in ((154, 154), (154, 4096), (4096, 154), (4096, 4096)):
        shape = (b, h, lq, lk, d)
        q, k, v, g = fused(b, lq, lk, h, d)
        plain = lambda: fa.flash_attention_pos_plain(q, k, v, z, z)
        plain_ms = cuda_ms(plain, 2, 1)
        library_ms = cuda_ms(lambda: sdpa(q, k, v), 3, 1)
        for stability in ("online", "bounded"):
            run = lambda: fa.flash_attention_pos_cuda(q, k, v, z, z,
                                                      stability=stability)
            out, lse = run()
            torch.cuda.synchronize()
            errs = forward_errors(
                f"K5 fp32 {stability} {shape}", out, lse, plain,
                lambda f: fa.flash_attention_pos_plain(*f(q, k, v), z, z))
            verdict = judge_forward("K5", f"{stability} {shape}", errs)
            times = dict(ms=cuda_ms(run, 5, 1),
                         **fp32_fwd_device_ms(run),
                         plain_ms=plain_ms, library_ms=library_ms,
                         **tf32_bound(*shape))
            print(f"K5 fp32 {stability} (B,H,Lq,Lk,D)={shape}: max|out err|="
                  f"{errs['err']:.3e} max|lse err|={errs['lse_err']:.3e}; "
                  f"{verdict}; {fwd_tail(times)}", flush=True)
            records["K5"].append(dict(
                form=stability, shape=list(shape), route=FP32_ROUTE,
                max_abs_err=errs["err"],
                **{k: v for k, v in errs.items() if k != "err"}, **times))
        # the global lse and delta of an fp64 forward, as the joint
        # attention's caller holds them (rounded to fp32 for the kernels)
        o64, l64 = fa.flash_attention_pos_plain(*f64(q, k, v), z, z)
        d64 = (g.double() * o64).sum(-1)
        ref_lse, delta = l64.float(), d64.float()
        got = fa.flash_bwd_pos(q, k, v, g, ref_lse, delta, z, z)
        want = fa.flash_bwd_pos_plain(q, k, v, g, ref_lse, delta, z, z)
        bad = fa.flash_bwd_pos_plain(*rounded(q, k, v), *rounded(g), ref_lse,
                                     delta, z, z)
        tf32_bad = fa.flash_bwd_pos_plain(*tf32(q, k, v, g), ref_lse, delta,
                                          z, z)
        ref64 = fa.flash_bwd_pos_plain(*f64(q, k, v, g), l64, d64, z, z)
        del o64
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = sdpa(ql, kl, vl)
        backward_case(
            "K6 / K7", "offsets 0", shape, 1.0,
            lambda: fa.flash_bwd_pos_dq_cuda(q, k, v, g, ref_lse, delta, z,
                                             z),
            lambda: fa.flash_bwd_pos_dkv_cuda(q, k, v, g, ref_lse, delta, z,
                                              z),
            got, want, bad, tf32_bad, ref64,
            lambda: fa.flash_bwd_pos_plain(q, k, v, g, ref_lse, delta, z, z),
            lambda: torch.autograd.grad(ol, (ql, kl, vl), g,
                                        retain_graph=True))
        del got, want, bad, tf32_bad, ref64, ol, l64, d64
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()

    # The masks of K5 - K7 (two segments, causal, valid_len; rows that see
    # no key) and the joint attention with its gradients, errors only.
    off = lambda a, c: torch.tensor([a, c], dtype=torch.int32, device="cuda")
    for what, (lq, lk), qo, ko, kw in (
            ("two segments, causal and valid_len", (1000, 1000),
             (1000, 3000), (0, 2000),
             dict(seg_q=512, seg_k=500, causal=True, valid_len=2300)),
            ("rows that see no key", (1000, 1000), (100, 5000), (3000, 4000),
             dict(seg_q=512, seg_k=500, causal=True))):
        q, k, v, g = fused(1, lq, lk, 4, 64)
        out, lse = fa.flash_attention_pos_cuda(q, k, v, off(*qo), off(*ko),
                                               **kw)
        ref, ref_lse = fa.flash_attention_pos_plain(q, k, v, off(*qo),
                                                    off(*ko), **kw)
        seen = ref_lse > -1e29
        err = (out - ref).abs().max().item()
        lse_err = (lse - ref_lse)[seen].abs().max().item()
        blank = bool((lse[~seen] <= -1e29).all()) and not bool(
            out[~seen].any())
        delta = (g * out).sum(-1)
        got = fa.flash_bwd_pos(q, k, v, g, lse, delta, off(*qo), off(*ko),
                               **kw)
        want = fa.flash_bwd_pos_plain(q, k, v, g, lse, delta, off(*qo),
                                      off(*ko), **kw)
        grad_err = max((a - w).abs().max().item() / w.abs().max().item()
                       for a, w in zip(got, want))
        print(f"K5 - K7 fp32 {what} (1,4,{lq},{lk},64): max|out err|="
              f"{err:.3e} max|lse err|={lse_err:.3e} max|grad err|/max|grad|="
              f"{grad_err:.3e} (tol {FP32_TOL}); {int((~seen).sum())} rows see "
              f"no key (out = 0, lse <= -1e29: {blank})", flush=True)
        check(max(err, lse_err, grad_err) <= FP32_TOL and blank
              and bool((~seen).any()) == (what == "rows that see no key")
              and not bool(got[0][~seen].any()),
              f"K5 - K7 fp32 {what} disagree")
    ts = [t.detach().requires_grad_() for n in (154, 4096)
          for t in fused(2, n, n, 24, 64)[:3]]
    n0 = read_fp32_counts()
    oc, ox = fa.joint_flash_attention(*ts)
    gc_, gx = rnd(2, 24, 154, 64), rnd(2, 24, 4096, 64)
    torch.autograd.backward([oc, ox], [gc_, gx])
    n1 = read_fp32_counts()
    check([n1[k] - n0[k] for k in ("K5", "K6", "K7")] == [4, 4, 4],
          "the fp32 joint attention did not launch K5, K6, K7 four times")
    refs = [t.detach().clone().requires_grad_() for t in ts]
    cat = lambda a, c: torch.cat([a, c], dim=2)
    out = attn.plain_attention(cat(refs[0], refs[3]), cat(refs[1], refs[4]),
                               cat(refs[2], refs[5]))
    out.backward(cat(gc_, gx))
    err = (cat(oc, ox) - out).abs().max().item()
    grad_err = max((t.grad - r.grad).abs().max().item()
                   / r.grad.abs().max().item() for t, r in zip(ts, refs))
    print(f"joint attention fp32 (2,24,154+4096,64) and its gradients against "
          f"autograd through plain attention over the concatenated sequence: "
          f"max|out err|={err:.3e} max|grad err|/max|grad|={grad_err:.3e} "
          f"(tol {FP32_TOL})", flush=True)
    check(err <= FP32_TOL and grad_err <= FP32_TOL,
          f"the fp32 joint attention disagrees: {err} / {grad_err}")
    del ts, refs, out, oc, ox
    torch.cuda.empty_cache()
    return records


# --------------------------------------------------------------------------
# The SD1 generator, whole, at full width in bf16
# --------------------------------------------------------------------------
SLICE_WORDS = ["a", "photograph", "of", "an", "astronaut", "riding", "horse",
               "watercolor", "fox", "in", "the", "snow", "blurry", "red"]


def phase_sd1_slice(card, models):
    """The rest of ``SD1Generator`` on the bundle of the SD1 phase, 512x512:
    a request with each sampler at 50 steps, img2img at strength 0.8,
    ``do_cfg=False``, ``per_sample_seeds`` at batch 1 and inside a batch of
    4, and a weighted prompt through the tokenizer."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.tokenizer import (
        CLIPTokenizer, build_simple_vocab)
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SAMPLERS, SD1Generator)

    step_events = []

    def on_unet(module, args):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        step_events.append((ev, args[0].shape[0]))

    encoder_k1 = []
    hooks = [
        models.unet.register_forward_pre_hook(on_unet),
        models.encoder.mid_attn.register_forward_pre_hook(
            lambda m, a: encoder_k1.append(-fa.flash_attention_cuda.launches)),
        models.encoder.mid_attn.register_forward_hook(
            lambda m, a, o: encoder_k1.append(
                fa.flash_attention_cuda.launches))]
    prompt = ["a photograph of an astronaut riding a horse"]

    def request(what, sd, prompts, n_unet, unet_batch, k1, **kw):
        step_events.clear()
        n0 = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        images = sd(prompts, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        n1 = read_counts()
        got_k1 = n1["K1"] - n0["K1"]
        step_ms = (step_events[0][0].elapsed_time(step_events[-1][0])
                   / (len(step_events) - 1))
        b = len(prompts)
        print(f"SD1 {what}: {secs:.3f} s, {secs / b:.3f} s/image, "
              f"{step_ms:.2f} ms/denoise step ({len(step_events)} UNet calls "
              f"of batch {step_events[0][1]}), K1 launches {got_k1}, K2 "
              f"{n1['K2'] - n0['K2']} [{card}]", flush=True)
        check(images.shape == (b, 512, 512, 3) and str(images.dtype)
              == "uint8" and float(images.std()) > 0.0,
              f"SD1 {what}: bad images {images.shape} {images.dtype}")
        check(len(step_events) == n_unet
              and {n for _, n in step_events} == {unet_batch},
              f"SD1 {what}: {len(step_events)} UNet calls of batches "
              f"{ {n for _, n in step_events} }, not {n_unet} of {unet_batch}")
        check(got_k1 == k1, f"SD1 {what}: K1 launches {got_k1} != {k1}")
        return images

    reset_counts()
    size = dict(height=512, width=512)
    for sampler in SAMPLERS:
        sd = SD1Generator(models, sampler=sampler, n_inference_steps=50,
                          cfg_scale=7.5, **size)
        request(f"txt2img {sampler}, 50 steps, CFG 7.5", sd, prompt, 50, 2,
                K1_PER_REQUEST, seed=11)

    # img2img: strength 0.8 of 50 steps = the last 40; one more K1 launch,
    # the encoder's one-head attention over 64 x 64 tokens at head dim 512
    source = np.random.default_rng(0).integers(0, 256, (512, 512, 3),
                                               dtype=np.uint8)
    sd = SD1Generator(models, sampler="k_lms", n_inference_steps=50, **size)
    request("img2img k_lms, strength 0.8 (40 of 50 steps)", sd, prompt, 40, 2,
            10 * 40 + 2, seed=12, input_images=[source], strength=0.8)
    check(len(encoder_k1) == 2 and sum(encoder_k1) == 1,
          f"the VAE encoder's attention launched K1 {sum(encoder_k1)} times")

    sd = SD1Generator(models, sampler="k_lms", n_inference_steps=50,
                      do_cfg=False, **size)
    request("txt2img k_lms, do_cfg=False", sd, prompt, 50, 1, K1_PER_REQUEST,
            seed=13)

    # per_sample_seeds: seed 1234 alone and as the third of a batch of four
    sd = SD1Generator(models, sampler="k_euler", n_inference_steps=20, **size)
    seeds = [7, None, 1234, 9]
    alone = sd.initial_noise(1, per_sample_seeds=[1234])
    among = sd.initial_noise(4, seed=5, per_sample_seeds=seeds)
    check(torch.equal(alone[0], among[2]) and not torch.equal(among[0],
                                                              among[2]),
          "per_sample_seeds: the initial latents depend on the batch")
    one = request("per_sample_seeds [1234], k_euler, 20 steps", sd, prompt,
                  20, 2, 10 * 20 + 1, per_sample_seeds=[1234])
    four = request("per_sample_seeds [7, None, 1234, 9], k_euler, 20 steps",
                   sd, ["a watercolor fox in the snow"] * 2 + prompt
                   + ["a horse"], 20, 8, 10 * 20 + 1, seed=5,
                   per_sample_seeds=seeds)
    diff = np.abs(one[0].astype(np.int16) - four[2].astype(np.int16))
    print(f"per_sample_seeds: initial latents of seed 1234 equal bit for bit "
          f"at batch 1 and as sample 3 of 4; the two images differ by at most "
          f"{int(diff.max())} levels (mean {float(diff.mean()):.4f}); another "
          f"sample of the batch differs from it by up to "
          f"{int(np.abs(four[0].astype(np.int16) - four[2]).max())}",
          flush=True)

    # a weighted prompt through the tokenizer (synthetic vocabulary)
    tok = CLIPTokenizer(*build_simple_vocab(SLICE_WORDS))
    ids = tok.encode(prompt[0])
    check(len(ids) == 77 and ids[0] == tok.bos_id and tok.eos_id in ids[1:],
          "the tokenizer's ids are not BOS ... EOS padded to 77")
    plain_sd = SD1Generator(models, tokenizer=tok, sampler="k_euler",
                            n_inference_steps=20, **size)
    weighted_sd = SD1Generator(models, tokenizer=tok, sampler="k_euler",
                               n_inference_steps=20, prompt_weighting=True,
                               **size)
    text = ["a photograph of an (astronaut:1.4) riding a [horse]"]
    base = request("tokenized prompt, no weighting", plain_sd, prompt, 20, 2,
                   10 * 20 + 1, seed=14, uncond_prompts=["blurry"])
    same = request("weighted syntax with every weight 1", weighted_sd, prompt,
                   20, 2, 10 * 20 + 1, seed=14, uncond_prompts=["blurry"])
    moved = request("weighted prompt (astronaut:1.4) [horse]", weighted_sd,
                    text, 20, 2, 10 * 20 + 1, seed=14,
                    uncond_prompts=["blurry"])
    d_same = int(np.abs(base.astype(np.int16) - same).max())
    d_moved = int(np.abs(base.astype(np.int16) - moved).max())
    print(f"prompt weighting: weight 1 everywhere changes the image by "
          f"{d_same} levels, (astronaut:1.4) [horse] by up to {d_moved}",
          flush=True)
    check(d_same == 0 and d_moved > 0, "prompt weights: the identity moved "
          "the image or the weights did not")
    launches = read_counts()
    for hook in hooks:
        hook.remove()
    return launches


# --------------------------------------------------------------------------
# The port's fp32 defaults, end to end, each against plain attention
# --------------------------------------------------------------------------
def fp32_fwd_share(run):
    """Device-busy ms of one profiled ``run()`` and the fp32 forward's part
    of it (its flash kernels and the split pre-pass)."""
    fams = device_families(run, F32_FWD)
    fwd = fams.get(F32_FWD, 0.0) + fams.get(F32_SPLIT, 0.0)
    return sum(fams.values()), fwd, fams.get(F32_SPLIT, 0.0)


def fp32_launch_check(what, want):
    """The fp32 launches since the last reset are ``want`` and no flash
    kernel ran in bf16; returns (all launches, fp32 launches)."""
    counts, fp32 = read_counts(), read_fp32_counts()
    check(fp32 == dict(dict.fromkeys(fp32, 0), **want),
          f"{what}: fp32 launches {fp32}, expected {want}")
    check(all(counts[k] == n for k, n in fp32.items()),
          f"{what}: some flash launches were not fp32: {counts} vs {fp32}")
    return counts, fp32


def phase_sd1_768(card, models, steps, dtype):
    """``SD1Generator`` at 768x768 (K1 at head dim 160 in the UNet's level-2
    self-attentions), ``steps`` k-LMS steps, CFG 7.5, on the SD1 bundle of
    ``dtype``: a warm-up and a timed request (s/image), one profiled
    (device-busy ms); the launch counts by head dim and kernel show that
    the d = 160 attention ran on its kernel. Returns the timed request's
    launches and its fp32 launches."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SD1Generator)

    sd = SD1Generator(models, sampler="k_lms", n_inference_steps=steps,
                      cfg_scale=7.5, height=768, width=768)
    latents = []
    hook = models.decoder.register_forward_pre_hook(
        lambda m, a: latents.append(a[0].detach().clone()))
    prompt = ["a lighthouse at dusk, wide angle"]
    sd(prompt, seed=41)                                   # warm-up
    reset_counts()
    latents.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    images = sd(prompt, seed=41)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, fp32 = read_counts(), read_fp32_counts()
    k1 = kernel_counters()["K1"]
    dims, routes = dict(k1.head_dims), dict(k1.routes)
    hook.remove()
    want_dims = {d: n * steps for d, n in SD1_768_PER_STEP.items()}
    want_dims[512] = 1
    route = "fp32" if dtype == "fp32" else "sm90"
    want_routes = ({"fp32": 15 * steps + 1} if dtype == "fp32"
                   else {"sm90": 15 * steps, "d512": 1})
    fams = device_families(lambda: sd(prompt, seed=41), "K1 flash fwd"
                           if dtype == "bf16" else F32_FWD)
    busy = sum(fams.values()) if fams else None
    k1_ms = fams.get("K1 flash fwd" if dtype == "bf16" else F32_FWD, 0.0)
    print(f"SD1 at 768^2, {dtype}, {steps} k-LMS steps, CFG 7.5: {secs:.3f} "
          f"s/image (warm), peak {peak:.2f} GiB; one profiled request: "
          f"device busy {fmt_ms(busy)}, K1 {k1_ms:.2f} ms of it; K1 launches "
          f"by head dim {dims}, by kernel {routes} (d = 160: "
          f"{dims.get(160, 0)} on {route}) [{card}]", flush=True)
    check(images.shape == (1, 768, 768, 3) and float(images.std()) > 0,
          f"SD1 768^2 {dtype}: bad image")
    check(len(latents) == 1 and latents[0].shape == (1, 96, 96, 4)
          and bool(torch.isfinite(latents[0]).all()),
          f"SD1 768^2 {dtype}: final latents not finite or misshaped")
    check(dims == want_dims and routes == want_routes,
          f"SD1 768^2 {dtype}: K1 launches by head dim {dims} by kernel "
          f"{routes}, expected {want_dims} / {want_routes}")
    del sd
    return launches, fp32


def phase_sd1_fp32(card):
    """``SD1Models`` at its ``from_jax`` default dtype, fp32: 512x512, 10
    k-LMS steps, against the same request through plain attention; then the
    same bundle at 768x768 (:func:`phase_sd1_768`). Returns both requests'
    (launches, fp32 launches)."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SD1Generator, SD1Models)

    models = SD1Models.initialize(
        torch.Generator(device="cuda").manual_seed(0), "cuda", "fp32")
    check(next(models.unet.parameters()).dtype == torch.float32, "not fp32")
    sd = SD1Generator(models, sampler="k_lms", n_inference_steps=10,
                      height=512, width=512)
    latents = []
    hook = models.decoder.register_forward_pre_hook(
        lambda m, a: latents.append(a[0].detach().clone()))
    prompt = ["a lighthouse at dusk"]
    sd(prompt, seed=21)                                   # warm-up
    reset_counts()
    latents.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    images = sd(prompt, seed=21)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts, fp32 = fp32_launch_check("fp32 SD1", dict(K1=10 * 10 + 1))
    with plain_attention_only():
        t = time.perf_counter()
        want = sd(prompt, seed=21)
        torch.cuda.synchronize()
        plain_secs = time.perf_counter() - t
    hook.remove()
    err = rel_l2(latents[0], latents[1])
    diff = int(np.abs(images.astype(np.int16) - want).max())
    busy, fwd, split = fp32_fwd_share(lambda: sd(prompt, seed=21))
    print(f"fp32 SD1 (SD1Models default dtype), 512^2, 10 k-LMS steps, CFG "
          f"7.5: {secs:.3f} s/image through the fp32 kernels, {plain_secs:.3f} "
          f"s through plain attention, peak {peak:.2f} GiB; one profiled "
          f"request: device busy {busy:.2f} ms, K1 fp32 {fwd:.2f} ms of it "
          f"(split pre-pass {split:.2f} ms); fp32 launches "
          f"{fp32}; final latents rel L2 {err:.3e} (tol {E2E_FP32_TOL}), "
          f"images differ by at most {diff} levels (tol 1) [{card}]",
          flush=True)
    check(images.shape == (1, 512, 512, 3) and float(images.std()) > 0,
          "fp32 SD1: bad image")
    check(err <= E2E_FP32_TOL and diff <= 1,
          f"fp32 SD1 disagrees with plain attention: {err} / {diff}")
    del sd
    # the same bundle at 768^2, where K1 runs at head dim 160 too
    return [(counts, fp32),
            phase_sd1_768(card, models, SD1_768_FP32_STEPS, "fp32")]


def phase_sd3_fp32(card):
    """``SD3Models`` at its ``from_jax`` default dtype, fp32, at full width
    and depth (7.7 B parameters, 28.7 GiB): 1024x1024, 4 flow-Euler steps,
    against the same request through plain attention; then the bundle's
    T5-XXL on 512 tokens (:func:`phase_t5_fp32`). Returns both runs'
    (launches, fp32 launches)."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer, SD3Models)

    t0 = time.perf_counter()
    models = SD3Models.initialize(
        torch.Generator(device="cuda").manual_seed(0), "cuda", "fp32",
        depth=SD3_DEPTH, pos_embed_max_size=192)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 30
    check(next(models.mmdit.parameters()).dtype == torch.float32, "not fp32")
    inf = SD3Inferencer(models, shift=3.0)
    latents = []
    hook = models.vae_decoder.register_forward_pre_hook(
        lambda m, a: latents.append(a[0].detach().clone()))
    tokens = np.zeros((1, 77), np.int32)
    steps = 4
    request = lambda: inf.gen_image(tokens, width=1024, height=1024,
                                    steps=steps, cfg_scale=5.0, seed=31)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    images = request()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts, fp32 = fp32_launch_check(
        "fp32 SD3", dict(K5=4 * SD3_DEPTH * steps, K1=1))
    with plain_attention_only():
        t = time.perf_counter()
        want = request()
        torch.cuda.synchronize()
        plain_secs = time.perf_counter() - t
    hook.remove()
    err = rel_l2(latents[0], latents[1])
    diff = int(np.abs(images.astype(np.int16) - want).max())
    busy, fwd, split = fp32_fwd_share(request)
    print(f"fp32 SD3 (SD3Models default dtype), depth {SD3_DEPTH}, {held:.2f} "
          f"GiB of fp32 weights (set-up {t - t0:.1f} s), 1024^2, {steps} "
          f"flow-Euler steps, CFG 5: {secs:.3f} s/image through the fp32 "
          f"kernels (cold), {plain_secs:.3f} s through plain attention, peak "
          f"{peak:.2f} GiB; one profiled request: device busy {busy:.2f} ms, "
          f"K5 + K1 fp32 {fwd:.2f} ms of it ({100 * fwd / busy:.1f} %; split "
          f"pre-pass {split:.2f} ms); fp32 launches {fp32}; final latents rel "
          f"L2 "
          f"{err:.3e} (tol {E2E_FP32_TOL}), images differ by at most {diff} "
          f"levels (tol 1) [{card}]", flush=True)
    check(images.shape == (1, 1024, 1024, 3) and float(images.std()) > 0,
          "fp32 SD3: bad image")
    check(err <= E2E_FP32_TOL and diff <= 1,
          f"fp32 SD3 disagrees with plain attention: {err} / {diff}")
    return [(counts, fp32), phase_t5_fp32(card, models.t5)]


def phase_t5_fp32(card, t5):
    """The fp32 bundle's T5-XXL encoder on (2, 512) token ids, the longest
    prompt SD3 admits: its 24 attentions take K1's fp32 bias form (the
    shared bucket bias, scale 1.0). Each block's attention sub-layer is
    held against the same sub-layer through plain attention on the same
    input (relative L2 within E2E_FP32_TOL), and the whole encoder is
    timed both ways. Free-running, the random-weight encoder amplifies any
    rounding difference block after block (its softmax is sharp: q.k spreads
    ~8 wide, unscaled), so its output drift is printed beside that of two
    plain-attention runs that differ only in the order of their key sums,
    and not judged. Returns the call's (launches, fp32 launches)."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as attn
    from from_ddpm_to_stable_diffusion_tpu_torch.ops.groupnorm import rms_norm

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, t5.config.vocab_size, (2, 512))).cuda()
    k1 = kernel_counters()["K1"]
    plain = attn.plain_attention

    def keys_reversed(q, k, v, bias=None, *a, **kw):
        """Plain attention over the keys in reverse order: the same
        function, fp32 sums taken in another order."""
        return plain(q, k.flip(2), v.flip(2),
                     None if bias is None else bias.flip(-1), *a, **kw)

    def on_path(use_flash, fn):
        """``fn()`` with every attention on the kernels or the plain path."""
        saved = attn.dot_product_attention
        attn.dot_product_attention = functools.partial(saved,
                                                       use_flash=use_flash)
        try:
            return fn()
        finally:
            attn.dot_product_attention = saved

    with torch.no_grad():
        reset_counts()
        out = t5(tokens)
        torch.cuda.synchronize()
        launches, fp32 = read_counts(), read_fp32_counts()
        forms, routes = dict(k1.forms), dict(k1.routes)
        ms = cuda_ms(lambda: t5(tokens), 5, 1)
        fams = device_families(lambda: t5(tokens), F32_FWD)
        ref = on_path(False, lambda: t5(tokens))
        plain_ms = on_path(False, lambda: cuda_ms(lambda: t5(tokens), 5, 1))
        attn.plain_attention = keys_reversed
        try:
            ref_reversed = on_path(False, lambda: t5(tokens))
        finally:
            attn.plain_attention = plain
        # block by block, both paths fed the plain path's activations
        x, bias, worst = t5.embed_tokens(tokens), None, (0.0, 0)
        for i in range(t5.config.num_layers):
            block = getattr(t5, f"block{i}")
            h = rms_norm(x, block.ln1_scale, eps=1e-6)
            want, shared_bias = on_path(False, lambda: block.attn(h, bias))
            got, _ = on_path(True, lambda: block.attn(h, bias))
            worst = max(worst, (rel_l2(got, want), i))
            bias = shared_bias
            x, _ = on_path(False, lambda: block(x, bias))
    free, control = rel_l2(out, ref), rel_l2(ref_reversed, ref)
    busy = (f"device busy {sum(fams.values()):.2f} ms, K1 fp32 "
            f"{fams.get(F32_FWD, 0.0):.2f} ms + split pre-pass "
            f"{fams.get(F32_SPLIT, 0.0):.2f} ms" if fams
            else "device busy not measured")
    print(f"T5-XXL encoder, fp32 (SD3Models default dtype), on (2, 512) "
          f"tokens: {ms:.2f} ms/call through K1's fp32 bias form ({busy}; "
          f"profiler, one call), {plain_ms:.2f} ms/call through plain "
          f"attention; block by block on the same input the worst attention "
          f"sub-layer differs by rel L2 {worst[0]:.3e} (block {worst[1]}, "
          f"tol {E2E_FP32_TOL}); free-running, the output differs by rel L2 "
          f"{free:.3e}, two plain-attention runs differing only in the order "
          f"of their key sums by {control:.3e} (not judged); launches "
          f"{launches}, forms {forms}, by kernel {routes} [{card}]",
          flush=True)
    check(tuple(out.shape) == (2, 512, t5.config.d_model)
          and out.dtype == torch.float32 and bool(torch.isfinite(out).all()),
          "fp32 T5 output misshaped or not finite")
    check(worst[0] <= E2E_FP32_TOL,
          f"an fp32 T5 attention through K1 disagrees with the plain path: "
          f"rel L2 {worst[0]} at block {worst[1]}")
    check(launches == T5_PER_CALL and forms == {BIASED: 24}
          and routes == {"fp32": 24},
          f"fp32 T5 launches {launches} forms {forms} routes {routes}")
    return launches, fp32


def fp32_train_run(build, n_steps):
    """``n_steps`` train steps from fixed seeds. ``build()`` -> (trainer,
    state, step) with ``step(state, i) -> (state, loss)``. Returns the
    losses, the last step's flattened gradient (on the host), that step's
    time, the peak memory and the parameter count."""
    import torch

    torch.manual_seed(0)                # dropout draws from the global state
    trainer, state, step = build()
    losses = []
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(n_steps):
        if i == n_steps - 1:
            start.record()
        state, loss = step(state, i)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    grads = torch.cat([p.grad.flatten().cpu() for p in state.params.values()])
    result = (torch.stack(losses).float().cpu(), grads,
              start.elapsed_time(end),
              torch.cuda.max_memory_allocated() / 2 ** 30,
              trainer.num_params(state))
    del trainer, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return result


def fp32_train_pair(card, what, build, n_steps, per_step):
    """Train steps of a trainer whose compute dtype is fp32 through the fp32
    kernels, then the same steps from the same seeds through plain
    attention: the losses and the last step's gradients must agree."""
    import torch

    reset_counts()
    losses, grads, ms, peak, n_params = fp32_train_run(build, n_steps)
    counts, fp32 = fp32_launch_check(
        what, {k: n * n_steps for k, n in per_step.items()})
    with plain_attention_only():
        want_losses, want_grads, plain_ms, plain_peak, _ = fp32_train_run(
            build, n_steps)
    loss_err = ((losses - want_losses).abs() / want_losses.abs()).max().item()
    grad_err = rel_l2(grads, want_grads)
    del grads, want_grads
    print(f"{what}: {n_params} fp32 parameters, fp32 compute, {n_steps} "
          f"steps: last step {ms:.2f} ms through the fp32 kernels (peak "
          f"{peak:.2f} GiB), {plain_ms:.2f} ms through plain attention (peak "
          f"{plain_peak:.2f} GiB); fp32 launches {fp32}; losses "
          f"{[round(v, 5) for v in losses.tolist()]} against "
          f"{[round(v, 5) for v in want_losses.tolist()]} (max rel "
          f"{loss_err:.3e}, tol {E2E_FP32_TOL}); last step's gradient rel L2 "
          f"{grad_err:.3e} (tol {E2E_FP32_TOL}) [{card}]", flush=True)
    check(bool(torch.isfinite(losses).all()) and loss_err <= E2E_FP32_TOL
          and grad_err <= E2E_FP32_TOL,
          f"{what} disagrees with plain attention: {loss_err} / {grad_err}")
    counts.step_ms = ms
    return counts, fp32


def phase_train_fp32(card):
    """The three trainers at fp32 compute: ``VLMTrainer`` at its default
    dtype on 384x384 images, ``TinySDConfig(dtype="fp32")`` and
    ``FlowTrainConfig(dtype="fp32")`` with the MMDiT at SD3-medium's width
    and depth (``MMDiTConfig`` ties them: hidden = 64 x depth). The MMDiT
    runs at latent 128 (4096 + 154 tokens), batch 1, through the kernels
    alone: plain attention would save 24 x 1.7 GB of probabilities beside
    33 GB of parameters, gradients and moments. It is held against plain
    attention at latent 64 (1024 + 154 tokens), batch 2. Returns each
    run's (launches, fp32 launches), the launches carrying ``step_ms``, the
    last step's ms through the fp32 kernels."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        DataLoader, SyntheticImageDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.io.shapes_dataset import (
        CaptionedShapesDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.mmdit import MMDiTConfig
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        DDPMTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
        MMDiTTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        FlowTrainConfig, TinySDConfig)

    runs = []
    n_steps = 2

    def build_vlm():
        trainer = vlm_trainer("cuda", None, VLM_LAYERS, warmup_steps=1,
                              total_steps=1000)
        check(trainer.policy.compute_dtype == torch.float32,
              "VLMTrainer's default dtype is not fp32")
        data = CaptionedShapesDataset(16 * n_steps, img_size=384, seed=0)
        batches = [tuple(torch.from_numpy(a).cuda()
                         for a in vlm_batch(data, 16 * i, 16))
                   for i in range(n_steps)]
        return (trainer, trainer.create_state(384),
                lambda state, i: trainer.train_step(state, *batches[i]))

    runs.append(fp32_train_pair(
        card, "fp32 TinyVLM (VLMTrainer default dtype), batch 16, 576 + 8 "
        "tokens", build_vlm, n_steps,
        dict(K1=2 * VLM_LAYERS, K3=2 * VLM_LAYERS, K4=2 * VLM_LAYERS)))

    def build_tiny_sd():
        cfg = TinySDConfig(dtype="fp32")
        loader = DataLoader(SyntheticImageDataset(
            cfg.batch_size * n_steps, cfg.img_size, cfg.img_channel,
            cfg.num_class, seed=cfg.seed), cfg.batch_size, seed=cfg.seed)
        batches = list(loader)
        trainer = DDPMTrainer(cfg, device="cuda")
        return (trainer, trainer.create_state(len(loader)),
                lambda state, i: trainer.train_step(state, *batches[i]))

    runs.append(fp32_train_pair(
        card, 'fp32 tiny-SD (TinySDConfig(dtype="fp32")), batch 32 at 64^2',
        build_tiny_sd, n_steps, dict(K1=6, K3=6, K4=6)))

    def build_mmdit(img_size, batch):
        model_cfg = MMDiTConfig()
        cfg = FlowTrainConfig(img_size=img_size, context_len=154,
                              batch_size=batch, dtype="fp32")
        trainer = MMDiTTrainer(model_cfg, cfg, device="cuda")
        data = [torch.from_numpy(a).cuda() for a in mmdit_batch(
            batch, img_size, cfg.context_len, model_cfg, seed=0)]
        return (trainer, trainer.create_state(steps_per_epoch=n_steps),
                lambda state, i: trainer.train_step(state, *data))

    per_step = dict(K5=4 * SD3_DEPTH, K6=4 * SD3_DEPTH, K7=4 * SD3_DEPTH)
    what = 'fp32 MMDiT (FlowTrainConfig(dtype="fp32")), depth 24'
    reset_counts()
    losses, _, ms, peak, n_params = fp32_train_run(
        functools.partial(build_mmdit, 128, 1), n_steps)
    runs.append(fp32_launch_check(
        what, {k: n * n_steps for k, n in per_step.items()}))
    runs[-1][0].step_ms = ms
    print(f"{what}, {n_params} fp32 parameters, batch 1, latent 128 -> 4096 "
          f"+ 154 tokens, {n_steps} steps through the fp32 kernels: last step "
          f"{ms:.2f} ms, peak {peak:.2f} GiB, losses "
          f"{[round(v, 5) for v in losses.tolist()]}, fp32 launches "
          f"{runs[-1][1]} [{card}]", flush=True)
    check(bool(torch.isfinite(losses).all()), f"{what}: non-finite loss")
    runs.append(fp32_train_pair(
        card, what + ", batch 2, latent 64 -> 1024 + 154 tokens",
        functools.partial(build_mmdit, 64, 2), n_steps, per_step))
    return runs


def main():
    card = phase_device()
    phase_build()
    kernels, tail = phase_kernels(card)
    k1_launch_path(card, "after the kernel phase")
    kernels["K2 launch path us"] = dict(zip(
        ("wrapper", "c_entry", "kernel"),
        k2_launch_path(card, "after the kernel phase")))
    kernels_fp32 = phase_kernels_fp32(card, tail)
    import torch

    paths = ("sd1", "sd1_slice", "sd1_768", "sd1_checkpoint", "sd1_int8",
             "sd3", "t5", "sd3_img2img", "sd3_tiled", "sd3_text",
             "sd3_checkpoint", "sd3_int8", "sd3_offload", "training",
             "sampling", "mmdit_training",
             "mmdit_sampling", "vlm_training", "vlm_decoding", "sd1_fp32",
             "sd1_768_fp32", "sd3_fp32", "t5_fp32", "vlm_fp32",
             "tiny_sd_fp32", "mmdit_fp32", "mmdit_fp32_latent64")
    sd1_launches, sd1_models, sd1_image = phase_sd1(card)
    runs = [sd1_launches, phase_sd1_slice(card, sd1_models),
            phase_sd1_768(card, sd1_models, SD1_768_STEPS, "bf16")[0],
            phase_checkpoint_sd1(card, sd1_models, sd1_image),
            phase_sd1_int8(card, sd1_models, sd1_image)]
    del sd1_models
    fp32_runs = phase_sd1_fp32(card)
    gc.collect()
    torch.cuda.empty_cache()
    sd3_runs, sd3_source = phase_sd3(card)
    runs += sd3_runs
    runs += [phase_sd3_img2img(card, sd3_source),
             phase_sd3_tiled(card, sd3_source),
             phase_sd3_text(card, sd3_source),
             phase_checkpoint_sd3(card, sd3_source),
             phase_sd3_int8(card, sd3_source),
             phase_sd3_offload(card, sd3_source)]
    del sd3_source
    gc.collect()
    torch.cuda.empty_cache()   # the bf16 SD3 bundle is gone: room for fp32
    fp32_runs += phase_sd3_fp32(card)
    gc.collect()
    torch.cuda.empty_cache()
    trainer, state, train_launches, _ = phase_training(card)
    runs.append(train_launches)
    phase_grad_check(card)
    runs.append(phase_sampling(card, trainer, state))
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()   # the serving bundles are gone: room to train
    trainer, state, train_launches, _ = phase_mmdit_training(card)
    runs.append(train_launches)
    phase_mmdit_grad_check(card)
    runs.append(phase_mmdit_sampling(card, trainer, state))
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    trainer, state, train_launches, _ = phase_vlm_training(card)
    runs.append(train_launches)
    phase_vlm_grad_check(card)
    runs.append(phase_vlm_decoding(card, trainer, state))
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    fp32_runs += phase_train_fp32(card)
    runs += [counts for counts, _ in fp32_runs]
    check(len(runs) == len(paths), f"{len(runs)} path runs for "
          f"{len(paths)} path names")
    fp32_by_path = dict(zip(paths[-len(fp32_runs):],
                            (fp32 for _, fp32 in fp32_runs)))
    pkg = "from_ddpm_to_stable_diffusion_tpu_torch/csrc/"

    def forms_of(k):
        """The masked forms of one kernel: each timed case's record."""
        return [dict(form=case["form"], shape=case["shape"],
                     visible_share=case["visible_share"], **case[k])
                for case in kernels["forms"]]

    def entry(name, src, replaces, k, **kw):
        r = kernels[k]
        if k in kernels_fp32:   # the fp32 form: its source, records, launches
            fwd = k in ("K1", "K5")
            kw.update(
                fp32_source=pkg + ("fp32/flash_f32_fwd.cu" if fwd
                                   else "fp32/flash_f32_bwd.cu"),
                fp32_design=FP32_FWD_DESIGN if fwd else FP32_BWD_DESIGN,
                fp32=kernels_fp32[k],
                fp32_launches_by_path={p: n[k]
                                       for p, n in fp32_by_path.items()})
        return dict(
            name=name, route="cuda", source=pkg + src,
            replaces=TPU_KERNELS + replaces, **kw,
            launches=sum(run[k] for run in runs),
            launches_by_path={p: run[k] for p, run in zip(paths, runs)},
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"])

    def by_route(route, kernel="k1"):
        """K1's (or K4's, K5's, K7's) launches on one of its kernels, from
        the paths' runs."""
        per_path = {p: getattr(run, kernel + "_routes").get(route, 0)
                    for p, run in zip(paths, runs)}
        return dict(launches=sum(per_path.values()),
                    launches_by_path=per_path)

    def by_head_dim(d):
        """K1's launches at head dim ``d``, from the paths' runs."""
        per_path = {p: run.k1_head_dims.get(d, 0)
                    for p, run in zip(paths, runs)}
        return dict(launches=sum(per_path.values()),
                    launches_by_path=per_path)

    for k in ROUTED:
        routes = [getattr(run, k.lower() + "_routes") for run in runs]
        check(all(sum(r.values()) == run[k] for r, run in zip(routes, runs)),
              f"{k}'s launches by route do not add up to its launches: "
              f"{[(r, run[k]) for r, run in zip(routes, runs)]}")
    # the bf16 paths of the joint attention: every K5 / K6 / K7 launch on
    # sm90
    for p, run in zip(paths, runs):
        if p in ("sd3", "sd3_img2img", "sd3_tiled", "sd3_text",
                 "sd3_checkpoint", "sd3_int8", "sd3_offload",
                 "mmdit_training", "mmdit_sampling"):
            for k in ("K5", "K6", "K7"):
                r = getattr(run, k.lower() + "_routes")
                check(r == ({"sm90": run[k]} if run[k] else {}),
                      f"{p}: {k}'s bf16 launches did not all take the sm90 "
                      f"kernel: {r}")
    # the bf16 training paths: every K3 / K4 launch on its sm90 kernel
    for p, run in zip(paths, runs):
        if p in ("training", "vlm_training"):
            for k in ("K3", "K4"):
                r = getattr(run, k.lower() + "_routes")
                check(r == {"sm90": run[k]} and run[k] > 0,
                      f"{p}: {k}'s bf16 launches did not all take the sm90 "
                      f"kernel: {r}")
    print("K3 / K4 launches by kernel: " + "; ".join(
        f"{p} K3 {run.k3_routes} K4 {run.k4_routes}"
        for p, run in zip(paths, runs) if run["K3"] or run["K4"]),
        flush=True)
    print("K5 / K6 / K7 launches by kernel: " + "; ".join(
        f"{p} K5 {run.k5_routes} K6 {run.k6_routes} K7 {run.k7_routes}"
        for p, run in zip(paths, runs) if run["K5"] or run["K7"]),
        flush=True)
    together = "dq, dk and dv together"
    summary = {"kernels": [
        entry("flash_attention_fwd", "flash_attention_sm90.cu",
              "flash_attention.py:242", "K1",
              also_replaces=[TPU_KERNELS + "flash_attention.py:119"],
              design=("bf16 at head dims 40, 48, 64, 72, 80, 128 and every "
                      "mask form: one block of 3 warpgroups per 128 queries, "
                      "a producer issuing TMA (Q once, K/V tiles of 128 keys "
                      "in a 2-stage mbarrier ring, the bias tile staged in "
                      "its own dtype by cp.async) and two consumers running "
                      "wgmma m64n128k16 for S = QK^T from shared memory, "
                      "the online softmax in registers, and wgmma in RS "
                      "form for O += PV with V MN-major; 128-byte swizzle at "
                      "DP 64/128, 32-byte at 48/80"),
              d512=dict(source=pkg + "flash_attention.cu",
                        design=("bf16 at head dim 512: one block of 3 "
                                "warpgroups per 64 queries (and key split), a "
                                "producer issuing TMA (Q once, K and V tiles "
                                "of 64 keys on their own single-stage "
                                "mbarriers) and two consumers, each owning "
                                "256 output columns, splitting S = QK^T by "
                                "keys (wgmma m64n32k16 SS), exchanging row "
                                "maxima under a named barrier, writing P in "
                                "bf16 to a swizzled shared tile and running "
                                "O += PV as wgmma m64n256k16 SS with V "
                                "MN-major; below 132 query tiles the keys "
                                "split over up to 4 blocks, merged by lse"),
                        timed=kernels["d512"], **by_route("d512")),
              sm90=by_route("sm90"),
              d160=dict(
                  design=("bf16 and fp32 at head dim 160 (SD1's UNet at "
                          "level 2 from 768^2): the sm90 kernel with 32-byte "
                          "swizzle atoms of 16 columns and O += PV as "
                          "m64n160k16 RS; in fp32 the TF32 kernel with one "
                          "consumer and 64-query blocks, PV in two halves of "
                          "80 columns"),
                  timed=kernels["d160"], **by_head_dim(160)),
              timed_at="(B,H,Lq,Lk,D)=(2,8,4096,4096,40)",
              library="F.scaled_dot_product_attention", forms=forms_of("K1")),
        entry("group_norm_silu", "groupnorm.cu", "groupnorm_pallas.py:29",
              "K2", timed_at="(2,64,64,320) + SiLU",
              design=("bf16 and fp32, one cooperative launch a call: a "
                      "persistent grid of at most one block per SM, each "
                      "owning a chunk of one batch's rows, loaded by 1-D "
                      "bulk copies into mbarrier slots of shared memory "
                      "while every thread folds them into per-channel "
                      "Welford statistics; block merge (Chan), per-(batch, "
                      "group, chunk) partials, one grid barrier, every "
                      "block merging the partials in one fixed order, then "
                      "x * mul + add (+ SiLU) from the rows still in shared "
                      "memory with 16-byte stores; where the rows do not "
                      "fit, a ring of slots that reloads them after the "
                      "barrier in reverse order"),
              device_ms=kernels["K2"].get("device_ms"),
              shapes=kernels["K2 shapes"],
              launch_path_us=kernels["K2 launch path us"],
              library="F.group_norm + F.silu"),
        entry("flash_attention_bwd_dq", "flash_attention_dq_sm90.cu",
              "flash_attention.py:682", "K3", plain_computes=together,
              library_computes=together,
              design=("bf16 at head dims 64 and 128 in every form: one block "
                      "of 3 warpgroups per 128 queries, a producer issuing "
                      "TMA (Q and dO once, K and V tiles of 64 keys in a "
                      "2-stage mbarrier ring, the bias tile staged by "
                      "cp.async) and two consumers of 64 queries with their "
                      "lse and delta in registers computing S = QK^T and "
                      "dP = dOV^T (wgmma m64n64k16 SS), P and dS in "
                      "registers, dS the RS A operand of dQ += dS K with K "
                      "read MN-major from the same tile; dQ in registers "
                      "until the end"),
              sm90=by_route("sm90", "k3"),
              timed_at="(B,H,Lq,Lk,D)=(32,1,4096,4096,128)",
              library="backward of F.scaled_dot_product_attention",
              forms=forms_of("K3")),
        entry("flash_attention_bwd_dkv", "flash_attention_bwd_sm90.cu",
              "flash_attention.py:764", "K4", plain_computes=together,
              library_computes=together,
              design=("bf16 at head dims 64 and 128 in every form: one block "
                      "of 3 warpgroups per 128 keys, a producer issuing TMA "
                      "(K and V once, Q and dO tiles of 64 queries in a "
                      "2-stage mbarrier ring, lse and delta stored beside "
                      "them, the bias tile staged by cp.async) and two "
                      "consumers of 64 keys computing S^T = KQ^T and dP^T = "
                      "VdO^T with the keys as wgmma's M (m64n64k16 SS), P^T "
                      "and dS^T in registers as the A operand of dV += "
                      "P^T dO and dK += dS^T Q (wgmma RS, dO and Q MN-major)"),
              sm90=by_route("sm90", "k4"),
              timed_at="(B,H,Lq,Lk,D)=(32,1,4096,4096,128)",
              library="backward of F.scaled_dot_product_attention",
              forms=forms_of("K4")),
        entry("flash_attention_fwd_pos", "flash_attention_sm90.cu",
              "flash_attention.py:1237", "K5",
              design=("bf16 at head dims 64 and 128, online and bounded: "
                      "K1's design under position masks, on K1's per-tile "
                      "steps (3 warpgroups per block; a producer issuing "
                      "TMA over 4-D tensor maps of the operands' own "
                      "strides, Q double-buffered and K/V tiles of 128 keys "
                      "in a 2-stage mbarrier ring; two consumers of 64 query "
                      "rows running wgmma m64n128k16 for S = QK^T, the "
                      "softmax in registers and wgmma RS for O += PV); a "
                      "persistent grid of one block per SM walking 128-query "
                      "tiles, so the next tile's loads overlap this one's "
                      "last products and epilogue; every role skips the "
                      "same (query tile, key tile) pairs from their position "
                      "bounds and masks per logit where a pair is partly "
                      "visible; the bounded form fixes the max at 0"),
              sm90=by_route("sm90", "k5"), shapes=kernels["K5 shapes"],
              timed_at="(B,H,Lq,Lk,D)=(2,24,4096,4096,64) online",
              library="F.scaled_dot_product_attention"),
        entry("flash_attention_bwd_pos_dq", "flash_attention_dq_sm90.cu",
              "flash_attention.py:1446", "K6", plain_computes=together,
              library_computes=together,
              design=("bf16 at head dims 64 and 128: the position-mask form "
                      "of K3's kernel (one block of 3 warpgroups per 128 "
                      "queries, a producer issuing TMA for Q and dO once "
                      "and K and V tiles of 64 keys in a 2-stage ring; two "
                      "consumers of 64 queries with the caller's global "
                      "lse and delta in registers computing S and dP with "
                      "wgmma m64n64k16 SS, dS in registers as the RS A "
                      "operand of dQ += dS K with K MN-major); every role "
                      "skips the same pairs from their position bounds, "
                      "masked P selected to 0"),
              sm90=by_route("sm90", "k6"), shapes=kernels["K6"]["shapes"],
              timed_at="(B,H,Lq,Lk,D)=(2,24,4096,4096,64), global lse",
              library="backward of F.scaled_dot_product_attention"),
        entry("flash_attention_bwd_pos_dkv", "flash_attention_bwd_sm90.cu",
              "flash_attention.py:1504", "K7", plain_computes=together,
              library_computes=together,
              design=("bf16 at head dims 64 and 128: the position-mask form "
                      "of K4's kernel (one block of 3 warpgroups per 128 "
                      "keys, a producer issuing TMA for K and V once and Q "
                      "and dO tiles of 64 queries in a 2-stage ring, the "
                      "caller's global lse and delta stored beside them; "
                      "two consumers of 64 keys computing S^T and dP^T with "
                      "the keys as wgmma's M, P^T and dS^T in registers as "
                      "the RS A operand of dV += P^T dO and dK += dS^T Q); "
                      "every role skips the same pairs from their position "
                      "bounds, masked P selected to 0"),
              sm90=by_route("sm90", "k7"), shapes=kernels["K7"]["shapes"],
              timed_at="(B,H,Lq,Lk,D)=(2,24,4096,4096,64), global lse",
              library="backward of F.scaled_dot_product_attention"),
    ]}
    print(card)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        sys.exit(1)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
