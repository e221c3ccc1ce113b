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
   (``cuobjdump -sass``) and fails unless every instantiation the tables
   SM90_KERNELS and FP32_KERNELS count has both: the sm90 K1, K3 and K4 at
   every width in every form, K5, K6 and K7 at every width
   (``csrc/flash_attention{,_dq,_bwd}_sm90.cuh``), the d = 512 K1
   (``csrc/flash_attention.cu``), the TF32 fp32 forward and backward in
   every form (``csrc/fp32/``).
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
   Then the head_dims group: K1, K3 and K4 at every head dim up to 256
   (``phase_kernels_head_dims``), and its forms phase
   (``phase_kernels_forms``): the fp32 bias (with dbias), segment-id and
   causal forms of K1, K3 and K4 and K5, K6, K7 online and bounded in both
   dtypes at head dims 8 - 256 against their plain versions (fp32 against
   fp64, within FORMS_FP64_RATIO of the no-mask form's error), then timed
   at full width: a (1, 8, 4096, 4096) fp32 bias at (2, 8, 4096, 4096, 128),
   packed segment ids at (2, 12, 4096, 4096, 64), and SD3-medium's joint
   attention cut into heads of 32 - 256; above 256 K1, K3 and K4 in every
   mask form (``phase_kernels_wide_heads``) and K5, K6 and K7 in every
   position form (``phase_kernels_wide_pos``: at d 264 - 512 against the
   plain versions, then SD3-medium's joint attention cut into heads of 384
   and 512 forward and backward, and the 4-shard ring at heads of 512, as
   paths of their own).
4. SD1: full-width SD1 (CLIP, 860M UNet, VAE decoder) with random weights
   from a seed, ``SD1Generator`` at 512x512, 50 k-LMS steps, CFG 7.5: one
   batch-1 request, then one batch-4 request. Checks the images, the final
   latents, the kernel launch counts of every request, and that K1 took the
   sm90 kernel (the VAE's d = 512 attention aside). Then one profiled
   request at batch 1 and one at batch 4: device-busy ms, idle share and
   K1's share of the device time. Then the rest of
   the generator on the same bundle: a request with each of the four
   samplers and one with ``do_cfg=False`` at 20 steps, img2img at strength
   0.8 from a seeded uint8 image (40 steps; the VAE encoder's attention is
   one K1 launch at head dim 512), the same ``per_sample_seeds`` entry at
   batch 1 and inside a batch of 4 (equal initial latents, bit for bit),
   and a weighted prompt through the tokenizer with a synthetic vocabulary.
   Then serving on the same bundle: the ``generate_fn`` of
   ``cli/serve.py`` behind ``DynamicBatcher(buckets=(1, 2, 4, 8),
   max_wait_ms=25)`` and ``make_server(port=0)`` on 127.0.0.1, each bucket
   warmed and then timed once (imgs/s per bucket against bucket 1), and
   client threads sending one request alone (JSON), a burst of 8, a burst of
   3 (bucket 4, one padded slot) and one PNG request: the burst of 8 in at
   most 2 batches, every served image against a direct ``SD1Generator``
   call of its batch (bit for bit, at most 1 level), a seed alone against
   the same seed in the burst of 8 (at most 11 levels, mean 2), the PNG
   decoded with zlib against the JSON body, K1 501 and K2 3080 launches per
   served batch, on the batcher's worker thread; p50 / p95 latency and one
   bucket-8 batch profiled (device busy, idle share). Then ``cli/sd1.py
   generate`` at 512^2 and 50 steps with random weights (its PNG decoded)
   and ``python -m from_ddpm_to_stable_diffusion_tpu_torch serve --help``.
   Then a
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
   differ; a ``(word:1.3)`` prompt with ``prompt_weighting``; 10 steps
   each). After the
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
   forward, over T = 100 steps (the trained weights under a config with a
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

Trainer features (after 8, after 11 and after 14): (a) gradient
accumulation, ``TinySDConfig(ema_decay=0.9999, grad_accum=4)``: 8 micro-
steps, each checked bit for bit (parameters and EMA held on the 3 that do
not emit, moved on the 4th), then 8 more timed by CUDA events (ms per
micro-step and per update beside the training phase's ms/step); (b)
checkpoint / resume: ``fit(checkpoint_dir=)`` at ``TinySDConfig(grad_accum=
2)`` with the device prefetch, cut by a SIGTERM raised from inside the
loader in epoch 1, in the middle of a window; a fresh trainer restores the
checkpoint and every tensor (parameters, moments, EMA, accumulator,
generator state) is bit-equal to what was saved; save and restore seconds,
bytes on disk; (d) latent-space tiny-SD at the reference's
``03_train_with_vae`` point: 512^2 images encoded by the SD1 / SDXL-VAE
``VAEEncoder`` (bf16, random weights) to 64^2 x 4 latents, batch 32, 2 + 5
steps through ``fit`` (ms/step split into encode and UNet), then 4 images
sampled over SAMPLE_T steps and decoded to 512^2; (c) after the MMDiT
phases, LoRA (rank 8) with ``grad_accum=2`` on the depth-24 MMDiT at the
MMDiT phase's operating point: 2 + 4 micro-steps, the frozen base
bit-identical, every B adapter moved, ms per micro-step and peak GiB
beside full training's, the LoRA state through a checkpoint bit for bit;
(e) after the TinyVLM phases, ``VLMTrainer.fit(checkpoint_dir=)`` for one
short epoch, the file read back bit for bit. Checkpoints go to TMPDIR and
are deleted.

The trainable model zoo (group ``zoo``, after the TinyVLM phases), each
through its CLI's ``main(argv)`` at the CLI defaults' width with the epoch,
clip and batch counts cut: K1 (256 and 48 x 1 x 1024^2 x 64), K3 / K4 (256
x ...) and K2 ((256, 32, 32, 64) + SiLU) at the video UNet's level-0
shapes against their plain versions; ``video train`` (channel 64, 32^2, 8
frames, batch 32, bf16; 2 epochs of 6 steps, CFG sampling of 3 clips over
``--T 50``, cut from 400): ms/step, frames/s, device idle share, peak
memory, K1 / K3 / K4 / K2 launches per step against the model's count;
``vae train --synthetic`` with ``--model vqvae`` and ``--model vanilla``
(512^2, batch 7, one epoch of 8 steps, its checkpoint in TMPDIR): ms/step,
peak memory, the VQ codes used; ``vit train --synthetic`` (128^2, patch 32,
dim 512, depth 6, batch 256, one epoch of 8 steps) and its ``evaluate``:
ms/step, accuracy. Each model's train step on the card (bf16, kernels)
against the same step on the CPU (fp32, plain versions) from the same
weights and draws, the loss and gradients within the gradient check's
tolerance.

Stage 05 and evaluation (group ``clip_eval``, last): first K1, K3 and K4
at the CLIP training's attention shape, (32, 16, 577, 577, 64), whose last
tile of 64 keys holds one key, against the plain version in bf16 (sm90;
times, device time, library, bound) and in fp32 (the TF32 kernels; their
times and precision faults among the fp32 kernel phase's cases), each
beside two planted faults of that tail (the last key dropped, its logits
doubled) that must fall outside the tolerance; then ``CLIP()`` at its
defaults (ViT-L/14 at 224^2, 427,616,513 parameters; random weights from
seed 0) in fp32 and bf16: ``encode_image``, ``encode_text`` and the logits
on a batch of 32, ``clip_score`` and ``clip_fid`` on two sets of 64 images,
the card against the CPU on 2 pairs (no kernel: 257 tokens);
``CLIPTrainer`` at ViT-L/14@336px (577 tokens), bf16 over fp32 parameters,
batch 32 on one fixed batch: 2 steps through ``fit``, 5 timed, 2 profiled
(ms/step, img/s, idle share, peak; K1 / K3 / K4 24 launches each a step on
sm90; the loss falling, ``logit_scale`` <= ln 100) and a card-against-CPU
gradient check at 2 + 2 layers; one fp32 step at 336^2 (the fp32 K1 / K3 /
K4 at d = 64); the FID InceptionV3 from a synthetic pytorch-fid checkpoint
through ``import_inception_fid``: ``inception_features`` of 64 images from
512^2 (the antialiased downsample) and 64 from 64^2, ``inception_fid``,
``kid_from_features``, ms per image, the card against the CPU; then
``checks all --device cuda`` in process (fp32 K1 at head dims 8 (checks
sd1), 64 and 128 counted) and through ``python -m``, ``checks weights``,
``checks clip --ckpt`` on ``CLIP()`` in the OpenAI layout (where Pillow is
installed), and ``demos replicate`` / ``multimodal`` / ``video``, each
stopping with its actionable error. K1 in fp32 at head dim 8 is held
against its plain version in the fp32 kernel phase, its bound counting the
exponentials at the SFU's rate.

The trajectory group (after the tp_fsdp stretch of SD1, on the resident
bf16 bundle): ``SD1Generator(loop="trajectory")``, the whole denoise loop
as one captured CUDA graph per (batch, start_step), against
``loop="steps"`` on the same draws at 512^2 / 10 k-LMS steps / CFG 7.5:
the captures at batch 1 and 4 with the K1 / K2 launches inside each graph,
a second seed through the batch-1 graph, img2img at strength 0.6,
``k_euler_ancestral`` and TP over {"model": 2} of the card repeated, each
replay's final latents bit-equal to the eager loop's or its image within 1
level; both loops' s/image, ms per denoise step and device idle share at
batch 1 and 4; an eager request bit-equal to the first after every graph
is freed. The dp group (after clip_eval): one step of the VAE, ViT, CLIP
and VLM trainers over {"data": 2} of the card repeated against the
meshless step. The native group (last): ``io/native.py``'s g++ build into
``_build/``, its tokenizer's ids against ``io/tokenizer.py`` and its
safetensors reader, which ``load_safetensors_dict`` must take, bit for bit
against the Python reader on a 268 MB file. The seconds of every group of
phases are printed before the summary.

Every kernel's launch count is set to 0 just before each of the SD1, SD1
generator, SD1 trajectory, serving, SD1 CLI, SD1 at 768^2, SD1 checkpoint, SD1 int8, SD3,
SD3 img2img, SD3
batch 2 tiled, SD3 text, SD3 checkpoint, SD3 int8, SD3 offload, training,
sampling, accumulation, resume, latent training, latent sampling, MMDiT
training, MMDiT sampling, MMDiT LoRA, T5, TinyVLM training, TinyVLM
decoding, TinyVLM checkpoint, video training, video sampling, VQ-VAE,
VanillaVAE, ViT, CLIP forward, CLIP training, FID, data-mesh trainer steps,
checks, SD3 through the
ring and the Ulysses MMDiT, the pipelined blocks, 1F1B, ring MMDiT training,
the TP and TP x SP SD3 requests and MMDiT steps, MoE forward, MoE training
and fp32 paths
and read
just after (before the plain-attention run it is compared with), K1's also
by the kernel it ran (sm90, d512, fp32) and by head dim, K3's - K7's (but
K2) by the kernel they ran (sm90, fp32): on every path the launches by
kernel add up to the launches, on the bf16 SD3 and MMDiT paths (the
parallel ones too) every K5, K6 and K7 launch took sm90, and on the bf16
tiny-SD (plain, accumulated, resumed, latent), TinyVLM and video training
paths every K3 and K4 launch took sm90. The ``parallel`` group (its seconds
summed over four stretches) runs on meshes of the one card repeated
([cuda] * n): the ring at the MMDiT's (2, 24, 4252, 64) with kv_valid_len
4250 against the one-device joint attention and plain, forward and
backward, and causal zig-zag at (1, 8, 16384, 64) against K1 / K3 / K4
causal, n^2 K5, K6 and K7 launches a call, the hop kernels at (2, 24, 1063,
1063, 64) with bound and library; an SD3 request through the ring and the
Ulysses MMDiT against the flash one; the pipelined joint blocks and a 1F1B
step; ring MMDiT training at SD3's operating point against the flash
gradient; the 4-expert MMDiT forward over an expert axis against no mesh
and a 2-expert training step with its balance loss. The ``tp_fsdp`` group
(four stretches) adds tensor parallelism over {"model": 2} and, composed
with the ring over {"seq": 2}, TP x SP: K5 / K6 / K7 at the hop (2, 12,
2125, 2125, 64) against their plain versions; a 4-step SD3 request
through ``SD3Inferencer(mesh=)`` over a ring MMDiT on one {"seq": 2,
"model": 2} mesh, in levels against the meshless request; the MMDiT
trainer on {"data": 1, "seq": 2, "model": 2} with ring attention, its
gradient against the meshless one, 192 K5 / K6 / K7 a step, and a
Ulysses step. ``python3 chip_smoke.py sd3_batch_levels N`` runs only the
measurement behind SD3's batch-2 level bound, over N seeds. The last two
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
import os
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
SD1_768_STEPS, SD1_768_FP32_STEPS = 10, 5   # cut from 20, 10 for vae_grad
SD1_768_PER_STEP = {40: 5, 80: 5, 160: 5}
# Tiny-SD UNet forward: 6 self-attentions of >= 512 tokens (enc1, dec6,
# dec7 at 64^2; enc3, dec4, dec5 at 32^2) take K1, and their backward K3
# and K4; 39 GroupNorms (28 in 14 ResBlocks, 10 TransformerBlock norm_in,
# the tail). The GroupNorm backward is plain PyTorch, so no K2 there.
TRAIN_PER_STEP = dict(K1=6, K3=6, K4=6, K2=39, K5=0, K6=0, K7=0)
# the chain cut from the reference's T = 1000 (to 100, then 50 to pay for
# the wide heads phase)
SAMPLE_T = 50
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
# exponentials (MUFU.EX2) a second: 16 results per SM per clock (the CUDA C++
# Programming Guide's throughput table, compute capability 9.0) on 132 SMs
# at the 1.98 GHz boost clock
PEAK_SFU_EXP2 = 16 * 132 * 1.98e9
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
    """Both libraries built at once (bf16 + GroupNorm; fp32 flash), each
    source its own nvcc. Returns a function that checks both libraries'
    SASS listings (:func:`sass_check`): each listing is read by cuobjdump
    in the background as soon as its library is built, while the other
    may still compile and then while the kernel phase runs."""
    from concurrent.futures import ThreadPoolExecutor

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import _build

    names = ("kernels", "kernels_fp32")
    pool = ThreadPoolExecutor(len(names))

    def build(name):
        t0 = time.perf_counter()
        _build.load(name)
        wall = time.perf_counter() - t0
        return wall, pool.submit(sass_of, _build.library_path(name))

    with ThreadPoolExecutor(len(names)) as builders:
        walls, listings = zip(*builders.map(build, names))
    pool.shutdown(wait=False)

    def check_sass():
        t0 = time.perf_counter()
        sass = [f.result() for f in listings]
        waited = time.perf_counter() - t0
        sass_check(sass[0], SM90_KERNELS, BF16_FAMILY)
        sass_check(sass[1], FP32_KERNELS, FP32_FAMILY)
        print(f"SASS listings: waited {waited:.2f} s for cuobjdump, checked "
              f"in {time.perf_counter() - t0 - waited:.2f} s", flush=True)

    for name, wall in zip(names, walls):
        nvcc, log = _build.builds[name]
        print(f"build {name}: {wall:.2f} s, the two together (nvcc "
              f"{'cached' if nvcc is None else f'{nvcc:.2f} s'}) -> "
              f"{_build.library_path(name).name}", flush=True)
        for line in log.splitlines():
            # C75xx: ptxas serialised or fenced wgmma instructions itself
            if ("Used" in line or "spill" in line or "Compiling" in line
                    or "(C75" in line):
                print("  ptxas:", line.strip().removeprefix("ptxas info    :"))
    return check_sass


# The sm90 K1 and K3 instantiations: 16 padded head dims (16, 32, ..., 256)
# without a mask, 7 mask forms at head dims 64 and 128 and one form with
# every mask path (ANY) at the 14 others; the sm90 K4 the same at its 12
# widths (16 - 128, then 160, 192, 224, 256); K1 above 256 (the d512
# kernel) at the widths 384 and 512 without a mask and ANY, and K3 / K4
# above 256 (a cluster pair, a kernel for each role) the same; the sm90 K5: online
# and bounded at K1's 16 widths; K6 at K3's 16, K7 at K4's 12.
SM90_KERNELS = {  # kind -> (kernel name, instantiations)
    "K1 sm90": ("flash_fwd_sm90_kernel", 16 + 2 * 7 + 14),
    "K1 d512": ("flash_fwd_d512", 2 * 2),
    "K3/K4 wide": ("flash_bwd_wide_sm90_kernel", 2 * 2 * 2),
    "K3 sm90": ("flash_bwd_dq_sm90_kernel", 16 + 2 * 7 + 14),
    "K4 sm90": ("flash_bwd_dkv_sm90_kernel", 12 + 2 * 7 + 10),
    "K5 sm90": ("flash_fwd_pos_sm90_kernel", 16 * 2),
    "K6 sm90": ("flash_bwd_pos_dq_sm90_kernel", 16),
    "K7 sm90": ("flash_bwd_pos_dkv_sm90_kernel", 12),
}
# The names of the kernels above, and of any other bf16 flash kernel: one
# outside the table fails the check.
BF16_FAMILY = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_pos_dkv",
               "flash_bwd_dq", "flash_bwd_pos_dq", "flash_bwd_wide")
# The fp32 forward (TF32 split): 13 widths without a mask (8 for the checks
# sd1 UNet, 40, 48, 64, 72, 80, 128, 160 at DP = d, and 16, 32, 96, 112, 144
# for the head dims padded to 16) and masked online at each (K1 causal, K5),
# K5 bounded and ANY (K1 with a bias or segment ids) at the 5 widths 32 -
# 160, T5's bias form; the streaming kernel at the widths 192, 224, 256 in
# its 4 forms (no mask, causal, ANY, bounded), at 384 without a mask,
# causal, ANY and bounded (K5), at 512 causal, ANY and bounded, and at 512
# without a mask under its own name. The fp32 backward (TF32 split): dq and dk/dv at the 8 widths 16
# - 128 without a mask and masked (K3 / K4 causal, K6 / K7), ANY at 32, 64,
# 96, 128, the two-block (one cluster) dq and dk/dv at the 4 widths 160 -
# 256 without a mask, masked and ANY, and the streaming dq and dk / dv
# kernels (one cluster pair each) at 384 and 512 without a mask and ANY.
FP32_KERNELS = {
    "K1/K5 fp32": ("flash_fwd_f32_kernel", 13 + 13 + 5 + 5 + 1),
    "K1/K5 fp32 wide": ("flash_fwd_f32_wide_kernel", 3 * 4 + 4 + 3),
    "K1 fp32 d512": ("flash_fwd_f32_d512_kernel", 1),
    "K3/K6 fp32": ("flash_bwd_dq_f32_kernel", 16 + 4),
    "K4/K7 fp32": ("flash_bwd_dkv_f32_kernel", 16 + 4),
    "K3/K6 fp32 wide": ("flash_bwd_dq_f32_wide_kernel", 3 * 4),
    "K4/K7 fp32 wide": ("flash_bwd_dkv_f32_wide_kernel", 3 * 4),
    "K3/K4 fp32 stream": ("flash_bwd_f32_stream_kernel", 2 * 2 * 2),
}
FP32_FAMILY = ("flash_fwd", "flash_bwd")


def sass_of(library):
    """The SASS listing of a built library (cuobjdump -sass)."""
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


def sass_check(sass, table, family):
    """Counts, in each kernel of a library's SASS listing (:func:`sass_of`)
    whose name holds one of ``family``, the wgmma (HGMMA) and TMA (UTMALDG,
    UBLKCP) instructions, and checks that every instantiation ``table``
    names has both and that no kernel of ``family`` is outside it."""
    counts = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        if any(key in name for key in family):
            counts[name] = [body.count("HGMMA"),
                            body.count("UTMALDG") + body.count("UBLKCP")]
    found = {kind: {f: c for f, c in counts.items() if key in f}
             for kind, (key, _) in table.items()}
    names = {"K1 sm90": "causal/bias/segments", "K3 sm90":
             "causal/bias/segments", "K4 sm90": "causal/bias/segments",
             "K5 sm90": "bounded", "K1/K5 fp32": "masked/bounded/bias/any",
             "K3/K6 fp32": "masked/any", "K4/K7 fp32": "masked/any",
             "K3/K6 fp32 wide": "masked/any", "K4/K7 fp32 wide": "masked/any",
             "K1/K5 fp32 wide": "form", "K1 d512": "any",
             "K3/K4 wide": "any/dkv", "K3/K4 fp32 stream": "any/dkv"}
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
            f"the {kind} kernels: {len(fns)} of {table[kind][1]}, wgmma and "
            f"TMA in their SASS lacking: {fns}")
    check(len(counts) == sum(n for _, n in table.values()),
          f"{'/'.join(family)} kernels off the TMA / wgmma routes: "
          f"{sorted(set(counts) - {f for fns in found.values() for f in fns})}")


# The four (Lq, Lk) of the SD3 / MMDiT joint attention: 154 context and 4096
# x tokens (latent 128), each query stream against each key stream.
SD3_JOINT_SHAPES = ((154, 154), (154, 4096), (4096, 154), (4096, 4096))

# K1's timed cases, which compare_revisions.py times too. Without a mask,
# (B, H, Lq, Lk, D): the first is reported (SD1 UNet at 64^2); then the SD3
# VAE's mid attention over 128 x 128 tokens (decoder and encoder at batch
# 1, the tiled decode's head at batch 2) and the SD1 VAE encoder's over 64 x
# 64 at batch 32 (latent tiny-SD: 512^2 images).
K1_SHAPES = [(2, 8, 4096, 4096, 40), (2, 8, 1024, 1024, 80),
             (1, 1, 4096, 4096, 512), (1, 2, 1000, 777, 80),
             (32, 1, 4096, 4096, 128), (32, 2, 1024, 1024, 128),
             (1, 2, 1000, 777, 128), (1, 1, 16384, 16384, 512),
             (2, 1, 16384, 16384, 512), (32, 1, 4096, 4096, 512)]
# K2's timed cases, (shape, act, dtype), which compare_revisions.py times
# too: the first is reported (SD1 UNet at 64^2, CFG batch 2); then its other
# levels and batch 8, the SD1 VAE decoder's 512^2 level in both dtypes,
# tiny-SD's batch 32, the largest and the widest GroupNorm of the SD3 VAE
# decoder, the SD1 VAE encoder's largest at batch 32 (latent tiny-SD, 512^2
# images: 2^30 values). The smaller keep their rows in shared memory, the
# larger stream.
GN_CASES = [((2, 64, 64, 320), "silu", "bf16"),
            ((2, 32, 32, 640), "silu", "bf16"),
            ((2, 8, 8, 1280), "silu", "bf16"),
            ((8, 64, 64, 320), "silu", "bf16"),
            ((1, 512, 512, 128), None, "bf16"),
            ((1, 512, 512, 128), None, "fp32"),
            ((32, 64, 64, 128), "silu", "bf16"),
            ((1, 1024, 1024, 128), "silu", "bf16"),
            ((1, 128, 128, 512), "silu", "bf16"),
            ((32, 512, 512, 128), "silu", "bf16")]
# K1 at head dim 160 (SD1's UNet at level 2 from 768^2: 576 tokens, 8 heads
# of 160, batch 2 with CFG); kept apart from K1_SHAPES, which
# compare_revisions.py also times on checkouts from before d = 160.
K1_D160_SHAPE = (2, 8, 576, 576, 160)
# K1 in fp32 at head dim 8: the level-0 self-attention of the ``checks sd1``
# UNet (SD1UNet(model_channels=64), 8 heads) on its 32^2 latent; apart from
# the fp32 cases compare_revisions.py times on older checkouts
K1_D8_SHAPE = (1, 8, 1024, 1024, 8)
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
    ``k3_routes`` - ``k7_routes`` (but K2's): K3's - K7's
    (``.routes`` of their wrappers: "sm90", "wide", "d512" (K5), "fp32");
    ``k1_head_dims`` - ``k7_head_dims`` (but K2's): their launches by head
    dim."""


ROUTED = ("K1", "K3", "K4", "K5", "K6", "K7")  # counted by route


def read_counts():
    fns = kernel_counters()
    counts = Counts((k, fn.launches) for k, fn in fns.items())
    for k in ROUTED:
        setattr(counts, k.lower() + "_routes",
                dict(getattr(fns[k], "routes", {})))
    for k in ROUTED:
        setattr(counts, k.lower() + "_head_dims",
                dict(getattr(fns[k], "head_dims", {})))
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
        # (a window whose K2 rows are not a whole number a call lost some of
        # the profiler's records: it is profiled again, up to three)
        fams, rows, n_k2 = {}, [], 0
        for _ in range(3):
            _, _, fams, _, rows = profile_device(lambda: [run()
                                                          for _ in range(10)])
            n_k2 = sum(n for _, n, key in rows
                       if _family(key) == "K2 group norm")
            if "K2 group norm" in fams and n_k2 % 10 == 0:
                break
        device_ms = fams.get("K2 group norm", 0.0) / 10 or None
        per_call = n_k2 / 10
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
    # a second batch-1 request was cut to pay for the trajectory group,
    # which times both loops at batch 1 and 4
    requests = [(prompts[:1], 1), (prompts, 3)]

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
    # One profiled request at batch 1 (after the counted ones): device busy
    # time, idle share against the unprofiled request of the same batch,
    # and K1's share of the device time (a batch-4 profile is cut to pay
    # for the tp_fsdp group)
    for prompt_batch, seed in ((prompts[:1], 1),):
        b = len(prompt_batch)
        for _ in range(3):  # a profile that recorded no kernel is run again
            n0 = read_counts()["K1"]
            # the device alone: the host's operator events of a request
            # cost tens of seconds in key_averages and nothing here reads
            # them
            images, wall_ms, fams, n_kernels, rows = profile_device(
                lambda: sd(prompt_batch, seed=seed), cpu=False)
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
                lambda: request(seed), cpu=False)
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
SD3_INT8_PROFILE_STEPS = 5    # cut from 10 to pay for the wide heads phase
# Image levels, batch-2 sample against its batch-1 request: cuBLAS and
# cuDNN pick their algorithms by batch, which moves bf16 roundings; PERF.md
# section 7 records up to 11 levels (mean 1.2) for SD1 between batch 1 and
# 4. The tiled decode against the whole one differs by the same kind of
# rounding (fp32 statistics summed in another order, convs over strips).
# SD3-medium at 1024^2 / 50 steps is a longer chain over a larger batch
# change (MMDiT batch 2 -> 4): `python3 chip_smoke.py sd3_batch_levels 4`
# measured sample 0 against its batch-1 request at 11, 11, 12, 11 levels,
# mean 1.2645 - 1.2700, for seeds 1 - 4 (PERF.md section 6); the bound is
# the largest of them plus one level, and the largest mean plus 10 %.
SD3_BATCH_LEVELS_MAX, SD3_BATCH_LEVELS_MEAN = 13, 1.4
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
          f"{SD3_BATCH_LEVELS_MAX} / {SD3_BATCH_LEVELS_MEAN}); launches "
          f"request "
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
    check(bw[0] <= SD3_BATCH_LEVELS_MAX
          and bw[1] <= SD3_BATCH_LEVELS_MEAN,
          f"sample 0 against its batch-1 request: {bw}")
    check(req == want_req and got == want,
          f"SD3 batch-2 launches {req} / {got} != {want_req} / {want}")
    check(launches.k1_routes == {"d512": want["K1"]},
          f"SD3 batch-2 K1 routes {launches.k1_routes}")
    return launches


def sd3_batch_levels(n_seeds):
    """The measurement behind SD3_BATCH_LEVELS_MAX / _MEAN, outside the
    timed groups (``python3 chip_smoke.py sd3_batch_levels [n_seeds]``):
    the SD3-medium bundle of ``phase_sd3`` at 1024^2, SD3_STEPS flow-Euler
    steps, CFG 5, shift 3; for seeds 1 .. n, sample 0 of a batch-2 request
    (``per_sample_seeds=[seed, None]``, decoded whole) against the batch-1
    request of its seed: max and mean levels per seed."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer, SD3Models)

    card = phase_device()
    phase_build()
    models = SD3Models.initialize(
        torch.Generator(device="cuda").manual_seed(0), "cuda", "bf16",
        depth=SD3_DEPTH, pos_embed_max_size=192)
    inf = SD3Inferencer(models, shift=3.0, decode_mode="whole")
    kw = dict(width=1024, height=1024, steps=SD3_STEPS, cfg_scale=5.0)
    worst = (0, 0.0)
    for seed in range(1, n_seeds + 1):
        t = time.perf_counter()
        one = inf.gen_image(np.zeros((1, 77), np.int32), seed=seed, **kw)
        two = inf.gen_image(np.zeros((2, 77), np.int32), seed=seed,
                            per_sample_seeds=[seed, None], **kw)
        lv = levels(two[:1], one)
        worst = (max(worst[0], lv[0]), max(worst[1], lv[1]))
        print(f"SD3 batch-2 sample 0 against its batch-1 request (1024^2, "
              f"{SD3_STEPS} steps, CFG 5, seed {seed}): max {lv[0]} mean "
              f"{lv[1]:.4f} levels ({time.perf_counter() - t:.1f} s) "
              f"[{card}]", flush=True)
        check(one.shape == (1, 1024, 1024, 3) and float(one.std()) > 0,
              f"SD3 seed {seed}: image misshaped or constant")
    print(f"SD3 batch levels over seeds 1-{n_seeds}: largest max {worst[0]},"
          f" largest mean {worst[1]:.4f} (bound in force "
          f"{SD3_BATCH_LEVELS_MAX} / {SD3_BATCH_LEVELS_MEAN}) [{card}]",
          flush=True)
    if FAILURES:
        sys.exit(1)


# the text entry's three requests compare ids and weights, not the
# operating point: 10 steps (cut from 50 to make room for the serving phase)
SD3_TEXT_STEPS = 5    # cut from 10 to pay for the wide heads phase


def phase_sd3_text(card, source):
    """The text entry points with a synthetic CLIP vocabulary and a
    synthetic SentencePiece model written by the port's
    ``build_spm_model``: ``gen_image_text`` against ``gen_image`` on the
    tokenizer's ids (0 values may differ), then a ``(word:1.3)`` prompt with
    ``prompt_weighting=True``; 1024^2, ``SD3_TEXT_STEPS`` steps, the warm
    seed."""
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
    kw = dict(steps=SD3_TEXT_STEPS, cfg_scale=5.0, seed=source["seed"])
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
    want = {k: 3 * n for k, n in sd3_counts(1, 30, SD3_TEXT_STEPS).items()}
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
    # where an int8 request's device time goes (after the counted run), on
    # a request of SD3_INT8_PROFILE_STEPS steps, unprofiled then profiled
    # (cut from 50 steps to pay for the tp_fsdp group)
    short = lambda: inf.gen_image(np.zeros((1, 77), np.int32),
                                  steps=SD3_INT8_PROFILE_STEPS, cfg_scale=5.0,
                                  seed=source["seed"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    short()
    torch.cuda.synchronize()
    short_ms = (time.perf_counter() - t) * 1e3
    _, wall_ms, fams, n_kernels, rows = profile_device(short, cpu=False)
    busy = sum(fams.values()) or float("nan")
    print(f"SD3 int8 profile of one request of {SD3_INT8_PROFILE_STEPS} "
          f"steps (torch.profiler, kernel rows only): device busy "
          f"{busy:.1f} ms over {n_kernels} kernels; wall under the profiler "
          f"{wall_ms:.1f} ms, unprofiled {short_ms:.1f} ms; device idle "
          f"share {1.0 - busy / short_ms:.3f} [{card}]", flush=True)
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
                     ("flash_bwd_wide", "K3/K4 flash bwd wide"),
                     ("flash_bwd_f32_stream", "K3/K4 fp32 flash bwd stream"),
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


def profile_device(run, cpu=True):
    """Runs ``run()`` under torch.profiler. Returns its result, the wall
    time in ms, device time in ms by kernel family, the number of kernels,
    and the rows (ms, count, name) of the kernels. ``cpu=False`` traces the
    device alone: the host's operator events of a request are what makes
    ``key_averages`` take tens of seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
    """Device ms by kernel family of one ``run()`` under torch.profiler,
    the device traced alone (its kernel rows are all this reads; the host's
    operator events of a request cost tens of seconds in ``key_averages``).
    Now and then the profiler records no kernel row of a window (or none of
    family ``want``): up to three windows are profiled, so ``run`` must be
    safe to repeat. Returns {} when none recorded one."""
    fams = {}
    for _ in range(3):
        fams = profile_device(run, cpu=False)[2]
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
    warm, timed, profiled = 3, 10, 2    # timed: cut from 20
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
    warm, timed = 2, 3   # timed cut from 5 for the wide position phase
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
    "in registers. Above head dim 128 (flash_f32_bwd.cuh) a cluster of two "
    "blocks per 64 queries (dq) or 64 keys (dk/dv), each owning half of the "
    "columns of every operand and output: each keeps its half of the "
    "resident pair, computes its partial S and dP (S^T and dP^T) over its "
    "columns, stores it into the other block's shared memory and adds the "
    "other's (mbarriers at cluster scope), then runs dQ (dV, dK) over its own "
    "columns; the next tile's partials are computed and sent while this "
    "tile's are used")
# K1 in fp32 at the shapes the fp32 defaults give it, (B, H, Lq, Lk, D),
# causal, with the backward; compare_revisions.py times them too, and
# FP32_WIDE_CASES beside them.
FP32_CASES = [
    ((2, 8, 4096, 4096, 40), False, False),      # SD1 UNet at 64^2
    ((2, 8, 1024, 1024, 80), False, False),      # SD1 UNet at 32^2
    ((1, 1, 4096, 4096, 512), False, False),     # SD1 VAE mid attention
    ((1, 1, 16384, 16384, 512), False, False),   # SD3 VAE mid attention
    ((16, 12, 576, 576, 64), False, True),       # SigLIP tower
    ((16, 12, 584, 584, 64), True, True),        # TinyVLM decoder
    ((32, 1, 4096, 4096, 128), False, True),     # tiny-SD UNet at 64^2
]
# K1 above head dim 160 and K3 and K4 above 128 in fp32, the shapes tiny-SD's
# fp32 steps give them (HEAD_DIM_TIMED's wide ones), and K1's causal form at
# 192: compare_revisions.py --only fp32 times them in the same form as
# FP32_CASES; phase_kernels_head_dims holds and times them here.
FP32_WIDE_CASES = [
    ((32, 1, 1024, 1024, 192), False, True),     # channel: 96, 32^2
    ((16, 2, 1024, 1024, 256), False, True),     # head dim 256
    ((32, 2, 4096, 4096, 160), False, True),     # channel: 320, 64^2
    ((32, 1, 1024, 1024, 192), True, False),     # K1 causal, streaming
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
    statistics moved once. At the default ``peak`` and one pass it is the
    bound of the same work in fp32 FMAs on the CUDA cores (67 TFLOP/s), the
    yardstick printed beside :func:`tf32_bound`; every fp32 flash kernel
    runs on the tensor cores, three TF32 passes at 495 TFLOP/s."""
    flops = 2.0 * n_products * share * b * h * lq * lk * d
    nbytes = b * h * (4.0 * d * (n_q_like * lq + n_k_like * lk)
                      + 4.0 * n_stats * lq)
    return dict(zip(("bound_ms", "bound_by"),
                    bound(passes * flops, nbytes, peak)))


def tf32_bound(b, h, lq, lk, d, share=1.0, n_products=2, n_q_like=2,
               n_k_like=2, n_stats=1):
    """The bound of an fp32 flash kernel on the tensor cores: its products
    (two for the forward, three for dq, four for dk/dv) in TF32_PASSES passes
    at the dense TF32 rate, or the exponential of every visible logit at the
    SFU's rate where that is longer (at small head dims: d = 8), with the
    bytes floor; beside it (``fma_bound_ms``) the same products in fp32 FMAs
    at 67 TFLOP/s, for comparison, and ``exp_bound_ms``."""
    shape = (b, h, lq, lk, d, n_products, n_q_like, n_k_like, n_stats, share)
    out = dict(**fp32_bound(*shape, peak=PEAK_TF32_FLOPS,
                            passes=TF32_PASSES),
               bound_basis=f"{TF32_PASSES} TF32 passes at 495 TFLOP/s",
               fma_bound_ms=fp32_bound(*shape)["bound_ms"],
               exp_bound_ms=1e3 * share * b * h * lq * lk / PEAK_SFU_EXP2)
    if out["exp_bound_ms"] > out["bound_ms"]:
        out.update(bound_ms=out["exp_bound_ms"], bound_by="operations",
                   bound_basis=f"{share * b * h * lq * lk / 1e6:.1f} M "
                   f"exponentials at the SFU's {PEAK_SFU_EXP2 / 1e12:.2f} "
                   f"T/s")
    return out


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
    for shape, causal, with_bwd in (*FP32_CASES,
                                    (CLIP_KERNEL_SHAPE, False, True)):
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
    # at level 2 from 768^2), T5's bias shared over the batch (scale 1.0;
    # T5-XXL's 512 tokens) and head dim 8 (the checks sd1 UNet), each held
    # as the other K1 rows are.
    for what, shape in (("d160", K1_D160_SHAPE), ("bias", FP32_T5_SHAPE),
                        ("d8", K1_D8_SHAPE)):
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


# each sampler's and the do_cfg=False request of the generator phase (cut
# from 50 to make room for the serving phase; the 50-step k-LMS request is
# the SD1 phase's)
SD1_SAMPLER_STEPS = 20


def phase_sd1_slice(card, models):
    """The rest of ``SD1Generator`` on the bundle of the SD1 phase, 512x512:
    a request with each sampler and with ``do_cfg=False`` at
    ``SD1_SAMPLER_STEPS``, img2img at strength 0.8, ``per_sample_seeds`` at
    batch 1 and inside a batch of 4, and a weighted prompt through the
    tokenizer."""
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
    n = SD1_SAMPLER_STEPS
    for sampler in SAMPLERS:
        sd = SD1Generator(models, sampler=sampler, n_inference_steps=n,
                          cfg_scale=7.5, **size)
        request(f"txt2img {sampler}, {n} steps, CFG 7.5", sd, prompt, n, 2,
                10 * n + 1, seed=11)

    # img2img: strength 0.8 of 50 steps = the last 40; one more K1 launch,
    # the encoder's one-head attention over 64 x 64 tokens at head dim 512
    source = np.random.default_rng(0).integers(0, 256, (512, 512, 3),
                                               dtype=np.uint8)
    sd = SD1Generator(models, sampler="k_lms", n_inference_steps=50, **size)
    request("img2img k_lms, strength 0.8 (40 of 50 steps)", sd, prompt, 40, 2,
            10 * 40 + 2, seed=12, input_images=[source], strength=0.8)
    check(len(encoder_k1) == 2 and sum(encoder_k1) == 1,
          f"the VAE encoder's attention launched K1 {sum(encoder_k1)} times")

    sd = SD1Generator(models, sampler="k_lms", n_inference_steps=n,
                      do_cfg=False, **size)
    request(f"txt2img k_lms, do_cfg=False, {n} steps", sd, prompt, n, 1,
            10 * n + 1, seed=13)

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
# Serving: SD1 behind the port's dynamic batcher and HTTP server, and the CLI

SERVING_BUCKETS = (1, 2, 4, 8)
# one served SD1 batch (any bucket) at 512^2, CFG as one forward, k-LMS steps
# cut from the reference's 50 to 20 (to pay for the parallel group's time;
# the width stays): K1 at head dims 40 (5 self-attentions at 64^2) and 80 (5
# at 32^2) in each UNet forward, and the VAE decoder's mid attention at 512
SERVING_STEPS = 20
SERVING_K1, SERVING_K2 = 10 * SERVING_STEPS + 1, 61 * SERVING_STEPS + 30
SD1_K1_HEAD_DIMS = {40: 5 * SERVING_STEPS, 80: 5 * SERVING_STEPS, 512: 1}
# batch-to-batch bound of a seed's bf16 SD1 image (PERF.md section 7: batch
# 1 against batch 4, cuDNN and cuBLAS choose their kernels by batch)
SERVED_BATCH_LEVELS_MAX, SERVED_BATCH_LEVELS_MEAN = 11, 2.0


def png_pixels(data: bytes):
    """The pixels of an 8-bit RGB PNG whose rows all use filter type 0, as
    the port's encoder writes them, decoded with zlib alone."""
    import struct
    import zlib

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != (
                zlib.crc32(kind + body) & 0xFFFFFFFF):
            raise ValueError(f"bad CRC in {kind!r}")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = ihdr[:4]
    if (depth, color) != (8, 2):
        raise ValueError(f"not 8-bit RGB: depth {depth}, color type {color}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def http_generate(url, payload, timeout=600.0):
    """POST /v1/generate: (status, content type, body, seconds)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        out = e.code, e.headers["Content-Type"], e.read()
    return (*out, time.perf_counter() - t)


def json_image(body):
    import base64

    import numpy as np

    obj = json.loads(body)
    return np.frombuffer(base64.b64decode(obj["image_b64"]),
                         np.uint8).reshape(obj["shape"])


def phase_serving(card, models):
    """SD1 at the reference width (512^2, CFG 7.5, k-LMS cut to
    ``SERVING_STEPS`` steps) behind the port's serving layer:
    the generate_fn of ``cli/serve.py::_build_sd1`` over the resident bf16
    bundle, ``DynamicBatcher(buckets=(1, 2, 4, 8), max_wait_ms=25)`` and
    ``make_server(port=0)`` on 127.0.0.1; ``warmup()`` timed per bucket,
    then each bucket again (imgs/s); client threads send one request alone
    (seed s0, JSON), a burst of 8 (s0..s7, JSON), a burst of 3 (bucket 4,
    one padded slot) and one request in the default PNG format. Checks the
    batches and padded slots (``/metrics``), every served image against a
    direct ``SD1Generator`` call with the same prompts, seeds and bucket,
    s0 alone against s0 in the batch of 8, the PNG (decoded with zlib)
    against the JSON body, and K1's and K2's launches per batch. One
    bucket-8 batch is profiled: device busy against wall time."""
    import threading

    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.cli.serve import (
        sd1_generate_fn)
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import attention as attn
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SD1Generator)
    from from_ddpm_to_stable_diffusion_tpu_torch.serving import (
        DynamicBatcher, make_server, serve_forever_in_thread)

    gen = SD1Generator(models, sampler="k_lms",
                       n_inference_steps=SERVING_STEPS, cfg_scale=7.5,
                       height=512, width=512, mesh=None)
    served_fn = sd1_generate_fn(gen)
    calls, worker_threads = [], set()

    def generate_fn(prompts, negs, seeds):
        calls.append((list(prompts), list(negs), list(seeds)))
        worker_threads.add(threading.get_ident())
        return served_fn(prompts, negs, seeds)

    flash_path = (attn.dot_product_attention, attn._flash_eligible)
    batcher = DynamicBatcher(generate_fn, buckets=SERVING_BUCKETS,
                             max_wait_ms=25.0)
    server = make_server(batcher, host="127.0.0.1", port=0)
    http = serve_forever_in_thread(server)
    url = "http://127.0.0.1:%d" % server.server_address[1]

    def metrics():
        import urllib.request

        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            return json.loads(r.read())

    try:
        reset_counts()
        warm_s, timed_s = {}, {}
        for label, into in (("warm-up", warm_s), ("timed", timed_s)):
            for b in SERVING_BUCKETS:
                torch.cuda.synchronize()
                t = time.perf_counter()
                batcher.warmup([b])
                torch.cuda.synchronize()
                into[b] = time.perf_counter() - t
            print(f"serving {label} per bucket (one generate_fn call each): "
                  + ", ".join(f"bucket {b} {into[b]:.3f} s"
                              for b in SERVING_BUCKETS) + f" [{card}]",
                  flush=True)
        rate = {b: b / timed_s[b] for b in SERVING_BUCKETS}
        print("serving imgs/s per bucket: " + ", ".join(
            f"bucket {b} {rate[b]:.3f} imgs/s ({rate[b] / rate[1]:.2f} x "
            f"bucket 1)" for b in SERVING_BUCKETS) + f" [{card}]", flush=True)
        warm_batches = 2 * len(SERVING_BUCKETS)
        check(metrics()["batches"] == 0, "warm-up counted as traffic")

        s = [1000 + i for i in range(8)]
        stages, client_s = {}, []

        def burst(name, payloads):
            n0, c0 = metrics(), len(calls)
            out = [None] * len(payloads)
            together = threading.Barrier(len(payloads))

            def send(i):
                together.wait(60)
                out[i] = http_generate(url, payloads[i])

            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(len(payloads))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            n1 = metrics()
            check(all(o is not None and o[0] == 200 for o in out),
                  f"serving {name}: statuses "
                  f"{[o and o[0] for o in out]}")
            client_s.extend(o[3] for o in out if o)
            stages[name] = dict(
                payloads=payloads, out=out, calls=calls[c0:],
                batches=n1["batches"] - n0["batches"],
                padded=n1["padded_slots"] - n0["padded_slots"])
            print(f"serving {name}: {len(payloads)} requests in "
                  f"{stages[name]['batches']} batches of "
                  f"{[len(c[0]) for c in calls[c0:]]}, padded slots "
                  f"{stages[name]['padded']}, client latency "
                  f"{max(o[3] for o in out if o):.3f} s at most [{card}]",
                  flush=True)

        req = lambda i, fmt="json": dict(prompt=f"a lighthouse, take {i}",
                                         seed=s[i], format=fmt)
        burst("one request alone", [req(0)])
        burst("a burst of 8", [req(i) for i in range(8)])
        burst("a burst of 3", [req(i) for i in range(3)])
        burst("one PNG request", [dict(prompt="a lighthouse, take 0",
                                       seed=s[0])])
        torch.cuda.synchronize()
        launches = read_counts()
        m = metrics()
        k1_dims = dict(launches.k1_head_dims)
        traffic = sum(st["batches"] for st in stages.values())
        n_batches = warm_batches + traffic
        print(f"serving launches over {n_batches} batches ({warm_batches} "
              f"warm-up and timed, {traffic} of traffic): K1 {launches['K1']}"
              f" by kernel {launches.k1_routes} by head dim {k1_dims}, K2 "
              f"{launches['K2']}; per batch K1 {launches['K1'] / n_batches}, "
              f"K2 {launches['K2'] / n_batches}; generate_fn ran on "
              f"{len(worker_threads)} thread(s), not the main one: "
              f"{threading.get_ident() not in worker_threads} [{card}]",
              flush=True)
        lat = sorted(client_s)
        print(f"serving latency over {len(lat)} requests: batcher p50 "
              f"{m.get('latency_ms_p50', float('nan')) / 1e3:.3f} s, p95 "
              f"{m.get('latency_ms_p95', float('nan')) / 1e3:.3f} s; client "
              f"p50 {lat[len(lat) // 2]:.3f} s, p95 "
              f"{lat[min(len(lat) - 1, int(len(lat) * 0.95))]:.3f} s; "
              f"metrics {json.dumps(m)} [{card}]", flush=True)
        check(stages["a burst of 8"]["batches"] <= 2,
              f"the burst of 8 rode in {stages['a burst of 8']['batches']} "
              "batches")
        check(stages["a burst of 3"]["padded"] == 1
              and [len(c[0]) for c in stages["a burst of 3"]["calls"]] == [4],
              f"the burst of 3: {stages['a burst of 3']['padded']} padded "
              "slots")
        check(launches["K1"] == SERVING_K1 * n_batches
              and launches["K2"] == SERVING_K2 * n_batches,
              f"serving launches K1 {launches['K1']}, K2 {launches['K2']} "
              f"over {n_batches} batches")
        check(launches.k1_routes == {"sm90": (SERVING_K1 - 1) * n_batches,
                                     "d512": n_batches}
              and k1_dims == {d: n * n_batches
                              for d, n in SD1_K1_HEAD_DIMS.items()},
              f"serving K1 routes {launches.k1_routes}, head dims {k1_dims}")
        check((attn.dot_product_attention, attn._flash_eligible)
              == flash_path, "serving ran under plain_attention_only()")
        check(threading.get_ident() not in worker_threads
              and len(worker_threads) == 1,
              "generate_fn did not run on the batcher's one worker")

        # every served image against a direct call of its batch; one batch
        # of 8 (the burst's, else s0..s7) replayed under the profiler
        key = lambda c: (tuple(c[0]), tuple(c[1]), tuple(c[2]))
        eight = [c for st in stages.values() for c in st["calls"]
                 if len(c[0]) == 8]
        c8 = eight[0] if eight else (
            [req(i)["prompt"] for i in range(8)], [""] * 8, s)
        t = time.perf_counter()
        for cpu in (False, True):   # the device alone, else with the host
            images8, wall_ms, fams, n_kernels, _ = profile_device(
                lambda: gen(c8[0], uncond_prompts=c8[1],
                            per_sample_seeds=c8[2]), cpu=cpu)
            if fams:
                break
        busy = sum(fams.values()) or float("nan")
        check(busy > 0, "the profile of the bucket-8 batch recorded no kernel")
        print(f"serving profile of one bucket-8 batch (torch.profiler, "
              f"{'host and ' if cpu else ''}device, kernel rows only; "
              f"{time.perf_counter() - t:.1f} s with its processing): device "
              f"busy {busy:.1f} ms over {n_kernels} "
              f"kernels, wall under the profiler {wall_ms:.1f} ms, "
              f"unprofiled {1e3 * timed_s[8]:.1f} ms; device idle share "
              f"{1 - busy / (1e3 * timed_s[8]):.3f} [{card}]", flush=True)
        direct, worst = {key(c8): images8}, 0
        for name, st in stages.items():
            for c in st["calls"]:
                if key(c) not in direct:
                    direct[key(c)] = gen(c[0], uncond_prompts=c[1],
                                         per_sample_seeds=c[2])
            for p, o in zip(st["payloads"], st["out"]):
                c = next(c for c in st["calls"] if (p["prompt"], p["seed"])
                         in zip(c[0], c[2]))
                row = list(zip(c[0], c[2])).index((p["prompt"], p["seed"]))
                got = (png_pixels(o[2]) if o[1] == "image/png"
                       else json_image(o[2]))
                d = levels(got, direct[key(c)][row])
                worst = max(worst, d[0])
                check(got.shape == (512, 512, 3) and d[0] <= 1,
                      f"serving {name} seed {p['seed']}: {d} levels from the "
                      "direct call")
        held = "bit for bit" if worst == 0 else f"within {worst} level"
        print(f"serving: every served image against a direct SD1Generator "
              f"call of its batch (the same prompts, seeds and bucket): "
              f"{held} [{card}]", flush=True)
        alone = json_image(stages["one request alone"]["out"][0][2])
        in8 = json_image(stages["a burst of 8"]["out"][0][2])
        png = png_pixels(stages["one PNG request"]["out"][0][2])
        d8 = levels(alone, in8)
        print(f"serving: seed {s[0]} alone against seed {s[0]} in the burst "
              f"of 8: max {d8[0]} mean {d8[1]:.3f} levels (bound "
              f"{SERVED_BATCH_LEVELS_MAX}, mean "
              f"{SERVED_BATCH_LEVELS_MEAN}); the PNG "
              f"request, decoded with zlib, against the JSON body of the "
              f"same seed and bucket: {int((png != alone).sum())} values "
              f"differ [{card}]", flush=True)
        check(d8[0] <= SERVED_BATCH_LEVELS_MAX
              and d8[1] <= SERVED_BATCH_LEVELS_MEAN,
              f"seed alone against the batch of 8: {d8}")
        check(np.array_equal(png, alone), "the PNG differs from the JSON "
              "body")
    finally:
        server.shutdown()
        server.server_close()
        batcher.shutdown()
        http.join(60)
    check(not http.is_alive() and not batcher._worker.is_alive(),
          "the server or the batcher's worker did not stop")
    return launches


def phase_sd1_cli(card):
    """``cli/sd1.py generate`` at 512^2, 50 k-LMS steps, CFG 7.5, random
    weights on the card (a second bundle beside the serving one), its PNG
    decoded with zlib; then ``python -m from_ddpm_to_stable_diffusion_tpu_torch
    serve --help`` in a subprocess."""
    import os
    import shutil
    import tempfile

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.cli import sd1 as sd1_cli

    tmp = tempfile.mkdtemp()
    try:
        out = os.path.join(tmp, "sd1_{i}.png")
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        rc = sd1_cli.main(["generate", "--prompt", "a lighthouse at dusk",
                           "--seed", "7", "--device", "cuda", "--out", out])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = read_counts()
        with open(out.format(i=0), "rb") as f:
            data = f.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    img = png_pixels(data)
    print(f"sd1 CLI generate (random weights, 512^2, 50 k-LMS steps): rc "
          f"{rc}, {secs:.3f} s with the bundle's init, PNG {len(data)} bytes "
          f"{img.shape}, launches K1 {launches['K1']} K2 {launches['K2']} "
          f"[{card}]", flush=True)
    check(rc == 0 and img.shape == (512, 512, 3) and float(img.std()) > 0,
          f"sd1 CLI: rc {rc}, image {img.shape}")
    check(launches["K1"] == K1_PER_REQUEST
          and launches["K2"] == K2_PER_REQUEST,
          f"sd1 CLI launches K1 {launches['K1']} K2 {launches['K2']}")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "from_ddpm_to_stable_diffusion_tpu_torch",
         "serve", "--help"], capture_output=True, text=True, timeout=300)
    print(f"python -m from_ddpm_to_stable_diffusion_tpu_torch serve --help: "
          f"rc {proc.returncode} in {time.perf_counter() - t:.2f} s",
          flush=True)
    check(proc.returncode == 0 and "--device" in proc.stdout,
          f"serve --help: rc {proc.returncode} {proc.stderr[-500:]}")
    gc.collect()
    torch.cuda.empty_cache()
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


# ---------------------------------------------------------------------------
# Trainer features (ROADMAP A3): gradient accumulation, checkpoint / resume
# with the preemption guard, LoRA, latent-space DDPM, the device prefetch.
ACCUM = 4


def tree_diff(a, b, prefix=""):
    """Names of the tensors, numbers or structure where two checkpoint
    trees differ (bit for bit)."""
    import torch

    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{prefix}: keys"]
        return [d for k in a for d in tree_diff(a[k], b[k], f"{prefix}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{prefix}: length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in tree_diff(x, y, f"{prefix}/{i}")]
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        same = (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b.to(a.device)))
        return [] if same else [prefix]
    return [] if a == b else [prefix]


def dir_bytes(root):
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def tiny_sd_batches(cfg, n, seed):
    """``n`` batches of ``cfg``'s shape, made on the host, moved to the card."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        DataLoader, SyntheticImageDataset)

    loader = DataLoader(SyntheticImageDataset(
        cfg.batch_size * n, cfg.img_size, cfg.img_channel, cfg.num_class,
        seed=seed), cfg.batch_size, seed=seed)
    return [tuple(torch.from_numpy(a).cuda() for a in b) for b in loader]


def event_ms(pairs):
    return [s.elapsed_time(e) for s, e in pairs]


def phase_train_accum(card, base):
    """(a) ``TinySDConfig(ema_decay=0.9999, grad_accum=4)`` at its defaults
    (64^2, batch 32, bf16): 8 micro-steps, each followed by a bit-for-bit
    check that the parameters and the EMA held (micro-steps 1-3 of a
    window) or moved (the 4th); then 8 more back to back, timed by CUDA
    events at every micro-step and by the host clock; then one window
    under torch.profiler (device busy per micro-step)."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        DDPMTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        TinySDConfig)

    cfg = TinySDConfig(ema_decay=0.9999, grad_accum=ACCUM)
    checked = timed = 2 * ACCUM
    trainer = DDPMTrainer(cfg, device="cuda")
    batches = tiny_sd_batches(cfg, checked + timed + ACCUM, seed=5)
    state = trainer.create_state(len(batches))

    def snapshot():
        return ({n: p.detach().clone() for n, p in state.params.items()},
                {n: e.clone() for n, e in state.ema_params.items()})

    reset_counts()
    held, moved = [], []
    prev = snapshot()
    for i, (images, labels) in enumerate(batches[:checked]):
        state, _ = trainer.train_step(state, images, labels)
        cur = snapshot()
        same = [all(torch.equal(a[n], b[n]) for n in a)
                for a, b in zip(prev, cur)]
        changed = [sum(not torch.equal(a[n], b[n]) for n in a)
                   for a, b in zip(prev, cur)]
        emits = (i + 1) % ACCUM == 0
        (moved if emits else held).append((same, changed))
        check(same == [not emits] * 2,
              f"accumulation: micro-step {i + 1} (emits: {emits}): "
              f"parameters / EMA unchanged {same}")
        prev = cur
    del prev, cur
    pairs = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for images, labels in batches[checked:checked + timed]:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        state, _ = trainer.train_step(state, images, labels)
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / timed

    def window():
        st = state
        for images, labels in batches[checked + timed:]:
            st, _ = trainer.train_step(st, images, labels)
        return st

    state, _, fams, _, _ = profile_device(window)
    busy = sum(fams.values()) / ACCUM
    launches = read_counts()
    ms = event_ms(pairs)
    micro = [m for i, m in enumerate(ms) if (i + 1) % ACCUM]
    emit = [m for i, m in enumerate(ms) if not (i + 1) % ACCUM]
    total = sum(ms)
    n_params = len(state.params)
    print(f"accumulation: grad_accum={ACCUM}, {checked} checked micro-steps "
          f"(parameters and EMA bit-equal across the "
          f"{len(held)} non-emitting ones; at the {len(moved)} emits "
          f"{[c[1][0] for c in moved]} of {n_params} parameter tensors "
          f"moved, EMA {[c[1][1] for c in moved]}), then {timed} timed: "
          f"{total / timed:.2f} ms per micro-step, {total / (timed // ACCUM):.2f}"
          f" ms per update (non-emitting micro-step {sum(micro) / len(micro):.2f}"
          f" ms, emitting {sum(emit) / len(emit):.2f} ms; CUDA events; host "
          f"{host_ms:.2f} ms per micro-step); device busy {busy:.2f} ms per "
          f"micro-step over one profiled window (idle share "
          f"{1 - busy * timed / total:.3f}); phase_training "
          f"{base['step_ms']:.2f} ms/step, busy {base['busy_ms']:.2f}; state step "
          f"{state.step}, updates {state.updates}; launches {launches} "
          f"[{card}]", flush=True)
    n = checked + timed + ACCUM
    check((state.step, state.updates, state.mini_step) == (n, n // ACCUM, 0),
          f"accumulation counters {state.step} {state.updates} "
          f"{state.mini_step}")
    for name, per_step in TRAIN_PER_STEP.items():
        check(launches[name] == per_step * n,
              f"accumulation: {name} launches {launches[name]} != "
              f"{per_step} x {n}")
    dead = sum(bool(DEAD_PARAMS.search(k)) for k in state.params)
    check(all(c[1][0] == n_params - dead for c in moved),
          f"accumulation: an emit left parameters unmoved: {moved}")
    return launches


class Preempting:
    """Yields the batches of ``batches`` on each pass; as it fetches batch
    ``at[1]`` of pass ``at[0]`` it raises SIGTERM in this (the main)
    thread, as a preemption would."""

    def __init__(self, batches, at=None):
        self.batches, self.at, self.passes = batches, at, 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        import signal

        p, self.passes = self.passes, self.passes + 1
        for i, batch in enumerate(self.batches):
            if (p, i) == self.at:
                signal.raise_signal(signal.SIGTERM)
            yield batch


def phase_train_resume(card):
    """(b) ``fit`` with ``checkpoint_dir`` at ``TinySDConfig(ema_decay=
    0.9999, grad_accum=2)`` (64^2, batch 32): 3 batches an epoch on the
    host, staged by ``prefetch_to_device``; epoch 0 is saved as the best;
    a SIGTERM raised from inside the loader in epoch 1 forces a save and
    ends ``fit`` in the middle of an accumulation window. A fresh trainer
    restores the checkpoint: every tensor (parameters, moments, EMA,
    accumulator, generator state) bit-equal to the state ``fit`` returned.
    Checkpoints go to TMPDIR and are deleted."""
    import shutil
    import tempfile

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        DataLoader, SyntheticImageDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        DDPMTrainer, checkpoint_tree, restore_tree)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        TinySDConfig)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.logging import (
        MetricsLogger)

    cfg = TinySDConfig(ema_decay=0.9999, grad_accum=2)
    batches = list(DataLoader(SyntheticImageDataset(
        cfg.batch_size * 3, cfg.img_size, seed=7), cfg.batch_size, seed=7))
    logger = MetricsLogger(stream=sys.stdout, prefix=f"resume [{card}]: ")
    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        trainer = DDPMTrainer(cfg, device="cuda", logger=logger)
        state = trainer.create_state(len(batches))
        reset_counts()
        t = time.perf_counter()
        # prefetch runs 2 batches ahead: the SIGTERM at the fetch of batch
        # 2 of epoch 1 lands before its batch 1 trains, so fit stops after
        # 3 + 2 micro-steps, one into the third window
        state = trainer.fit(Preempting(batches, at=(1, 2)), state, epochs=3,
                            checkpoint_dir=root)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        launches = read_counts()
        mgr = CheckpointManager(root)
        steps, on_disk = mgr.all_steps(), dir_bytes(root)
        saved = checkpoint_tree(state, trainer.generator)
        t = time.perf_counter()
        check(mgr.save(9, saved), "resume: the timed save was skipped")
        save_s = time.perf_counter() - t
        one_save = dir_bytes(root) - on_disk
        fresh = DDPMTrainer(cfg, device="cuda", logger=logger)
        into = fresh.create_state(len(batches))
        torch.cuda.synchronize()
        t = time.perf_counter()
        tree, at = mgr.restore(1)
        restore_tree(into, fresh.generator, tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        diff = tree_diff(checkpoint_tree(into, fresh.generator), saved)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n = 5
    print(f"resume: fit cut by SIGTERM after {state.step} micro-steps "
          f"({state.updates} updates, {state.mini_step} into the window) in "
          f"{fit_s:.2f} s; checkpoints {steps} ({on_disk} bytes); one save "
          f"{save_s:.3f} s, {one_save} bytes; restore into a fresh trainer "
          f"{restore_s:.3f} s; {len(diff)} tensors or numbers differ from "
          f"what was saved {diff[:5]}; launches {launches} [{card}]",
          flush=True)
    check(steps == [0, 1] and at == 1, f"resume: checkpoint steps {steps}")
    check((state.step, state.updates, state.mini_step) == (n, 2, 1),
          f"resume: cut at {state.step} / {state.updates} / "
          f"{state.mini_step}, not 5 / 2 / 1")
    check(not diff, f"resume: restored state differs at {diff[:10]}")
    for name, per_step in TRAIN_PER_STEP.items():
        check(launches[name] == per_step * n,
              f"resume: {name} launches {launches[name]} != "
              f"{per_step} x {n}")
    return launches


def group_norms(module):
    from from_ddpm_to_stable_diffusion_tpu_torch.models.layers import GroupNorm

    return sum(isinstance(m, GroupNorm) for m in module.modules())


LATENT_STEPS = (2, 3)   # warm, timed (cut from 5 for vae_grad)


def phase_latent_training(card, base):
    """(d) The reference's ``03_train_with_vae`` operating point:
    ``TinySDConfig(img_size=64, img_channel=4, batch_size=32, dtype="bf16")``
    fed 512^2 images that ``latent_encode_fn``, the SD1 / SDXL-VAE
    architecture's ``VAEEncoder`` (random Flax-default weights from a seed,
    bf16; its noise from the trainer's generator), encodes to 64^2 x 4
    latents; 2 warm + 5 timed steps through ``fit`` (device prefetch), each
    and its encode timed by CUDA events; then 4 images sampled over
    SAMPLE_T steps and decoded by ``VAEDecoder`` to 512^2."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        DataLoader, SyntheticImageDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.sd1 import (
        VAEDecoder, VAEEncoder)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        DDPMTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        _prepare, flax_default_init_)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        TinySDConfig)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.logging import (
        MetricsLogger)

    cfg = TinySDConfig(img_size=64, img_channel=4, batch_size=32,
                       dtype="bf16")
    warm, timed = LATENT_STEPS
    n_steps = warm + timed
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed + 3)
    vae = []
    for make in (VAEEncoder, VAEDecoder):
        with torch.device("meta"):
            module = make()
        vae.append(_prepare(flax_default_init_(
            module.to_empty(device="cuda"), gen), "cuda", "bf16"))
    encoder, decoder = vae
    encode_events = []

    def encode(images, generator):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        b, h, w, _ = images.shape
        noise = torch.randn((b, h // 8, w // 8, 4), generator=generator,
                            device=images.device)
        z = encoder(images, noise)
        e.record()
        encode_events.append((s, e))
        return z

    trainer = DDPMTrainer(cfg, device="cuda", latent_encode_fn=encode,
                          latent_decode_fn=decoder,
                          logger=MetricsLogger(stream=sys.stdout,
                                               prefix=f"latent [{card}]: "))
    step_events = []
    inner = trainer.train_step

    def timed_step(state, *batch, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = inner(state, *batch, **kw)
        e.record()
        step_events.append((s, e))
        return out

    trainer.train_step = timed_step
    loader = DataLoader(SyntheticImageDataset(cfg.batch_size * n_steps, 512,
                                              seed=11), cfg.batch_size,
                        seed=11)
    state = trainer.create_state(len(loader))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.fit(loader, state, epochs=1)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = event_ms(step_events)[warm:]
    enc_ms = event_ms(encode_events)[warm:]
    step, enc = sum(step_ms) / timed, sum(enc_ms) / timed
    enc_gn, dec_gn = group_norms(encoder), group_norms(decoder)
    print(f"latent training: 512^2 images -> VAEEncoder (bf16, "
          f"{sum(p.numel() for p in encoder.parameters())} params) -> 64^2 x "
          f"4 latents, TinyUNet {trainer.num_params(state)} params, batch "
          f"{cfg.batch_size}; set-up {setup_s:.2f} s; {timed} timed steps "
          f"(after {warm}): {step:.2f} ms/step (CUDA events), of which the "
          f"encode {enc:.2f} ms and the UNet step {step - enc:.2f} ms; "
          f"{1e3 * cfg.batch_size / step:.1f} img/s; pixel-space "
          f"phase_training {base['step_ms']:.2f} ms/step; peak {peak:.2f} "
          f"GiB; loss {trainer.history[-1]['loss']:.5f}; launches "
          f"{launches}, K1 by kernel {launches.k1_routes} [{card}]",
          flush=True)
    want = dict(TRAIN_PER_STEP)
    want.update(K1=want["K1"] + 1, K2=want["K2"] + enc_gn)
    for name, per_step in want.items():
        check(launches[name] == per_step * n_steps,
              f"latent training: {name} launches {launches[name]} != "
              f"{per_step} x {n_steps}")
    check(launches.k1_routes == {"sm90": 6 * n_steps, "d512": n_steps},
          f"latent training: K1 by kernel {launches.k1_routes}")
    check(bool(torch.isfinite(torch.tensor(trainer.history[-1]["loss"]))),
          "latent training: non-finite loss")

    sampler = DDPMTrainer(dataclasses.replace(cfg, T=SAMPLE_T), device="cuda",
                          latent_decode_fn=decoder)
    labels = [1, 2, 3, 1]
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    images = sampler.sample(state, labels)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    sample_launches = read_counts()
    print(f"latent sampling: {len(labels)} images, T={SAMPLE_T}, CFG "
          f"w={cfg.w}, decoded by VAEDecoder to {tuple(images.shape)}: "
          f"{secs:.3f} s; launches {sample_launches}, K1 by kernel "
          f"{sample_launches.k1_routes} [{card}]", flush=True)
    check(tuple(images.shape) == (len(labels), 512, 512, 3),
          f"latent samples {tuple(images.shape)}")
    check(bool(torch.isfinite(images).all())
          and images.abs().max().item() <= 1.0
          and float(images.std()) > 0.0,
          "latent samples not finite in [-1, 1], or constant")
    check(sample_launches == dict(K1=6 * SAMPLE_T + 1,
                                  K2=39 * SAMPLE_T + dec_gn, K3=0, K4=0,
                                  K5=0, K6=0, K7=0)
          and sample_launches.k1_routes == {"sm90": 6 * SAMPLE_T, "d512": 1},
          f"latent sampling launches {sample_launches} "
          f"{sample_launches.k1_routes}")
    return launches, sample_launches


LORA_RANK = 8          # JAX init_lora's default
LORA_STEPS = (2, 4)    # warm, timed micro-steps


def phase_mmdit_lora(card, base):
    """(c) LoRA and gradient accumulation at SD3-medium's width and depth:
    ``MMDiTTrainer(MMDiTConfig(), FlowTrainConfig(img_size=128,
    context_len=154, batch_size=2, dtype="bf16", grad_accum=2),
    lora_rank=8)``; 2 warm + 4 timed micro-steps (CUDA events). The frozen
    base is held bit-identical (against a host copy), every B adapter moves
    and the LoRA state round-trips a checkpoint in TMPDIR bit for bit."""
    import shutil
    import tempfile

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.models.mmdit import MMDiTConfig
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        checkpoint_tree)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
        MMDiTTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        FlowTrainConfig)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.lora import (
        num_lora_params)

    model_cfg = MMDiTConfig()
    cfg = FlowTrainConfig(img_size=128, context_len=154, batch_size=2,
                          dtype="bf16", grad_accum=2)
    warm, timed = LORA_STEPS
    n_steps = warm + timed
    t0 = time.perf_counter()
    trainer = MMDiTTrainer(model_cfg, cfg, device="cuda",
                           lora_rank=LORA_RANK)
    state = trainer.create_state(steps_per_epoch=n_steps)
    host_base = {n: p.detach().to("cpu", copy=True)
                 for n, p in state.model.named_parameters()}
    start = {n: t.detach().clone() for n, t in state.trainable().items()}
    latents, context, y = (torch.from_numpy(a).cuda() for a in mmdit_batch(
        cfg.batch_size, cfg.img_size, cfg.context_len, model_cfg, seed=0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_counts()
    for _ in range(warm):
        state, _ = trainer.train_step(state, latents, context, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pairs = []
    for _ in range(timed):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        state, loss = trainer.train_step(state, latents, context, y)
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = event_ms(pairs)
    base_same = all(torch.equal(p, host_base[n].to("cuda", non_blocking=True))
                    for n, p in state.model.named_parameters())
    del host_base
    now = state.trainable()
    b_moved = sum(not torch.equal(start[n], t) for n, t in now.items()
                  if n.endswith("/b"))
    a_moved = sum(not torch.equal(start[n], t) for n, t in now.items()
                  if n.endswith("/a"))
    n_adapters = len(state.lora)
    root = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    try:
        mgr = CheckpointManager(root)
        saved = checkpoint_tree(state, trainer.generator)
        t = time.perf_counter()
        mgr.save(0, saved)
        save_s = time.perf_counter() - t
        nbytes = dir_bytes(root)
        t = time.perf_counter()
        tree, _ = mgr.restore()
        restore_s = time.perf_counter() - t
        diff = tree_diff(tree, saved)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"MMDiT LoRA: rank {LORA_RANK}, {n_adapters} adapted kernels, "
          f"{num_lora_params(state.lora)} trained parameters over a frozen "
          f"base of {sum(p.numel() for p in state.model.parameters())}; "
          f"grad_accum {cfg.grad_accum}; set-up {setup_s:.2f} s; {timed} "
          f"timed micro-steps: {sum(ms) / timed:.2f} ms per micro-step "
          f"({[round(m, 2) for m in ms]}; CUDA events), peak {peak:.2f} GiB; "
          f"full training (phase_mmdit_training) {base['step_ms']:.2f} "
          f"ms/step, peak {base['peak_gib']:.2f} GiB; loss {loss.item():.5f};"
          f" base bit-identical {base_same}; B moved {b_moved}/{n_adapters}, "
          f"A moved {a_moved}/{n_adapters}; checkpoint {nbytes} bytes, save "
          f"{save_s:.3f} s, restore {restore_s:.3f} s, {len(diff)} differ; "
          f"launches {launches} [{card}]", flush=True)
    check(base_same, "MMDiT LoRA: the frozen base moved")
    check(b_moved == n_adapters and a_moved > 0,
          f"MMDiT LoRA: adapters moved B {b_moved}, A {a_moved} of "
          f"{n_adapters}")
    check((state.step, state.updates) == (n_steps, n_steps // 2),
          f"MMDiT LoRA: counters {state.step} {state.updates}")
    check(not diff, f"MMDiT LoRA: checkpoint differs at {diff[:10]}")
    check(bool(torch.isfinite(loss)), "MMDiT LoRA: non-finite loss")
    for name, per_step in MMDIT_PER_STEP.items():
        check(launches[name] == per_step * n_steps,
              f"MMDiT LoRA: {name} launches {launches[name]} != "
              f"{per_step} x {n_steps}")
    return launches


def phase_vlm_checkpoint(card):
    """(e) ``VLMTrainer.fit(checkpoint_dir=)`` for one short epoch (2 steps
    of batch 16) at the TinyVLM training phase's config: the best epoch is
    written to TMPDIR and read back bit for bit."""
    import shutil
    import tempfile

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.shapes_dataset import (
        CaptionedShapesDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        checkpoint_tree)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.checkpoint import (
        CheckpointManager)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.logging import (
        MetricsLogger)

    batch, n_steps = 16, 2
    trainer = vlm_trainer("cuda", "bf16", VLM_LAYERS, warmup_steps=2,
                          total_steps=1000, logger=MetricsLogger(
                              stream=sys.stdout,
                              prefix=f"vlm checkpoint [{card}]: "))
    data = CaptionedShapesDataset(batch * n_steps, img_size=384, seed=1)
    batches = [vlm_batch(data, i * batch, batch) for i in range(n_steps)]
    root = tempfile.mkdtemp(prefix="chip_smoke_vlm_")
    try:
        reset_counts()
        t = time.perf_counter()
        state = trainer.fit(batches, epochs=1, image_size=384,
                            checkpoint_dir=root)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        launches = read_counts()
        nbytes = dir_bytes(root)
        tree, step = CheckpointManager(root).restore()
        diff = tree_diff(tree, checkpoint_tree(state, None))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"vlm checkpoint: fit of {n_steps} steps with checkpoint_dir "
          f"{fit_s:.2f} s; step {step} written, {nbytes} bytes, read back "
          f"with {len(diff)} differences; launches {launches} [{card}]",
          flush=True)
    check(step == 0 and nbytes > 0 and not diff,
          f"vlm checkpoint: step {step}, {nbytes} bytes, differs {diff[:10]}")
    for name, per_step in VLM_PER_STEP.items():
        check(launches[name] == per_step * n_steps,
              f"vlm checkpoint: {name} launches {launches[name]} != "
              f"{per_step} x {n_steps}")
    return launches


# --------------------------------------------------------------------------
# The trainable model zoo (stages 08, 03, 04) through its CLIs
# --------------------------------------------------------------------------
# The video UNet at the video CLI's defaults (channel 64, 32^2, 8 frames,
# batch 32 clips: 256 folded frames): the level-0 self-attentions of
# enc1_att and dec2_att (1024 tokens, one head of 64) take K1 in the forward
# and K3 + K4 in the backward; the 16^2 and 8^2 levels, the one-token
# cross-attentions and the 8-frame temporal attentions are plain (under 512
# tokens). 22 GroupNorms a forward (2 in each of 8 ResBlocks, 5
# TransformerBlock norm_in, the 16-group tail) take K2; their backward is
# plain. A CFG sampling step is one forward of 2 x 3 clips.
VIDEO_TRAIN_PER_STEP = dict(K1=2, K2=22, K3=2, K4=2, K5=0, K6=0, K7=0)
VIDEO_SAMPLE_PER_STEP = dict(K1=2, K2=22, K3=0, K4=0, K5=0, K6=0, K7=0)
# cut from the CLI's 40 epochs over 256 clips (8 steps) and T = 400
VIDEO_EPOCHS, VIDEO_STEPS_PER_EPOCH, VIDEO_T = 2, 6, 50
# The VAEs (convs, BatchNorm, leaky ReLU) and the ViT (17 tokens) reach no
# kernel of the port: every count stays 0.
NO_LAUNCHES = dict(K1=0, K2=0, K3=0, K4=0, K5=0, K6=0, K7=0)
VIDEO_KERNEL_SHAPES = [(256, 1, 1024, 1024, 64), (48, 1, 1024, 1024, 64)]
VIDEO_GN_SHAPE = (256, 32, 32, 64)


@contextlib.contextmanager
def watched(cls, names, before=None):
    """While the block runs, each method of ``cls`` in ``names`` records
    every call: the instance, the result, and CUDA events recorded around
    it; ``before(name)`` runs first. Yields name -> list of records."""
    import torch

    calls = {n: [] for n in names}
    saved = {n: cls.__dict__[n] for n in names}

    def wrap(name, fn):
        @functools.wraps(fn)
        def run(self, *args, **kw):
            if before is not None:
                before(name)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn(self, *args, **kw)
            end.record()
            calls[name].append(dict(self=self, result=result, start=start,
                                    end=end))
            return result
        return run

    for n in names:
        setattr(cls, n, wrap(n, saved[n]))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def window_ms(steps, warm):
    """ms per call over the calls after ``warm`` (CUDA events from the
    first one's start to the last one's end: the host's time between
    calls included)."""
    return steps[warm]["start"].elapsed_time(steps[-1]["end"]) / (
        len(steps) - warm)


def busy_per_call(run, n):
    """Device-busy ms per call of ``run`` (``n`` calls in one profile)."""
    fams = profile_device(run, cpu=False)[2]
    return sum(fams.values()) / n, fams


def batch_ms(dataset, batch_size, n=2):
    """Host ms to build one batch of ``dataset`` (``DataLoader``'s
    ``load`` and stack, as the CLIs' loaders do before each step)."""
    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import DataLoader

    t0 = time.perf_counter()
    batches = [b for _, b in zip(range(n), DataLoader(dataset, batch_size))]
    return 1e3 * (time.perf_counter() - t0) / len(batches), batches


def against_cpu(card, what, pair, step, leaves=None):
    """One train step on the card (bf16 compute, kernels) against the same
    step on the CPU (fp32, plain versions) from the same weights and draws,
    as ``phase_grad_check`` holds tiny-SD's: the loss and the gradients the
    step leaves in each parameter's ``.grad``, as relative L2 errors of the
    loss, the whole flattened gradient and each leaf matching ``leaves``,
    each within GRAD_REL_TOL. ``pair``: {"cuda": (trainer, state), "cpu":
    (trainer, state)}; ``step(trainer, state)`` returns the loss."""
    import torch

    got = {}
    for dev, (trainer, state) in pair.items():
        t0 = time.perf_counter()
        loss = float(step(trainer, state))
        if dev == "cuda":
            torch.cuda.synchronize()
        got[dev] = (loss, {n: p.grad.float().flatten().cpu()
                           for n, p in state.model.named_parameters()},
                    time.perf_counter() - t0)
    (l_card, g_card, s_card), (l_cpu, g_cpu, s_cpu) = got["cuda"], got["cpu"]
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    whole = rel(torch.cat(list(g_card.values())),
                torch.cat(list(g_cpu.values())))
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    picked = [n for n in g_cpu if leaves is not None and leaves.search(n)]
    worst = {n: rel(g_card[n], g_cpu[n]) for n in picked}
    leaf_line = (f"; {len(picked)} flash-block leaves, worst "
                 f"{max(worst, key=worst.get)} {max(worst.values()):.3e}"
                 if picked else "")
    print(f"{what} step against the CPU: loss card {l_card:.6f} cpu "
          f"{l_cpu:.6f} (rel {loss_rel:.3e}); flattened gradient "
          f"({sum(g.numel() for g in g_cpu.values())} values) rel L2 "
          f"{whole:.3e}{leaf_line}; tol {GRAD_REL_TOL}; card {s_card:.2f} s, "
          f"cpu fp32 {s_cpu:.2f} s [{card}]", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in g_card.values()),
          f"{what}: non-finite card gradient")
    check(loss_rel <= GRAD_REL_TOL and whole <= GRAD_REL_TOL
          and all(e <= GRAD_REL_TOL for e in worst.values()),
          f"{what}: card step off the CPU's: loss {loss_rel}, whole {whole}, "
          f"leaves {worst}")
    check(leaves is None or len(picked) > 0, f"{what}: no leaf of {leaves}")
    return dict(loss_rel=loss_rel, grad_rel=whole,
                leaf_rel=max(worst.values()) if worst else None)


def copy_weights(src, dst):
    """``dst``'s parameters and buffers from ``src``'s, across devices."""
    import torch

    with torch.no_grad():
        for (n, a), (_, b) in zip(src.state_dict().items(),
                                  dst.state_dict().items()):
            b.copy_(a.detach().to(b.device, b.dtype))


def phase_kernels_video(card, tail):
    """K1 at the video UNet's level-0 shapes (train batch 32 and CFG
    sampling of 3 clips: 256 and 48 folded frames, one head of 64), K3 /
    K4 at the training one, K2 at its largest slab, each against the plain
    version, with the bound and the library call's time."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device="cuda").manual_seed(1717)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf16, out = torch.bfloat16, {"K1": [], "K3": [], "K4": []}
    for b, h, lq, lk, d in VIDEO_KERNEL_SHAPES:
        # q, k, v slices of the fused (B, L, 3 C) projection, as attn1 does
        q, k, v = (t.reshape(b, lq, h, d).transpose(1, 2) for t in
                   rnd(b, lq, 3 * h * d).to(bf16).chunk(3, -1))
        o, lse = fa.flash_attention_cuda(q, k, v)
        ref, ref_lse = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        del ref, ref_lse
        run = lambda: fa.flash_attention_cuda(q, k, v)
        times = dict(zip(("bound_ms", "bound_by"),
                         attn_bound(b, h, lq, lk, d)),
                     ms=cuda_ms(run),
                     plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                         q, k, v), 5, 1),
                     library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                         q, k, v), 10, 2))
        device_ms = kernel_device_ms(run, "K1 flash fwd")
        print(f"K1 flash fwd video UNet level 0 (B,H,Lq,Lk,D)=({b},{h},{lq},"
              f"{lk},{d}) bf16: max|out err|={err:.3e} (atol 2e-2) max|lse "
              f"err|={lse_err:.3e} (atol 1e-3); {tail(**times)}; device "
              f"{fmt_ms(device_ms)}", flush=True)
        check(err <= 2e-2 and lse_err <= 1e-3,
              f"K1 disagrees at {(b, h, lq, lk, d)}: {err} / {lse_err}")
        out["K1"].append(dict(shape=[b, h, lq, lk, d], max_abs_err=err,
                              device_ms=device_ms, **times))
        if b == VIDEO_KERNEL_SHAPES[0][0]:
            bwd = phase_kernels_bwd(card, q, k, v, o, lse, gen, tail)
            for name, fam in (("K3", "K3 flash bwd dq"),
                              ("K4", "K4 flash bwd dk/dv")):
                rec = bwd[name]
                out[name].append(dict(shape=[b, h, lq, lk, d],
                                      max_abs_err=rec.pop("err"), **rec))
        del q, k, v, o, lse
    shape, c = VIDEO_GN_SHAPE, VIDEO_GN_SHAPE[-1]
    x = (rnd(*shape) * 2.0 + 0.5).to(bf16)
    scale, bias = 1.0 + 0.1 * rnd(c), 0.1 * rnd(c)
    y = gn.group_norm_cuda(x, 32, scale, bias, 1e-5, "silu")
    ref = gn.group_norm_plain_one_pass(x, 32, scale, bias, 1e-5, "silu")
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    check(_close(y, ref, 1.6e-2, 1.6e-2), f"K2 disagrees at {shape}")
    run = lambda: gn.group_norm_cuda(x, 32, scale, bias, 1e-5, "silu")
    x_nchw = x.permute(0, 3, 1, 2)
    times = dict(zip(("bound_ms", "bound_by"),
                     bound(10.0 * x.numel(),
                           2.0 * x.numel() * x.element_size() + 8.0 * c,
                           PEAK_FP32_FLOPS)),
                 ms=cuda_ms(run),
                 plain_ms=cuda_ms(lambda: gn.group_norm_plain_one_pass(
                     x, 32, scale, bias, 1e-5, "silu"), 5, 1),
                 library_ms=cuda_ms(lambda: F.silu(F.group_norm(
                     x_nchw, 32, scale.to(bf16), bias.to(bf16), 1e-5)),
                     10, 2))
    device_ms = kernel_device_ms(run, "K2 group norm")
    print(f"K2 group norm video UNet level 0 {shape} act=silu bf16: "
          f"max|err|={err:.3e} (rtol 1.6e-2, atol 1.6e-2); {tail(**times)}; "
          f"device {fmt_ms(device_ms)}", flush=True)
    out["K2"] = [dict(shape=list(shape), act="silu", max_abs_err=err,
                      device_ms=device_ms, **times)]
    return out


def phase_video(card):
    """``cli/video.py train`` at the CLI's width (channel 64, 32^2, 8
    frames, batch 32, bf16) for VIDEO_EPOCHS epochs of
    VIDEO_STEPS_PER_EPOCH steps, then its CFG sampling of 3 clips over
    ``--T`` = VIDEO_T steps (cut from 400) and the (class rows x frame
    columns) PNG. Launches counted from 0 for the training and again for
    the sampling; ms/step over the second epoch, frames/s, device idle share
    (2 more steps profiled), peak memory; then one train step on the card
    against the CPU. Returns the training's and the sampling's counts."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.cli import video as video_cli
    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        SyntheticVideoDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.tiny_video_unet import (
        TinyVideoUNet)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        DDPMTrainer)

    bs, frames, size = 32, 8, 32
    train_counts = []

    def before(name):
        if name == "sample":      # the training path ends, sampling starts
            train_counts.append(read_counts())
            reset_counts()

    tmp = tempfile.mkdtemp()
    try:
        out = os.path.join(tmp, "video_grid.png")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with watched(DDPMTrainer, ("train_step", "sample", "fit"),
                     before) as calls:
            reset_counts()
            t0 = time.perf_counter()
            rc = video_cli.main([
                "train", "--epochs", str(VIDEO_EPOCHS), "--clips",
                str(bs * VIDEO_STEPS_PER_EPOCH), "--T", str(VIDEO_T),
                "--device", "cuda", "--out", out])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            sample_counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(out, "rb") as f:
            data = f.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    train = train_counts[0]
    steps = calls["train_step"]
    n = len(steps)
    step_ms = window_ms(steps, VIDEO_STEPS_PER_EPOCH)
    sample = calls["sample"][0]
    sample_ms = sample["start"].elapsed_time(sample["end"])
    trainer, state = calls["fit"][0]["self"], calls["fit"][0]["result"]
    data_ms, batches = batch_ms(SyntheticVideoDataset(2 * bs, size,
                                                      frames=frames), bs)

    def two_steps():
        for clips, labels in batches:
            trainer.train_step(state, clips, labels)

    busy, fams = busy_per_call(two_steps, 2)
    idle = 1.0 - busy / step_ms
    img = png_pixels(data)
    losses = [h["loss"] for h in trainer.history]
    per_step = {k: train[k] / n for k in ("K1", "K3", "K4", "K2")}
    print(f"video CLI train (TinyVideoUNet "
          f"{trainer.num_params(state)} params, channel 64, {size}^2, "
          f"{frames} frames, batch {bs}, bf16): rc {rc}, {secs:.2f} s in all; "
          f"{n} steps, {step_ms:.2f} ms/step over the last "
          f"{n - VIDEO_STEPS_PER_EPOCH} (CUDA events, the host's time between "
          f"steps included), {1e3 * bs * frames / step_ms:.1f} frames/s "
          f"({1e3 * bs / step_ms:.2f} clips/s); device busy {busy:.2f} "
          f"ms/step, idle share {idle:.3f}; a batch of clips made on the "
          f"host in {data_ms:.2f} ms; peak {peak:.2f} GiB; epoch "
          f"losses {[round(x, 5) for x in losses]}; launches per step "
          f"{per_step} (predicted K1 2, K3 2, K4 2, K2 22) [{card}]",
          flush=True)
    print_profile(fams, [], 2, "step")
    print(f"video CLI CFG sampling of 3 clips, T={VIDEO_T} (UNet batch 6, "
          f"48 folded frames): {sample_ms:.1f} ms, {sample_ms / VIDEO_T:.2f} "
          f"ms/step, launches {sample_counts}; PNG {len(data)} bytes "
          f"{img.shape} [{card}]", flush=True)
    check(rc == 0 and img.shape == (3 * size, frames * size, 3)
          and float(img.std()) > 0, f"video CLI: rc {rc}, grid {img.shape}")
    check(n == VIDEO_EPOCHS * VIDEO_STEPS_PER_EPOCH, f"video: {n} steps")
    check(all(np.isfinite(losses)), f"video: losses {losses}")
    for k, per in VIDEO_TRAIN_PER_STEP.items():
        check(train[k] == per * n, f"video training {k} launches "
              f"{train[k]} != {per} x {n}")
    for k, per in VIDEO_SAMPLE_PER_STEP.items():
        check(sample_counts[k] == per * VIDEO_T, f"video sampling {k} "
              f"launches {sample_counts[k]} != {per} x {VIDEO_T}")

    # one step on the card against the CPU: 2 clips at the CLI's width
    cfg = trainer.cfg
    pair = {}
    for dev, dt in (("cuda", cfg.dtype), ("cpu", "fp32")):
        model = TinyVideoUNet(base_channels=cfg.channel, num_classes=3,
                              dtype=torch.bfloat16 if dt == "bf16"
                              else torch.float32)
        t = DDPMTrainer(dataclasses.replace(cfg, dtype=dt), device=dev,
                        model=model, sample_shape=trainer.sample_shape)
        pair[dev] = (t, t.create_state(1))
    copy_weights(state.model, pair["cuda"][1].model)
    copy_weights(state.model, pair["cpu"][1].model)
    rng = np.random.default_rng(17)
    clips, labels = batches[0][0][:2], batches[0][1][:2]
    draws = dict(drop=np.asarray([False, True]),
                 t=rng.integers(0, cfg.T, 2),
                 noise=rng.standard_normal(clips.shape).astype(np.float32))
    grad = against_cpu(card, "video", pair, lambda tr, st: tr.train_step(
        st, clips, labels, **draws)[1],
        re.compile(r"^(enc1|dec2)_att\.attn1\."))
    del trainer, state, pair
    gc.collect()
    torch.cuda.empty_cache()
    return train, sample_counts, dict(
        step_ms=step_ms, busy_ms=busy, idle=idle, peak_gib=peak,
        data_ms=data_ms, sample_ms=sample_ms, **grad)


def phase_vae(card):
    """``cli/vae.py train --synthetic`` at its defaults (512^2, batch 7,
    bf16) for one epoch (8 steps, cut from 40 epochs) with ``--model
    vqvae`` and ``--model vanilla``, its checkpoint written to TMPDIR:
    ms/step over the last 6, peak memory, the VQ code usage on a batch; then
    one step on the card against the CPU (batch 2 at 512^2). Returns each
    model's counts."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.cli import vae as vae_cli
    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        SyntheticImageDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vae_trainer import (
        VAETrainer)

    runs, stats = [], {}
    for model in ("vqvae", "vanilla"):
        tmp = tempfile.mkdtemp()
        try:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with watched(VAETrainer, ("train_step", "fit")) as calls:
                reset_counts()
                t0 = time.perf_counter()
                rc = vae_cli.main(["train", "--model", model, "--synthetic",
                                   "--epochs", "1", "--model-dir", tmp,
                                   "--device", "cuda"])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ckpt_bytes = dir_bytes(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        trainer, state = calls["fit"][0]["self"], calls["fit"][0]["result"]
        steps = calls["train_step"]
        step_ms = window_ms(steps, 2)
        cfg = trainer.cfg
        data_ms, batches = batch_ms(SyntheticImageDataset(
            2 * cfg.batch_size, cfg.img_size), cfg.batch_size)
        busy, _ = busy_per_call(lambda: [trainer.train_step(state, b[0])
                                         for b in batches], 2)
        idle = 1.0 - busy / step_ms
        x = batches[0][0]
        usage = ""
        if model == "vqvae":
            with torch.no_grad():
                _, _, idx = state.model.eval()(torch.as_tensor(x,
                                                               device="cuda"))
            used = int(torch.unique(idx).numel())
            usage = (f", VQ codes used on a batch {used} of "
                     f"{cfg.num_embeddings}")
            stats[f"{model}_codes_used"] = used
        losses = [h["loss"] for h in trainer.history]
        print(f"vae CLI train --model {model} ({trainer.num_params(state)} "
              f"params, {cfg.img_size}^2, batch {cfg.batch_size}, "
              f"{cfg.dtype}): rc {rc}, {secs:.2f} s with the init and a "
              f"{ckpt_bytes / 2 ** 30:.2f} GiB checkpoint; {len(steps)} steps, "
              f"{step_ms:.2f} ms/step over the last {len(steps) - 2}, "
              f"{1e3 * cfg.batch_size / step_ms:.1f} img/s; device busy "
              f"{busy:.2f} ms/step, idle share {idle:.3f}; a batch made on "
              f"the host in {data_ms:.2f} ms; peak {peak:.2f} "
              f"GiB{usage}; epoch loss {losses}; launches {counts} [{card}]",
              flush=True)
        check(rc == 0 and len(steps) == 8 and all(np.isfinite(losses)),
              f"vae {model}: rc {rc}, {len(steps)} steps, losses {losses}")
        check(dict(counts) == NO_LAUNCHES, f"vae {model} launches {counts}")
        runs.append(counts)
        pair = {}
        for dev, dt in (("cuda", cfg.dtype), ("cpu", "fp32")):
            t = VAETrainer(dataclasses.replace(cfg, dtype=dt), device=dev)
            pair[dev] = (t, t.create_state())
        copy_weights(state.model, pair["cuda"][1].model)
        copy_weights(state.model, pair["cpu"][1].model)
        eps = np.random.default_rng(3).standard_normal(
            (2, cfg.latent_dim)).astype(np.float32)
        kw = dict(eps=eps) if model == "vanilla" else {}
        grad = against_cpu(card, f"vae {model}", pair,
                           lambda tr, st: tr.train_step(st, x[:2], **kw)[1][
                               "loss"])
        stats[model] = dict(step_ms=step_ms, busy_ms=busy, idle=idle,
                            data_ms=data_ms, peak_gib=peak, **grad)
        del trainer, state, pair, calls
    gc.collect()
    torch.cuda.empty_cache()
    return runs, stats


def phase_vit(card):
    """``cli/vit.py train --synthetic`` at its defaults (128^2, patch 32,
    dim 512, depth 6, batch 256, bf16, dropout 0.1) for one epoch (8 steps,
    cut from 10 epochs) and its ``evaluate`` on 2 validation batches:
    ms/step over the last 6, the accuracy; then one step (dropout 0, batch
    16) on the card against the CPU. Returns the counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.cli import vit as vit_cli
    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        SyntheticImageDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vit_trainer import (
        ViTTrainer)

    tmp = tempfile.mkdtemp()
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with watched(ViTTrainer, ("train_step", "evaluate", "fit")) as calls:
            reset_counts()
            t0 = time.perf_counter()
            rc = vit_cli.main(["train", "--synthetic", "--epochs", "1",
                               "--model-dir", tmp, "--device", "cuda"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    trainer, state = calls["fit"][0]["self"], calls["fit"][0]["result"]
    steps = calls["train_step"]
    step_ms = window_ms(steps, 2)
    ev = calls["evaluate"][0]
    eval_ms = ev["start"].elapsed_time(ev["end"])
    cfg, hist = trainer.cfg, trainer.history[-1]
    data_ms, batches = batch_ms(SyntheticImageDataset(
        2 * cfg.batch_size, cfg.img_size, num_classes=cfg.num_class),
        cfg.batch_size)
    busy, _ = busy_per_call(lambda: [trainer.train_step(state, *b)
                                     for b in batches], 2)
    idle = 1.0 - busy / step_ms
    print(f"vit CLI train ({trainer.num_params(state)} params, "
          f"{cfg.img_size}^2, patch {cfg.patch_size}, dim {cfg.dim}, depth "
          f"{cfg.depth}, batch {cfg.batch_size}, {cfg.dtype}): rc {rc}, "
          f"{secs:.2f} s in all; {len(steps)} steps, {step_ms:.2f} ms/step "
          f"over the last {len(steps) - 2}, "
          f"{1e3 * cfg.batch_size / step_ms:.1f} img/s; device busy "
          f"{busy:.2f} ms/step, idle share {idle:.3f}; a batch made on the "
          f"host in {data_ms:.2f} ms; peak {peak:.2f} GiB; "
          f"loss {hist['loss']:.5f}; evaluate {eval_ms:.1f} ms, accuracy "
          f"{ev['result']:.4f} (logged {hist.get('val_acc')}); launches "
          f"{counts} [{card}]", flush=True)
    check(rc == 0 and len(steps) == 8 and np.isfinite(hist["loss"])
          and 0.0 <= ev["result"] <= 1.0,
          f"vit: rc {rc}, {len(steps)} steps, {hist}")
    check(dict(counts) == NO_LAUNCHES, f"vit launches {counts}")
    pair = {}
    for dev, dt in (("cuda", cfg.dtype), ("cpu", "fp32")):
        t = ViTTrainer(dataclasses.replace(cfg, dtype=dt, dropout=0.0,
                                           emb_dropout=0.0), device=dev)
        pair[dev] = (t, t.create_state())
    copy_weights(state.model, pair["cuda"][1].model)
    copy_weights(state.model, pair["cpu"][1].model)
    ds = SyntheticImageDataset(16, cfg.img_size, num_classes=cfg.num_class)
    x = np.stack([ds.load(i)[0] for i in range(16)])
    y = np.asarray([ds.load(i)[1] for i in range(16)])
    grad = against_cpu(card, "vit", pair,
                       lambda tr, st: tr.train_step(st, x, y)[1])
    del trainer, state, pair, calls
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(step_ms=step_ms, busy_ms=busy, idle=idle,
                        data_ms=data_ms, peak_gib=peak, accuracy=ev["result"],
                        **grad)


# --------------------------------------------------------------------------
# Stage 05 and evaluation (group ``clip_eval``): CLIP at CLIP()'s defaults,
# its trainer at 336^2, FID / KID with the FID InceptionV3, and the checks
# and demos CLIs.
# --------------------------------------------------------------------------
# CLIP training at 336^2 (577 tokens, 16 heads of 64): each of the vision
# tower's 24 self-attentions takes K1 in the forward and K3 + K4 in the
# backward; the 77-token causal text tower and every other op stay plain.
CLIP_TRAIN_PER_STEP = dict(K1=24, K2=0, K3=24, K4=24, K5=0, K6=0, K7=0)
# batch; warm (fit), timed steps (5 timed before the wide heads phase)
CLIP_BATCH, CLIP_TRAIN_STEPS = 32, (2, 3)
CLIP_EVAL_IMAGES = 64                       # per set, clip_fid / clip_score
FID_IMAGES = 64                             # per set, inception_features
# checks all on the card: the sd1 UNet's five level-0 self-attentions (8
# heads of 8 over 1024 tokens) and the tiny UNet's (base 64) six of at
# least 512 tokens take K1, all in fp32: three at 64^2 (one head of 64 over
# 4096 tokens) and at 32^2 two of 64 and one of 128 over 1024; every other
# attention of the checks is under 512 tokens.
CHECKS_K1_HEAD_DIMS = {8: 5, 64: 5, 128: 1}
# The card in fp32 (TF32 off) against the CPU in fp32 on the same weights
# and inputs: relative L2 of features and logits. Both sum in another order
# through 24 (12) layers, ~1e-6 a layer; a wrong layer is off by O(1).
CLIP_FP32_TOL = 1e-4
# The card in bf16 compute against the CPU in fp32 (as GRAD_REL_TOL).
CLIP_BF16_TOL = GRAD_REL_TOL
FLASH_CLIP_LEAVES = re.compile(r"^visual\.block\d+\.attn\.qkv\.")


# The vision tower's attention at 336^2, (B, H, Lq, Lk, D): 577 = 9 x 64 + 1
# tokens, so the last tile of 64 keys (K3; K4's second consumer of a
# 128-key block; the fp32 kernels' tiles of 16 to 64) holds a single key or
# query, and K1's bf16 tile of 128 keys 65: a tail no other shape has. Held
# in bf16 here and in fp32 among phase_kernels_fp32's cases too.
CLIP_KERNEL_SHAPE = (CLIP_BATCH, 16, 577, 577, 64)


def tail_faults(q, k, v):
    """Two planted faults of the one-key tail, as (name, q, k, v, pad):
    the last key dropped (what a kernel that skipped the tail tile computes;
    its dk and dv rows padded with zeros) and the last key's logits doubled
    (a tail tile scaled twice)."""
    doubled = k.clone()
    doubled[:, :, -1] *= 2.0
    return (("tail key dropped", q, k[:, :, :-1], v[:, :, :-1], 1),
            ("tail logit doubled", q, doubled, v, 0))


def phase_kernels_clip(card, tail):
    """K1, K3 and K4 at CLIP_KERNEL_SHAPE against the plain version, in bf16
    (the sm90 kernels; times, device time, the library call and the bound)
    and in fp32 (the TF32 kernels; errors here, their times and precision
    faults in phase_kernels_fp32), each with the two planted tail faults,
    which must fall outside the tolerance the kernel is held to. Returns
    kernel name -> list of bf16 records."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(336)
    b, h, lq, lk, d = shape = CLIP_KERNEL_SHAPE
    out_rec = {"K1": [], "K3": [], "K4": []}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        # q, k, v slices of the fused (B, L, 3 C) projection, as attn does
        q, k, v = (t.reshape(b, lq, h, d).transpose(1, 2) for t in
                   torch.randn((b, lq, 3 * h * d), generator=gen,
                               device="cuda").to(dtype).chunk(3, -1))
        g = torch.randn((b, lq, h * d), generator=gen, device="cuda").to(
            dtype).reshape(b, lq, h, d).transpose(1, 2)
        # out, lse absolute; each gradient of its largest magnitude
        tol = (2e-2, 1e-3, 2e-2) if name == "bf16" else (FP32_TOL,) * 3
        n0 = fa.flash_attention_cuda.routes.get(
            "sm90" if name == "bf16" else "fp32", 0)
        o, lse = fa.flash_attention_cuda(q, k, v)
        check(fa.flash_attention_cuda.routes.get(
            "sm90" if name == "bf16" else "fp32", 0) == n0 + 1,
            f"K1 {name} at {shape} did not take its kernel")
        ref, ref_lse = fa.flash_attention_plain(q, k, v)
        grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g)
        want = fa.flash_attention_bwd_plain(q, k, v, ref, ref_lse, g)
        torch.cuda.synchronize()

        def errors(o_, l_, grads_):
            """out, lse and the worst gradient's error against the plain
            version (the gradient's relative to its largest)."""
            return ((o_.float() - ref.float()).abs().max().item(),
                    (l_ - ref_lse).abs().max().item(),
                    max((a.float() - w.float()).abs().max().item()
                        / w.float().abs().max().item()
                        for a, w in zip(grads_, want)))

        err = errors(o, lse, grads)
        faults = {}
        for fault, fq, fk, fv, pad in tail_faults(q, k, v):
            fo, fl = fa.flash_attention_plain(fq, fk, fv)
            fg = list(fa.flash_attention_bwd_plain(fq, fk, fv, fo, fl, g))
            for i in (1, 2):
                fg[i] = torch.cat([fg[i], fg[i].new_zeros(b, h, pad, d)], 2)
            faults[fault] = errors(fo, fl, fg)
            del fo, fl, fg
        check(all(e <= t for e, t in zip(err, tol)),
              f"K1 / K3 / K4 {name} disagree at {shape}: out, lse, grad "
              f"{err}, tol {tol}")
        for fault, fe in faults.items():
            check(any(e > t for e, t in zip(fe, tol)),
                  f"{name} {shape}: the planted fault {fault} ({fe}) is not "
                  f"outside the tolerance {tol}")
        print(f"K1 / K3 / K4 {name} CLIP ViT-L/14@336 (B,H,Lq,Lk,D)={shape} "
              f"(last key tile of one key): max|out err|={err[0]:.3e} "
              f"max|lse err|={err[1]:.3e} max|grad err|/max|grad|="
              f"{err[2]:.3e} (tol {tol}); planted faults (out, lse, grad): "
              + "; ".join(f"{f} {fe[0]:.3e}, {fe[1]:.3e}, {fe[2]:.3e}"
                          for f, fe in faults.items()), flush=True)
        del ref, ref_lse, grads, want
        if name == "bf16":
            run = lambda: fa.flash_attention_cuda(q, k, v)
            times = dict(zip(("bound_ms", "bound_by"),
                             attn_bound(b, h, lq, lk, d)),
                         ms=cuda_ms(run),
                         plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                             q, k, v), 5, 1),
                         library_ms=cuda_ms(
                             lambda: F.scaled_dot_product_attention(q, k, v),
                             10, 2))
            device_ms = kernel_device_ms(run, "K1 flash fwd")
            print(f"K1 flash fwd CLIP ViT-L/14@336 (B,H,Lq,Lk,D)={shape} "
                  f"bf16: {tail(**times)}; device {fmt_ms(device_ms)}",
                  flush=True)
            out_rec["K1"].append(dict(shape=list(shape), max_abs_err=err[0],
                                      lse_err=err[1], device_ms=device_ms,
                                      tail_faults=faults, **times))
            bwd = phase_kernels_bwd(card, q, k, v, o, lse, gen, tail)
            for kname in ("K3", "K4"):
                rec = bwd[kname]
                out_rec[kname].append(dict(shape=list(shape),
                                           max_abs_err=rec.pop("err"),
                                           tail_faults=faults, **rec))
        del q, k, v, g, o, lse
        torch.cuda.empty_cache()
    return out_rec


def clip_model(device, dtype, **cfg):
    """``CLIP(**cfg)`` computing in ``dtype`` over fp32 parameters on
    ``device``, with the JAX module's initializers seeded with 0."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.models.clip import CLIP
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        init_params)

    with torch.device("meta"):
        model = CLIP(**cfg, dtype=dtype)
    model = model.to_empty(device=device)
    init_params(model, 0)
    return model.eval()


def clip_pairs(n, res, seed, device="cuda"):
    """``n`` synthetic (image, caption) pairs made on ``device``: images
    uniform in [-1, 1], captions [BOS, words, EOS, 0 ...] of 77 ids with the
    EOS (49407, the largest id) at a random position."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.rand((n, res, res, 3), generator=gen, device=device)
    tokens = torch.randint(1, 49406, (n, 77), generator=gen, device=device)
    ends = torch.randint(4, 77, (n,), generator=gen, device=device)
    pos = torch.arange(77, device=device)
    tokens = torch.where(pos[None] > ends[:, None], 0, tokens)
    tokens[torch.arange(n, device=device), ends] = 49407
    tokens[:, 0] = 49406
    return images * 2.0 - 1.0, tokens


def _rel(a, b):
    a, b = a.double().cpu().flatten(), b.double().cpu().flatten()
    return ((a - b).norm() / b.norm()).item()


def phase_clip_forward(card):
    """CLIP at CLIP()'s defaults (ViT-L/14 at 224^2, 257 tokens: attention
    plain), random weights from seed 0, in fp32 and bf16: encode_image,
    encode_text and the logits on a batch of 32 (ms per batch, CUDA
    events), clip_score and clip_fid on two sets of 64 images, resident and
    peak memory; the launches over all of it (none: no attention reaches
    512 tokens); the card against the CPU on 2 images with the same
    weights. Returns the counts."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.utils import metrics

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    models = {"fp32": clip_model("cuda", torch.float32)}
    models["bf16"] = clip_model("cuda", torch.bfloat16)
    copy_weights(models["fp32"], models["bf16"])
    resident = (torch.cuda.memory_allocated() - base) / 2 ** 30
    n_params = sum(p.numel() for p in models["fp32"].parameters())
    images, tokens = clip_pairs(CLIP_BATCH, 224, 51)
    set_a, cap_a = clip_pairs(CLIP_EVAL_IMAGES, 224, 52)
    set_b = clip_pairs(CLIP_EVAL_IMAGES, 224, 53)[0] * 0.5
    out = {}
    torch.cuda.synchronize()
    reset_counts()
    for name, model in models.items():
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ms = dict(
                encode_image=cuda_ms(lambda: model.encode_image(images), 5, 2),
                encode_text=cuda_ms(lambda: model.encode_text(tokens), 5, 2),
                logits=cuda_ms(lambda: model(images, tokens), 5, 2))
            logits = model(images, tokens)[0]
        t0 = time.perf_counter()
        score = metrics.clip_score(set_a, cap_a, model)
        fid = metrics.clip_fid(set_a, set_b, model)
        torch.cuda.synchronize()
        metric_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"CLIP() {name} ({n_params} params, 224^2, batch "
              f"{CLIP_BATCH}): encode_image {ms['encode_image']:.2f} ms, "
              f"encode_text {ms['encode_text']:.2f} ms, logits "
              f"{ms['logits']:.2f} ms per batch; clip_score "
              f"{score:.4f} and clip_fid {fid:.4f} on {CLIP_EVAL_IMAGES} "
              f"images in {metric_s:.2f} s; resident {resident:.2f} GiB "
              f"(both models), peak {peak:.2f} GiB [{card}]", flush=True)
        check(bool(torch.isfinite(logits).all()) and logits.shape ==
              (CLIP_BATCH, CLIP_BATCH) and np.isfinite(score)
              and np.isfinite(fid) and fid >= -1e-3,
              f"CLIP {name}: logits, score {score} or fid {fid}")
        out[name] = dict(ms=ms, clip_score=score, clip_fid=fid,
                         metric_s=metric_s, peak_gib=peak)
    counts = read_counts()
    check(dict(counts) == NO_LAUNCHES, f"CLIP at 224^2 launches {counts}")
    # the card against the CPU on 2 images and captions, the same weights
    cpu = clip_model("cpu", torch.float32)
    copy_weights(models["fp32"], cpu)
    with torch.inference_mode():
        want_img = cpu.encode_image(images[:2].cpu())
        want = cpu(images[:2].cpu(), tokens[:2].cpu())[0]
        for name, model in models.items():
            got_img = model.encode_image(images[:2])
            got = model(images[:2], tokens[:2])[0]
            errs = (_rel(got_img, want_img), _rel(got, want))
            tol = CLIP_FP32_TOL if name == "fp32" else CLIP_BF16_TOL
            print(f"CLIP() {name} on the card against fp32 on the CPU, 2 "
                  f"pairs: image features rel L2 {errs[0]:.3e}, logits "
                  f"{errs[1]:.3e} (tol {tol}) [{card}]", flush=True)
            check(max(errs) <= tol, f"CLIP {name} off the CPU's: {errs}")
            out[name]["cpu_rel"] = errs
    del models, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(resident_gib=resident, n_params=n_params, **out)


def phase_clip_training(card):
    """``CLIPTrainer`` at ViT-L/14@336px (``CLIP(image_resolution=336)``, 577
    tokens), bf16 compute over fp32 parameters, on a fixed batch of 32
    synthetic pairs: ``fit`` for CLIP_TRAIN_STEPS[0] steps, then the timed
    ``train_step``s (CUDA events); ms/step, img/s, device idle share (2 more
    steps profiled), peak memory, K1 / K3 / K4 launches per step; the loss
    finite and falling, logit_scale <= ln 100; then a card-against-CPU
    gradient check at full width and 2 + 2 layers. Returns the counts."""
    import math

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.models.clip import CLIP
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.clip_trainer import (
        MAX_LOGIT_SCALE, CLIPTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.logging import (
        MetricsLogger)

    gc.collect()
    torch.cuda.empty_cache()
    with torch.device("meta"):
        template = CLIP(image_resolution=336, dtype=torch.bfloat16)
    trainer = CLIPTrainer(template, device="cuda",
                          logger=MetricsLogger(stream=sys.stdout))
    state = trainer.create_state((336, 336, 3), 77)
    images, tokens = clip_pairs(CLIP_BATCH, 336, 61)
    warm, timed = CLIP_TRAIN_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = trainer.fit([(images, tokens)] * warm, state, epochs=1,
                        image_shape=(336, 336, 3))
    losses, events = [], []
    for _ in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = trainer.train_step(state, images, tokens)
        end.record()
        losses.append(loss)
        events.append((start, end))
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = events[0][0].elapsed_time(events[-1][1]) / timed
    busy, fams = busy_per_call(lambda: [trainer.train_step(state, images,
                                                           tokens)
                                        for _ in range(2)], 2)
    idle = 1.0 - busy / step_ms
    losses = [trainer.history[0]["loss"]] + [float(x) for x in losses]
    scale = state.model.logit_scale.item()
    steps = warm + timed
    want = {k: n * steps for k, n in CLIP_TRAIN_PER_STEP.items()}
    print(f"CLIP training ({trainer.num_params(state)} params, 336^2, 577 "
          f"tokens, batch {CLIP_BATCH}, bf16 over fp32): {step_ms:.2f} "
          f"ms/step over {timed} after {warm} through fit, "
          f"{1e3 * CLIP_BATCH / step_ms:.1f} img/s; device busy "
          f"{busy:.2f} ms/step, idle share {idle:.3f}; peak {peak:.2f} GiB; "
          f"loss {losses[0]:.5f} (fit's epoch mean) -> "
          f"{', '.join(f'{x:.5f}' for x in losses[1:])}; logit_scale "
          f"{scale:.6f} (max {MAX_LOGIT_SCALE:.6f}); launches {dict(counts)}"
          f" over {steps} steps, K1 {counts.k1_routes} "
          f"{counts.k1_head_dims}, K3 {counts.k3_routes}, K4 "
          f"{counts.k4_routes} [{card}]", flush=True)
    print_profile(fams, [], 2, "step")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[1],
          f"CLIP training loss not finite or not falling: {losses}")
    check(scale <= MAX_LOGIT_SCALE + 1e-6, f"logit_scale {scale}")
    check(dict(counts) == want, f"CLIP training launches {dict(counts)} != "
          f"{want}")
    check(counts.k1_routes == {"sm90": want["K1"]}
          and counts.k3_routes == {"sm90": want["K3"]}
          and counts.k4_routes == {"sm90": want["K4"]},
          f"CLIP training routes {counts.k1_routes} {counts.k3_routes} "
          f"{counts.k4_routes}")
    rec = dict(step_ms=step_ms, imgs_per_s=1e3 * CLIP_BATCH / step_ms,
               busy_ms=busy, idle=idle, peak_gib=peak, losses=losses)
    del trainer, state, template
    gc.collect()
    torch.cuda.empty_cache()
    # the card (bf16, kernels) against the CPU (fp32, plain) at full width
    # and 2 vision + 2 text layers
    pair = {}
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        with torch.device("meta"):
            small = CLIP(image_resolution=336, vision_layers=2,
                         transformer_layers=2, dtype=dtype)
        t = CLIPTrainer(small, device=dev)
        pair[dev] = (t, t.create_state((336, 336, 3), 77))
    copy_weights(pair["cuda"][1].model, pair["cpu"][1].model)
    x, y = images[:4].cpu(), tokens[:4].cpu()
    rec.update(against_cpu(card, "CLIP 2 + 2 layers at 336^2", pair,
                           lambda tr, st: tr.train_step(st, x, y)[1],
                           FLASH_CLIP_LEAVES))
    del pair
    gc.collect()
    torch.cuda.empty_cache()
    return counts, rec


def phase_clip_fp32(card):
    """One ``CLIPTrainer`` step at 336^2 in fp32 (CLIP's default dtype) on
    the batch of 32: the fp32 forms of K1, K3 and K4 at d = 64, counted.
    Returns (counts, fp32 counts)."""
    import math

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.models.clip import CLIP
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.clip_trainer import (
        CLIPTrainer)

    gc.collect()
    torch.cuda.empty_cache()
    with torch.device("meta"):
        template = CLIP(image_resolution=336)
    trainer = CLIPTrainer(template, device="cuda")
    state = trainer.create_state((336, 336, 3), 77)
    images, tokens = clip_pairs(CLIP_BATCH, 336, 61)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, loss = trainer.train_step(state, images, tokens)
    end.record()
    end.synchronize()
    counts, fp32 = read_counts(), read_fp32_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"CLIP training fp32 (336^2, batch {CLIP_BATCH}): one step "
          f"{start.elapsed_time(end):.1f} ms (cold), loss {float(loss):.5f}, "
          f"peak {peak:.2f} GiB; launches {dict(counts)}, fp32 {fp32}, K1 "
          f"{counts.k1_routes} {counts.k1_head_dims} [{card}]", flush=True)
    want = dict(CLIP_TRAIN_PER_STEP)
    check(math.isfinite(float(loss)) and dict(counts) == want
          and counts.k1_routes == {"fp32": 24} and fp32["K1"] == 24
          and fp32["K3"] == 24 and fp32["K4"] == 24,
          f"CLIP fp32 step: loss {float(loss)}, launches {dict(counts)}, "
          f"fp32 {fp32}")
    del trainer, state, template
    gc.collect()
    torch.cuda.empty_cache()
    return counts, fp32


def pytorch_fid_checkpoint(path, seed=71):
    """A synthetic checkpoint in pytorch-fid's layout (torchvision
    InceptionV3 names, BatchNorm statistics, the fc and AuxLogits heads)
    that keeps random-weight activations in range: He-normal convs, BN
    scales near 1."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.weights_inception import (
        basic_conv_paths)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.inception import (
        InceptionV3FID)

    with torch.device("meta"):
        model = InceptionV3FID()
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    state = {}
    for p in basic_conv_paths():
        w = model.get_submodule(p).conv.weight
        c, fan_in = w.shape[0], w[0].numel()
        state[f"{p}.conv.weight"] = f32(rng.standard_normal(w.shape)
                                        * np.sqrt(2.0 / fan_in))
        state[f"{p}.bn.weight"] = f32(1.0 + 0.1 * rng.standard_normal(c))
        state[f"{p}.bn.bias"] = f32(0.1 * rng.standard_normal(c))
        state[f"{p}.bn.running_mean"] = f32(0.1 * rng.standard_normal(c))
        state[f"{p}.bn.running_var"] = f32(1.0 + rng.random(c))
        state[f"{p}.bn.num_batches_tracked"] = torch.tensor(1)
    state["fc.weight"] = f32(rng.standard_normal((1008, 2048)) * 0.01)
    state["fc.bias"] = f32(np.zeros(1008))
    torch.save(state, path)


def phase_fid(card):
    """``inception_features`` (the FID InceptionV3 from a synthetic
    pytorch-fid checkpoint through ``import_inception_fid``) on 64 images at
    512^2 (the antialiased downsample to 299^2) and 64 at 64^2 (the
    upsample), batches of 32; ``inception_fid`` and ``kid_from_features``;
    ms per image at 299^2, peak memory, the card against the CPU on 2
    images. Returns the counts."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.weights_inception import (
        import_inception_fid)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.inception import (
        resize_for_fid)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils import metrics

    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "pt_inception.pth")
        pytorch_fid_checkpoint(path)
        t0 = time.perf_counter()
        params = import_inception_fid(path)
        import_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(72)
    big = torch.rand((FID_IMAGES, 512, 512, 3), generator=gen, device="cuda")
    small = torch.rand((FID_IMAGES, 64, 64, 3), generator=gen,
                       device="cuda") ** 2
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    feats, secs = {}, {}
    for name, images in (("512^2", big), ("64^2", small)):
        metrics.inception_features(images[:32], params)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats[name] = metrics.inception_features(images, params)
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid = metrics.inception_fid(big, small, params)
    fid_s = time.perf_counter() - t0
    kid = metrics.kid_from_features(feats["512^2"], feats["64^2"])
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model = metrics.inception_model(params)
    with torch.inference_mode():
        resized = resize_for_fid(small[:32])
        model_ms = cuda_ms(lambda: model(resized), 5, 2) / 32
    del model
    cpu = metrics.inception_features(big[:2].cpu(), params, device="cpu")
    err = _rel(torch.from_numpy(feats["512^2"][:2]), torch.from_numpy(cpu))
    print(f"FID InceptionV3 (a synthetic pytorch-fid checkpoint imported in "
          f"{import_s:.2f} s): inception_features of {FID_IMAGES} images "
          f"from 512^2 in {secs['512^2']:.3f} s and from 64^2 in "
          f"{secs['64^2']:.3f} s ({1e3 * secs['512^2'] / FID_IMAGES:.3f} / "
          f"{1e3 * secs['64^2'] / FID_IMAGES:.3f} ms per image, resize "
          f"included); the model alone {model_ms:.3f} ms per image at 299^2 "
          f"(batch 32); inception_fid {fid:.4f} in {fid_s:.3f} s, KID "
          f"{kid:.6f}; peak {peak:.2f} GiB; the card against the CPU on 2 "
          f"images: features rel L2 {err:.3e} (tol {CLIP_FP32_TOL}); "
          f"launches {dict(counts)} [{card}]", flush=True)
    check(all(f.shape == (FID_IMAGES, 2048) and np.isfinite(f).all()
              for f in feats.values()) and np.isfinite(fid) and fid > 0
          and np.isfinite(kid), f"FID: features, fid {fid} or kid {kid}")
    check(err <= CLIP_FP32_TOL, f"Inception card off the CPU's: {err}")
    check(dict(counts) == NO_LAUNCHES, f"FID launches {counts}")
    del big, small
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(secs=secs, model_ms_per_image=model_ms, fid=fid,
                        kid=kid, peak_gib=peak, cpu_rel=err)


def openai_checkpoint(path, model):
    """``model`` (a port CLIP) written in the OpenAI layout: the inverse of
    ``openai_clip_rules`` (a port weight is already in torch's layout),
    ``in_proj_weight`` names, the TorchScript metadata tensors."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.weights import port_key
    from from_ddpm_to_stable_diffusion_tpu_torch.io.weights_clip import (
        openai_clip_rules)

    cfg = model.config
    sd = model.state_dict()
    state = {t.replace("in_proj.", "in_proj_"): sd[port_key(f)].cpu()
             for t, f, _ in openai_clip_rules(cfg["vision_layers"],
                                              cfg["transformer_layers"])}
    state.update(input_resolution=torch.tensor(cfg["image_resolution"]),
                 context_length=torch.tensor(cfg["context_length"]),
                 vocab_size=torch.tensor(cfg["vocab_size"]))
    torch.save(state, path)


def phase_checks_cli(card):
    """``checks all --device cuda`` in this process with the launches counted
    (fp32 K1 at d = 8 in checks sd1) and through ``python -m`` in a
    subprocess (exit 0, the same lines); ``checks weights`` on a .pt and a
    .safetensors the phase writes; ``checks clip --ckpt`` on CLIP() written
    in the OpenAI layout with a synthetic vocabulary and PNG, where Pillow
    is importable; ``demos replicate`` without a token and ``demos
    multimodal`` / ``video`` without transformers / diffusers (their
    imports blocked, so nothing reaches for the network): each exits with
    its actionable error. Returns (counts, fp32 counts) of checks all."""
    import importlib.util
    import io
    import os
    import shutil
    import tempfile

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.cli import checks
    from from_ddpm_to_stable_diffusion_tpu_torch.io.weights import (
        save_safetensors_dict)

    pkg = "from_ddpm_to_stable_diffusion_tpu_torch"
    gc.collect()
    torch.cuda.empty_cache()
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = checks.main(["all", "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, fp32 = read_counts(), read_fp32_counts()
    lines = buf.getvalue().splitlines()
    print(f"checks all --device cuda (in process): rc {rc}, {secs:.2f} s, "
          f"{len(lines)} lines; launches {dict(counts)}, fp32 {fp32}, K1 by "
          f"head dim {counts.k1_head_dims}, routes {counts.k1_routes} "
          f"[{card}]", flush=True)
    for line in lines:
        print("  " + line)
    check(rc == 0 and lines[-1] == "all checks passed",
          f"checks all: rc {rc}, last line {lines[-1:]}")
    check(counts.k1_head_dims == CHECKS_K1_HEAD_DIMS
          and counts.k1_routes == {"fp32": sum(CHECKS_K1_HEAD_DIMS.values())}
          and fp32["K1"] == counts["K1"] and counts["K2"] > 0,
          f"checks all: K1 by head dim {counts.k1_head_dims}, routes "
          f"{counts.k1_routes}, K2 {counts['K2']}")
    env = dict(os.environ)
    env.pop("REPLICATE_API_TOKEN", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", pkg, "checks", "all",
                           "--device", "cuda"], capture_output=True,
                          text=True, timeout=600, env=env)
    sub_s = time.perf_counter() - t0
    print(f"python -m {pkg} checks all --device cuda: rc "
          f"{proc.returncode} in {sub_s:.2f} s, the same lines: "
          f"{proc.stdout.splitlines() == lines} [{card}]", flush=True)
    check(proc.returncode == 0 and proc.stdout.splitlines() == lines,
          f"python -m checks all: rc {proc.returncode}, "
          f"{proc.stderr[-2000:]}")
    tmp = tempfile.mkdtemp()
    try:
        small = {"visual.proj": torch.randn(1024, 768),
                 "logit_scale": torch.tensor(4.6),
                 "token_embedding.weight": torch.randn(8, 768,
                                                       dtype=torch.float16)}
        for name in ("w.pt", "w.safetensors"):
            path = os.path.join(tmp, name)
            if name.endswith(".pt"):
                torch.save(small, path)
            else:
                save_safetensors_dict(small, path)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = checks.main(["weights", path])
            got = buf.getvalue().splitlines()
            print(f"checks weights {name}: rc {rc}: " + "; ".join(got),
                  flush=True)
            check(rc == 0 and got[-1] == "3 tensors" and
                  "token_embedding.weight: (8, 768) float16" in got,
                  f"checks weights {name}: {got}")
        if importlib.util.find_spec("PIL") is None:
            print("checks clip --ckpt: not run, Pillow is not installed "
                  "here (the check reads its image with Pillow)",
                  flush=True)
        else:
            import numpy as np
            from PIL import Image

            from from_ddpm_to_stable_diffusion_tpu_torch.io.tokenizer import (
                build_simple_vocab)

            model = clip_model("cuda", torch.float32)
            ckpt = os.path.join(tmp, "clip.pt")
            openai_checkpoint(ckpt, model)
            del model
            vocab, merges = build_simple_vocab(["a", "cat", "dog", "wild",
                                                "animal"])
            with open(os.path.join(tmp, "vocab.json"), "w") as f:
                json.dump(vocab, f)
            with open(os.path.join(tmp, "merges.txt"), "w") as f:
                f.write("\n".join(["#version: 0.2"] + [
                    f"{a} {b}" for (a, b), _ in sorted(
                        merges.items(), key=lambda kv: kv[1])]) + "\n")
            img = os.path.join(tmp, "cat.png")
            Image.fromarray((np.random.default_rng(0).random((300, 400, 3))
                             * 255).astype(np.uint8)).save(img)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = checks.main(["clip", "--ckpt", ckpt, "--image", img,
                                  "--vocab-dir", tmp, "--device", "cuda"])
            clip_s = time.perf_counter() - t0
            got = buf.getvalue().splitlines()
            probs = [float(line.rsplit(":", 1)[1]) for line in got]
            print(f"checks clip --ckpt (CLIP() in the OpenAI layout, "
                  f"{os.path.getsize(ckpt) / 2 ** 30:.2f} GiB): rc {rc} in "
                  f"{clip_s:.2f} s: " + "; ".join(got) + f" [{card}]",
                  flush=True)
            check(rc == 0 and len(probs) == 3
                  and abs(sum(probs) - 1.0) <= 2e-3,
                  f"checks clip --ckpt: {got}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # demos: the imports blocked in the child, so that a machine with
    # transformers installed still never reaches for a download
    block = ("import sys; sys.modules['transformers'] = None; "
             "sys.modules['diffusers'] = None; "
             f"from {pkg}.__main__ import main; sys.exit(main(sys.argv[1:]))")
    for argv, msg in ((["demos", "replicate", "--version", "v",
                        "--input-json", "{}"], "REPLICATE_API_TOKEN"),
                      (["demos", "multimodal", "--image", "x.png",
                        "--question", "q"], "transformers is required"),
                      (["demos", "video", "--prompt", "a cat"],
                       "diffusers is required")):
        proc = subprocess.run([sys.executable, "-c", block, *argv],
                              capture_output=True, text=True, timeout=300,
                              env=env)
        last = (proc.stderr.strip().splitlines() or [""])[-1]
        print(f"{' '.join(argv[:2])}: rc {proc.returncode}: {last}",
              flush=True)
        check(proc.returncode != 0 and "RuntimeError" in last
              and msg in last, f"{' '.join(argv)}: rc {proc.returncode}, "
              f"{proc.stderr[-1000:]}")
    gc.collect()
    torch.cuda.empty_cache()
    return counts, fp32


# --------------------------------------------------------------------------
# parallel: the sequence-, pipeline- and expert-parallel MMDiT
# --------------------------------------------------------------------------
# One card: every mesh is the card repeated ([cuda] * n), the one-process
# form of parallel/mesh.py, so the n shards of a ring take turns on it.
RING_N = 4
# SD3's joint sequence at 1024^2 (154 context + 4096 latent tokens = 4250),
# padded to a multiple of 4: 4 shards of 1063 tokens
RING_SHAPE, RING_VALID, RING_LC = (2, 24, 4252, 64), 4250, 154
RING_CAUSAL_SHAPE = (1, 8, 16384, 64)   # JAX test_ring_flash_long_sequence_16k
# a ring call: n hops of K5 for each of n query shards; its backward as many
# K6 and K7; an MMDiT forward runs one ring in each of its 24 joint blocks
RING_CALL = dict(K1=0, K2=0, K3=0, K4=0, K5=RING_N ** 2, K6=0, K7=0)
RING_K5_PER_FORWARD = SD3_DEPTH * RING_N ** 2
# the ring SD3 request and the ring training steps cut from 4 and 2 to pay
# for the TP x SP phases
RING_SD3_STEPS, ULYSSES_SD3_STEPS, RING_TRAIN_STEPS = 2, 2, 1
# pipeline: joint blocks 0..19 over 4 stages (n_blocks must divide them: 23
# do not), 4 microbatches of 1, then blocks 20..22 whole
PP_STAGES, PP_MICRO, PP_BLOCKS = 4, 4, 20
MOE_EXPERTS, MOE_TRAIN_EXPERTS = 4, 2
# ring / Ulysses against the split-KV flash MMDiT: the same function up to
# bf16 reassociation; a wrong hop offset, merge or mask is off by O(1)
PARALLEL_REL_TOL = GRAD_REL_TOL


def card_mesh(n=RING_N, axis="seq"):
    """A one-process mesh of the card repeated ``n`` times."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh

    return build_mesh({axis: n}, [torch.device("cuda")] * n)


def launches_since(n0):
    n1 = read_counts()
    return {k: n1[k] - n0[k] for k in n1}


def _grad_errors(what, got, want, tol=2e-2):
    """max|err| / max|want| of each (name, got, want); checked against
    ``tol`` of the largest magnitude (the K6 / K7 tolerance)."""
    line = []
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = (a.float() - w.float()).abs().max().item()
        ref = w.float().abs().max().item()
        check(bool(a.isfinite().all()) and err <= tol * ref + 1e-6,
              f"{what} {name}: {err} > {tol} * {ref}")
        line.append(f"{name} {err:.3e}/{ref:.3e}")
    return ", ".join(line) + f" (tol {tol} of the largest)"


def hop_kernels(card, what, qs, ks, vs, gs, q_off, k_off, valid, extra,
                fams=("K5 flash fwd pos", "K6 flash bwd pos dq",
                      "K7 flash bwd pos dk/dv")):
    """K5, K6 and K7 at one ring hop: a query shard (B, H, Lq, D) against a
    key shard at their global offsets (``q_off``, ``k_off``: the first
    segment's start, the second unused) under ``valid_len`` ``valid``.
    Each against its plain version (K5 out 2e-2, lse 1e-3; K6 / K7 2e-2 of
    each gradient's largest magnitude, under K5's lse), then timed with its
    device time (the profiler families ``fams`` of K5, K6, K7), the plain
    version, the library call (one scaled_dot_product_attention on the
    shard, its whole backward for K6 / K7) and the bound over the visible
    keys. Returns ({name: record}, the errors as a line); ``extra`` goes
    into each record."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    b, h, n_q, d = qs.shape
    n_k = ks.shape[2]
    qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
    ko = torch.tensor(k_off, dtype=torch.int32, device="cuda")
    kw = dict(seg_q=n_q, seg_k=n_k, valid_len=valid)
    o_s, lse_s = fa.flash_attention_pos_cuda(qs, ks, vs, qo, ko, **kw)
    o_p, lse_p = fa.flash_attention_pos_plain(qs, ks, vs, qo, ko, **kw)
    e_o = (o_s.float() - o_p.float()).abs().max().item()
    e_l = (lse_s - lse_p).abs().max().item()
    check(e_o <= 2e-2 and e_l <= 1e-3, f"K5 at {what}: out {e_o}, lse {e_l}")
    delta_s = (gs.float() * o_s.float()).sum(-1)
    gs_k = gs.contiguous()
    hop_g = (fa.flash_bwd_pos_dq_cuda(qs, ks, vs, gs_k, lse_s, delta_s, qo,
                                      ko, **kw),
             *fa.flash_bwd_pos_dkv_cuda(qs, ks, vs, gs_k, lse_s, delta_s, qo,
                                        ko, **kw))
    errs = _grad_errors(f"K6 / K7 at {what}", hop_g,
                        fa.flash_bwd_pos_plain(qs, ks, vs, gs, lse_s,
                                               delta_s, qo, ko, **kw))
    visible = min(n_k, max(0, valid - k_off[0]))
    ql, kl, vl = (t.detach().requires_grad_() for t in (qs, ks, vs))
    ol = F.scaled_dot_product_attention(ql, kl, vl)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(ol, (ql, kl, vl), gs,
                                                  retain_graph=True), 10, 2)
    plain_bwd = cuda_ms(lambda: fa.flash_bwd_pos_plain(
        qs, ks, vs, gs, lse_s, delta_s, qo, ko, **kw), 3, 1)
    shape = f"({b},{h},{n_q},{n_k},{d}) q offsets {tuple(q_off)}, kv " \
            f"offsets {tuple(k_off)}, valid_len {valid}"
    hop = {}
    for name, fn, fam, products, counts in (
            ("K5", lambda: fa.flash_attention_pos_cuda(qs, ks, vs, qo, ko,
                                                        **kw),
             fams[0], 2, (2, 2, 1)),
            ("K6", lambda: fa.flash_bwd_pos_dq_cuda(
                qs, ks, vs, gs_k, lse_s, delta_s, qo, ko, **kw),
             fams[1], 3, (3, 2, 2)),
            ("K7", lambda: fa.flash_bwd_pos_dkv_cuda(
                qs, ks, vs, gs_k, lse_s, delta_s, qo, ko, **kw),
             fams[2], 4, (2, 4, 2))):
        bound_ms, bound_by = attn_bound(b, h, n_q, visible, d, products,
                                        *counts)
        hop[name] = dict(
            shape=shape, ms=cuda_ms(fn, 20, 3),
            device_ms=kernel_device_ms(fn, fam), bound_ms=bound_ms,
            bound_by=bound_by, **extra,
            plain_ms=(cuda_ms(lambda: fa.flash_attention_pos_plain(
                qs, ks, vs, qo, ko, **kw), 3, 1) if name == "K5"
                      else plain_bwd),
            library_ms=(cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs), 20, 3) if name == "K5" else lib_bwd),
            library=("F.scaled_dot_product_attention on the shard"
                     if name == "K5" else "its backward (dq, dk, dv)"))
        r = hop[name]
        print(f"{name} at {what} {shape} bf16: kernel {r['ms']:.4f} ms, "
              f"device {fmt_ms(r['device_ms'])}, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]",
              flush=True)
    del ol, ql, kl, vl
    return hop, f"K5 out {e_o:.3e} lse {e_l:.3e}; K6 / K7 {errs}"


def phase_kernels_ring(card):
    """The ring on a 4-shard mesh of the card: K5 under hop offsets and K6 /
    K7 under the merged global lse, at the MMDiT's joint sequence (2, 24,
    4252, 64) with kv_valid_len 4250, forward and backward, against the
    one-device joint attention (4 x K5 split-KV; 4 x K6 + 4 x K7) and the
    plain version; then causal zig-zag at (1, 8, 16384, 64) against K1 / K3 /
    K4 causal over the whole sequence. n^2 launches of each per call. One
    ring call timed by device time (profiler) and wall time; the hop
    kernels at (2, 24, 1063, 1063, 64) with their bound, the plain version
    and one scaled_dot_product_attention on the same shard."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel.ring_attention import (
        ring_attention)

    bf16 = torch.bfloat16
    mesh = card_mesh()
    gen = torch.Generator(device="cuda").manual_seed(19)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(bf16)
    b, h, l, d = RING_SHAPE
    V, lc = RING_VALID, RING_LC
    q, k, v, g = (rnd(b, h, l, d) for _ in range(4))
    g[:, :, V:] = 0          # the padded rows are sliced off: no gradient
    ring = lambda *x: ring_attention(*x, mesh, kv_valid_len=V)
    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    streams = lambda t: (t[:, :, :lc], t[:, :, lc:V])

    # forward: 16 K5 launches, against the joint attention and plain
    n0 = read_counts()
    out = ring(q, k, v)
    torch.cuda.synchronize()
    fwd = launches_since(n0)
    check(fwd == RING_CALL, f"a ring forward launched {fwd}, not {RING_CALL}")
    (qc, qx), (kc, kx), (vc, vx) = streams(q), streams(k), streams(v)
    joint = torch.cat(fa.joint_flash_attention(qc, kc, vc, qx, kx, vx), 2)
    plain, plain_lse = fa.flash_attention_pos_plain(q, k, v, z, z,
                                                    valid_len=V)
    e_joint = (out[:, :, :V].float() - joint.float()).abs().max().item()
    e_plain = (out[:, :, :V].float() - plain[:, :, :V].float()).abs().max(
    ).item()
    check(e_joint <= 2e-2 and e_plain <= 2e-2,
          f"ring forward off: joint {e_joint}, plain {e_plain} (atol 2e-2)")

    # backward: 16 K6 and 16 K7 under the merged lse
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    n0 = read_counts()
    o = ring(*leaves)
    grads = torch.autograd.grad(o, leaves, g, retain_graph=True)
    torch.cuda.synchronize()
    both = launches_since(n0)
    want = dict(RING_CALL, K6=RING_N ** 2, K7=RING_N ** 2)
    check(both == want, f"ring forward + backward launched {both}, not "
                        f"{want}")
    check(all(float(t[:, :, V:].abs().max()) == 0.0 for t in grads[1:]),
          "the padded keys got a gradient")
    jl = [t.detach().requires_grad_() for t in (qc, kc, vc, qx, kx, vx)]
    oc, ox = fa.joint_flash_attention(*jl)
    jg = torch.autograd.grad((oc, ox), jl, streams(g))
    joint_g = [torch.cat([jg[i], jg[i + 3]], 2) for i in range(3)]
    delta = (g.float() * plain.float()).sum(-1)
    plain_g = fa.flash_bwd_pos_plain(q, k, v, g, plain_lse, delta, z, z,
                                     valid_len=V)
    mine = [t[:, :, :V] for t in grads]
    errs_joint = _grad_errors("ring backward vs joint", mine, joint_g)
    errs_plain = _grad_errors("ring backward vs plain", mine,
                              [t[:, :, :V] for t in plain_g])
    del jl, oc, ox, jg, plain_g, plain
    gc.collect()

    # one ring call: device time (profiler) and wall time (host clock over
    # calls that end in a synchronise)
    def wall_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    back = lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)
    call = dict(fwd_wall_ms=wall_ms(lambda: ring(q, k, v)),
                bwd_wall_ms=wall_ms(back))
    fams_f = device_families(lambda: ring(q, k, v), "K5 flash fwd pos")
    fams_b = device_families(back, "K7 flash bwd pos dk/dv")
    call.update(
        fwd_device_ms=sum(fams_f.values()) or None,
        fwd_k5_device_ms=fams_f.get("K5 flash fwd pos"),
        bwd_device_ms=sum(fams_b.values()) or None,
        bwd_k6_device_ms=fams_b.get("K6 flash bwd pos dq"),
        bwd_k7_device_ms=fams_b.get("K7 flash bwd pos dk/dv"),
        joint_fwd_ms=cuda_ms(lambda: fa.joint_flash_attention(
            qc, kc, vc, qx, kx, vx), 5, 1),
        library_fwd_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, :V], k[:, :, :V], v[:, :, :V]), 5, 1),
        launches_fwd=RING_N ** 2, launches_bwd=dict(K6=RING_N ** 2,
                                                   K7=RING_N ** 2))
    print(f"ring attention (B,H,L,D)={RING_SHAPE} bf16 over {RING_N} shards "
          f"of the card, kv_valid_len {V}: forward max|err| against the "
          f"joint attention {e_joint:.3e}, against plain {e_plain:.3e} (atol "
          f"2e-2); backward against the joint attention {errs_joint}, "
          f"against plain {errs_plain}; launches forward {fwd}, forward + "
          f"backward {both}; one ring call: forward wall "
          f"{call['fwd_wall_ms']:.3f} ms, device busy "
          f"{fmt_ms(call['fwd_device_ms'])} (K5 "
          f"{fmt_ms(call['fwd_k5_device_ms'])}); backward wall "
          f"{call['bwd_wall_ms']:.3f} ms, device busy "
          f"{fmt_ms(call['bwd_device_ms'])} (K6 "
          f"{fmt_ms(call['bwd_k6_device_ms'])}, K7 "
          f"{fmt_ms(call['bwd_k7_device_ms'])}); one-device joint attention "
          f"forward {call['joint_fwd_ms']:.3f} ms, library forward (one "
          f"scaled_dot_product_attention over {V}) "
          f"{call['library_fwd_ms']:.3f} ms [{card}]", flush=True)
    print("ring forward profile (one call):", flush=True)
    print_profile(fams_f, [], 1, "call")
    del o, leaves, grads

    # the hop kernels: shard 0's queries against shard 3's keys, whose last
    # two are the padding (the ragged hop), at their global offsets
    n_l = l // RING_N
    hop, errs_hop = hop_kernels(
        card, "the ring hop", q[:, :, :n_l], k[:, :, 3 * n_l:],
        v[:, :, 3 * n_l:], g[:, :, :n_l], (0, 0), (3 * n_l, 0), V,
        dict(launches_per_ring_call=RING_N ** 2))
    print(f"ring hop errors: {errs_hop}", flush=True)
    del out, q, k, v, g

    # causal zig-zag at 16k against K1 / K3 / K4 causal over the whole
    b2, h2, l2, d2 = RING_CAUSAL_SHAPE
    q2, k2, v2, g2 = (rnd(b2, h2, l2, d2) for _ in range(4))
    leaves = [t.detach().requires_grad_() for t in (q2, k2, v2)]
    n0 = read_counts()
    o2 = ring_attention(*leaves, mesh, causal=True)
    got = torch.autograd.grad(o2, leaves, g2)
    torch.cuda.synchronize()
    causal = launches_since(n0)
    check(causal == want, f"causal ring forward + backward launched "
                          f"{causal}, not {want}")
    check(fa.flash_attention_pos_cuda.routes.get("sm90", 0) > 0,
          "the ring's K5 did not take sm90")
    ref_leaves = [t.detach().requires_grad_() for t in (q2, k2, v2)]
    o_ref = fa.flash_attention(*ref_leaves, causal=True)
    ref_g = torch.autograd.grad(o_ref, ref_leaves, g2)
    e_c = (o2.float() - o_ref.float()).abs().max().item()
    check(e_c <= 2e-2, f"causal ring forward off K1 causal: {e_c}")
    errs_c = _grad_errors("causal ring backward vs K3 / K4", got, ref_g)
    ring_ms = wall_ms(lambda: ring_attention(q2, k2, v2, mesh, causal=True))
    k1_ms = cuda_ms(lambda: fa.flash_attention_cuda(q2, k2, v2, causal=True),
                    5, 1)
    print(f"causal zig-zag ring (B,H,L,D)={RING_CAUSAL_SHAPE} bf16 over "
          f"{RING_N} shards: forward max|err| against K1 causal {e_c:.3e} "
          f"(atol 2e-2); backward against K3 / K4 causal {errs_c}; launches "
          f"{causal} (two segments a side); forward wall {ring_ms:.3f} ms, "
          f"K1 causal over the whole {k1_ms:.3f} ms [{card}]", flush=True)
    call.update(causal_fwd_wall_ms=ring_ms, causal_k1_ms=k1_ms)
    del o2, got, o_ref, ref_g, leaves, ref_leaves
    gc.collect()
    torch.cuda.empty_cache()
    return dict(hop, call=call, errors=dict(
        joint=e_joint, plain=e_plain, causal=e_c))


def phase_parallel_sd3(card, source):
    """On the SD3-medium bundle: an SD3 request at 1024^2, CFG 5, shift 3
    through the ring MMDiT (4 shards of the card) and one through the
    Ulysses MMDiT, each against the same request on the flash MMDiT (steps
    cut, width and depth whole); then the pipelined joint blocks (20 of
    them over 4 stages and 4 microbatches, the rest whole) against the
    sequential blocks, and one 1F1B step over 4 one-block stages against
    autograd. Returns the launches of each path."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.models.mmdit import (
        make_joint_block_stage_fn, pipelined_joint_blocks,
        stack_joint_block_params)
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel.pipeline import (
        pipeline_value_and_grad)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer)

    models = source["models"]
    mmdit = models.mmdit
    inf = SD3Inferencer(models, shift=3.0)
    tokens = np.zeros((1, 77), np.int32)
    request = lambda steps: inf.gen_image(
        tokens, width=1024, height=1024, steps=steps, cfg_scale=5.0,
        seed=source["seed"])
    step_events, final_latents = [], []
    hooks = request_hooks(models, step_events, final_latents)
    mesh = card_mesh()
    runs = []
    try:
        for impl, steps in (("ring", RING_SD3_STEPS),
                            ("ulysses", ULYSSES_SD3_STEPS)):
            mmdit.set_attention("flash")
            final_latents.clear()
            flash_image = request(steps)
            flash_latents = final_latents[-1]
            mmdit.set_attention(impl, mesh)
            final_latents.clear()
            step_events.clear()
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            image = request(steps)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            got = read_counts()
            want = sd3_counts(1, 30, 0)
            want["K5"] = RING_K5_PER_FORWARD * steps if impl == "ring" else 0
            check(dict(got) == want, f"SD3 {impl} request launched "
                                     f"{dict(got)}, not {want}")
            rel = rel_l2(final_latents[-1], flash_latents)
            lv = levels(image, flash_image)
            check(image.shape == (1, 1024, 1024, 3)
                  and rel <= PARALLEL_REL_TOL,
                  f"SD3 {impl} request off the flash one: final latents rel "
                  f"L2 {rel}")
            print(f"SD3 request through the {impl} MMDiT ({RING_N} shards of "
                  f"the card; 1024^2, {steps} flow-Euler steps, CFG 5, "
                  f"shift 3, seed {source['seed']}): {secs:.3f} s/image, "
                  f"{step_ms(step_events):.2f} ms/denoise step; against the "
                  f"flash MMDiT's request of as many steps: final latents "
                  f"rel L2 {rel:.3e} (tol {PARALLEL_REL_TOL}), image max "
                  f"{lv[0]} mean {lv[1]:.4f} levels; launches {dict(got)}, "
                  f"K5 {got.k5_routes} [{card}]", flush=True)
            runs.append(got)
    finally:
        for hook in hooks:
            hook.remove()
        mmdit.set_attention("flash")

    # pipeline parallelism on the bundle's depth-24 MMDiT (bf16)
    cfg = mmdit.config
    hs, bf16 = cfg.hidden_size, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(23)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(bf16)
    context, x, c = rnd(PP_MICRO, RING_LC, hs), rnd(PP_MICRO, 4096, hs), \
        rnd(PP_MICRO, hs)
    params = dict(mmdit.named_parameters())
    stages = card_mesh(PP_STAGES, "stage")
    blocks = [getattr(mmdit, f"joint_block{i}") for i in range(cfg.depth - 1)]
    with torch.no_grad():
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        ctx_pp, x_pp = pipelined_joint_blocks(
            cfg, params, context, x, c, stages, PP_MICRO, n_blocks=PP_BLOCKS)
        for blk in blocks[PP_BLOCKS:]:
            ctx_pp, x_pp = blk(ctx_pp, x_pp, c)
        torch.cuda.synchronize()
        pp_s = time.perf_counter() - t
        pp = read_counts()
        t = time.perf_counter()
        ctx_s, x_s = context, x
        for blk in blocks:
            ctx_s, x_s = blk(ctx_s, x_s, c)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t
    want = sd3_counts(0, 0, 0)
    want["K5"] = 4 * (PP_BLOCKS * PP_MICRO + cfg.depth - 1 - PP_BLOCKS)
    rel = max(rel_l2(x_pp, x_s), rel_l2(ctx_pp, ctx_s))
    check(dict(pp) == want, f"pipelined blocks launched {dict(pp)}, not "
                            f"{want}")
    check(rel <= PARALLEL_REL_TOL, f"pipelined blocks off the sequential "
                                   f"ones: rel L2 {rel}")
    print(f"pipelined joint blocks (SD3-medium's, bf16): blocks 0-"
          f"{PP_BLOCKS - 1} over {PP_STAGES} stages of the card x "
          f"{PP_MICRO} microbatches of 1, blocks {PP_BLOCKS}-{cfg.depth - 2} "
          f"whole, batch {PP_MICRO} at {RING_LC} + 4096 tokens: {pp_s:.3f} s "
          f"(GPipe ticks one after another on one card), the sequential "
          f"stack {seq_s:.3f} s; rel L2 against it {rel:.3e} (tol "
          f"{PARALLEL_REL_TOL}); launches {dict(pp)} [{card}]", flush=True)
    runs.append(pp)
    del ctx_pp, x_pp, ctx_s, x_s

    # 1F1B over 4 one-block stages against autograd of the whole stack
    sp = {k_: v_.detach() for k_, v_ in stack_joint_block_params(
        params, PP_STAGES, PP_STAGES).items()}
    stage_fn = make_joint_block_stage_fn(cfg, RING_LC, 1)
    zz = torch.cat([context, x, c[:, None]], dim=1)
    tgt = rnd(*zz.shape)
    loss_fn = lambda y_, t_: torch.mean((y_.float() - t_.float()) ** 2)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss, grads = pipeline_value_and_grad(stage_fn, sp, zz, tgt, loss_fn,
                                          stages, PP_MICRO)
    torch.cuda.synchronize()
    f1b_s = time.perf_counter() - t
    f1b = read_counts()
    ref = {k_: v_.clone().requires_grad_() for k_, v_ in sp.items()}
    out = zz
    for s_ in range(PP_STAGES):
        out = stage_fn({k_: v_[s_] for k_, v_ in ref.items()}, out)
    ref_loss = loss_fn(out, tgt)
    ref_g = torch.autograd.grad(ref_loss, list(ref.values()))
    num = sum(((grads[n].float() - r.float()) ** 2).sum().item()
              for n, r in zip(ref, ref_g))
    den = sum((r.float() ** 2).sum().item() for r in ref_g)
    g_rel = (num / den) ** 0.5
    l_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    want = sd3_counts(0, 0, 0)
    n_fb = PP_STAGES * PP_MICRO * 4     # 4 joint-attention partials a block
    want.update(K5=2 * n_fb, K6=n_fb, K7=n_fb)   # the backward recomputes
    check(dict(f1b) == want, f"1F1B launched {dict(f1b)}, not {want}")
    check(g_rel <= PARALLEL_REL_TOL and l_rel <= PARALLEL_REL_TOL,
          f"1F1B off autograd: loss rel {l_rel}, gradients rel L2 {g_rel}")
    print(f"1F1B pipeline_value_and_grad (SD3-medium's blocks 0-3 as "
          f"{PP_STAGES} stages, {PP_MICRO} microbatches of 1, bf16): "
          f"{f1b_s:.3f} s; loss {loss.item():.6f} against autograd of the "
          f"whole stack {ref_loss.item():.6f} (rel {l_rel:.3e}), gradients "
          f"rel L2 {g_rel:.3e} (tol {PARALLEL_REL_TOL}); launches "
          f"{dict(f1b)} [{card}]", flush=True)
    runs.append(f1b)
    del sp, ref, ref_g, grads, out, zz, tgt
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def phase_mmdit_ring(card, trainer, state, flash_step):
    """The MMDiT trainer at SD3's operating point (depth 24, latent 128:
    4096 + 154 tokens, batch 2, bf16 over fp32) with the ring joint
    attention over 4 shards of the card: the loss and gradient of one batch
    against the flash model's (rel L2), then ring train steps with their
    K5 / K6 / K7 launches. The model goes back to flash attention after."""
    import torch

    model = state.model
    cfg = trainer.cfg
    latents, context, y = (torch.from_numpy(a).cuda() for a in mmdit_batch(
        cfg.batch_size, cfg.img_size, cfg.context_len, trainer.model_cfg,
        seed=5))
    gen = torch.Generator(device="cuda").manual_seed(31)
    draws = dict(
        t_lin=torch.sigmoid(torch.randn(2, generator=gen, device="cuda")),
        noise=torch.randn(latents.shape, generator=gen, device="cuda"),
        drop=torch.zeros(2, dtype=torch.bool, device="cuda"))

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = trainer.loss(state, latents, context, y, **draws)
        loss.backward()
        return loss.item(), [p.grad.to(torch.bfloat16)
                             for p in model.parameters()]

    model.train()
    l_flash, g_flash = loss_and_grads()
    model.set_attention("ring", card_mesh())
    try:
        n0 = read_counts()
        l_ring, g_ring = loss_and_grads()
        one = launches_since(n0)
        num = sum(((a.float() - b.float()) ** 2).sum().item()
                  for a, b in zip(g_ring, g_flash))
        den = sum((b.float() ** 2).sum().item() for b in g_flash)
        g_rel = (num / den) ** 0.5
        l_rel = abs(l_ring - l_flash) / abs(l_flash)
        del g_ring, g_flash
        model.zero_grad(set_to_none=True)
        per_step = dict(K1=0, K2=0, K3=0, K4=0, K5=RING_K5_PER_FORWARD,
                        K6=RING_K5_PER_FORWARD, K7=RING_K5_PER_FORWARD)
        check(dict(one) == per_step, f"a ring MMDiT loss + backward "
                                     f"launched {dict(one)}, not {per_step}")
        check(g_rel <= PARALLEL_REL_TOL and l_rel <= PARALLEL_REL_TOL,
              f"ring MMDiT gradient off the flash one: loss rel {l_rel}, "
              f"gradient rel L2 {g_rel}")
        reset_counts()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = []
        for _ in range(RING_TRAIN_STEPS):
            state, loss = trainer.train_step(state, latents, context, y)
            losses.append(loss.item())
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / RING_TRAIN_STEPS
        launches = read_counts()
        want = {k_: n * RING_TRAIN_STEPS for k_, n in per_step.items()}
        check(dict(launches) == want, f"ring MMDiT steps launched "
                                      f"{dict(launches)}, not {want}")
        check(all(l_ == l_ for l_ in losses), f"ring losses {losses}")
        print(f"MMDiT ring training (depth 24, latent 128: 4096 + 154 "
              f"tokens, batch 2, bf16 over fp32; {RING_N} shards of the "
              f"card): one batch's loss {l_ring:.6f} against the flash "
              f"model's {l_flash:.6f} (rel {l_rel:.3e}), the whole gradient "
              f"rel L2 {g_rel:.3e} (tol {PARALLEL_REL_TOL}); "
              f"{RING_TRAIN_STEPS} ring steps {ms:.2f} ms/step (CUDA events; "
              f"the flash step {flash_step['step_ms']:.2f}), losses "
              f"{[round(v_, 4) for v_ in losses]}; launches "
              f"{dict(launches)}, K6 {launches.k6_routes} K7 "
              f"{launches.k7_routes} [{card}]", flush=True)
    finally:
        model.set_attention("flash")
    return state, launches


def phase_moe(card):
    """Switch-MoE MMDiTs: depth 24 (SD3-medium's width) with 4 experts in
    every x-stream block, bf16, forward at latent 128 with the experts over
    an ``expert`` axis of 4 shards of the card against no mesh; then one
    training step of a depth-24 MMDiT with 2 experts over an expert axis
    of 2 at latent 64, the balance loss in it, its memory reckoned first."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.models.mmdit import (
        DismantledBlock, MMDiT, MMDiTConfig, collect_losses)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
        MMDiTTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        flax_default_init_)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        FlowTrainConfig)

    runs = []
    cfg = MMDiTConfig(moe_experts=MOE_EXPERTS)
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = MMDiT(cfg, mesh=card_mesh(MOE_EXPERTS, "expert"))
    model = flax_default_init_(model.to_empty(device="cuda"),
                               torch.Generator("cuda").manual_seed(41))
    model = model.to(torch.bfloat16).eval()
    n_params = sum(p.numel() for p in model.parameters())
    x, context, y = (torch.from_numpy(a).cuda() for a in mmdit_batch(
        2, 128, RING_LC, cfg, seed=9))
    t = torch.tensor([300.0, 700.0], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), collect_losses(model) as sown:
        reset_counts()
        t1 = time.perf_counter()
        out_ep = model(x, t, y, context)
        torch.cuda.synchronize()
        ep_s = time.perf_counter() - t1
        fwd = read_counts()
        aux = {k_: v_.item() for k_, v_ in sown.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moe_blocks = [m for m in model.modules()
                  if isinstance(m, DismantledBlock) and m.moe_experts]
    for m in moe_blocks:
        m.moe_mesh = None
    with torch.no_grad():
        out_one = model(x, t, y, context)
    rel = rel_l2(out_ep, out_one)
    want = sd3_counts(0, 0, 0)
    want["K5"] = 4 * SD3_DEPTH
    check(dict(fwd) == want, f"MoE forward launched {dict(fwd)}, not {want}")
    check(len(aux) == SD3_DEPTH and all(a > 0 for a in aux.values())
          and bool(torch.isfinite(out_ep).all()) and rel <= 1e-2,
          f"MoE forward: {len(aux)} balance losses, rel L2 against no mesh "
          f"{rel}")
    print(f"MoE MMDiT forward (depth 24, hidden 1536, {MOE_EXPERTS} experts "
          f"in each x-stream block over an expert axis of {MOE_EXPERTS} "
          f"shards of the card; {n_params} bf16 params, set-up "
          f"{t1 - t0:.2f} s; batch 2 at 4096 + {RING_LC} tokens): "
          f"{ep_s:.3f} s, peak {peak:.2f} GiB; rel L2 against the same model "
          f"without the expert mesh {rel:.3e} (tol 1e-2); balance losses "
          f"{min(aux.values()):.4f}-{max(aux.values()):.4f} over {len(aux)} "
          f"blocks; launches {dict(fwd)} [{card}]", flush=True)
    runs.append(fwd)
    del model, out_ep, out_one, moe_blocks
    gc.collect()
    torch.cuda.empty_cache()

    mc = MMDiTConfig(moe_experts=MOE_TRAIN_EXPERTS)
    fcfg = FlowTrainConfig(img_size=64, context_len=RING_LC, batch_size=2,
                           dtype="bf16")
    with torch.device("meta"):
        n_train = sum(p.numel() for p in MMDiT(mc).parameters())
    print(f"MoE training: {n_train} fp32 parameters ({MOE_TRAIN_EXPERTS} "
          f"experts): parameters, gradients and two AdamW moments reckoned "
          f"at {16 * n_train / 2 ** 30:.1f} GiB before activations; at "
          f"{MOE_EXPERTS} experts with an EMA the same reckoning gives "
          f"{20 * n_params / 2 ** 30:.1f} GiB", flush=True)
    trainer = MMDiTTrainer(mc, fcfg, device="cuda",
                           mesh=card_mesh(MOE_TRAIN_EXPERTS, "expert"))
    state = trainer.create_state(steps_per_epoch=2)
    latents, ctx2, y2 = (torch.from_numpy(a).cuda() for a in mmdit_batch(
        2, 64, RING_LC, mc, seed=10))
    gen = torch.Generator(device="cuda").manual_seed(43)
    draws = dict(
        t_lin=torch.sigmoid(torch.randn(2, generator=gen, device="cuda")),
        noise=torch.randn(latents.shape, generator=gen, device="cuda"),
        drop=torch.zeros(2, dtype=torch.bool, device="cuda"))
    with torch.no_grad():
        with_aux = trainer.loss(state, latents, ctx2, y2, **draws).item()
        weight, trainer.cfg.moe_aux_weight = trainer.cfg.moe_aux_weight, 0.0
        without = trainer.loss(state, latents, ctx2, y2, **draws).item()
        trainer.cfg.moe_aux_weight = weight
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.perf_counter()
    losses = []
    for _ in range(2):
        state, loss = trainer.train_step(state, latents, ctx2, y2)
        losses.append(loss.item())
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t1) / 2
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = sd3_counts(0, 0, 0)
    want.update(K5=2 * 4 * SD3_DEPTH, K6=2 * 4 * SD3_DEPTH,
                K7=2 * 4 * SD3_DEPTH)
    check(dict(launches) == want, f"MoE steps launched {dict(launches)}, not "
                                  f"{want}")
    check(all(l_ == l_ for l_ in losses) and with_aux > without,
          f"MoE losses {losses}, with the balance term {with_aux} vs "
          f"without {without}")
    print(f"MoE training (depth 24, {MOE_TRAIN_EXPERTS} experts over an "
          f"expert axis of {MOE_TRAIN_EXPERTS}, latent 64: 1024 + {RING_LC} "
          f"tokens, batch 2, bf16 over fp32): 2 steps {secs:.3f} s/step "
          f"(cold), peak {peak:.2f} GiB, losses "
          f"{[round(v_, 4) for v_ in losses]}; one batch's loss with the "
          f"balance term {with_aux:.6f}, without {without:.6f} (weight "
          f"{weight}); launches {dict(launches)} [{card}]", flush=True)
    runs.append(launches)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------------------
# the tp_fsdp group: tensor parallelism and FSDP on meshes of the
# one card repeated (mesh form (a): a shard is a view of the whole tensor,
# the shards run one after the other; a time here measures the serial
# shards and the collectives' copies, not a speed-up)
# --------------------------------------------------------------------------
TP_N = 2
TP_SD1_STEPS, TP_SD3_STEPS = 4, 4
TP_TRAIN_STEPS = (1, 1)                  # warm, timed (cut from 2)
DDPM_FSDP_STEPS = (2, 3)                 # warm, timed
# each head shard runs its own attention: n launches where one ran
SD1_TP_K1 = TP_N * 10 * TP_SD1_STEPS + 1     # + the VAE's d = 512, whole
SD1_TP_K2 = 61 * TP_SD1_STEPS + 30           # GroupNorm is not split
# bf16 tolerance of a TP request against the meshless one. A row layer's
# partial products are each rounded to bf16 before their sum and the bias is
# added after it, where the one GEMM rounds once: a few more roundings per
# layer, which CFG (the guided difference x 7.5 or 5) and the sampler
# amplify as it amplifies any bf16 rounding. So the bound is set from the
# meshless request's own bf16 jitter, measured in the same call: sample 0
# of a batch-2 request (same per-sample seed) against the batch-1 request,
# where cuBLAS and cuDNN pick other algorithms. Three times that jitter, or
# PARALLEL_REL_TOL if larger; a wrong shard (a head crossed, a bias added
# twice, a missing sum) is off by O(1).


def tp_tolerance(jitter):
    return max(PARALLEL_REL_TOL, 3.0 * jitter)


# the shapes each head shard of a {"model": 2} mesh gives K1 (SD1's UNet at
# 64^2, 8 heads of 40 split in two) and K5 (SD3's joint attention, 24 heads
# of 64 split in two)
K1_TP_SHAPE = (2, 8 // TP_N, 4096, 4096, 40)
K5_TP_SHAPE = (2, 24 // TP_N, 4096, 4096, 64)


def phase_kernels_tp(card):
    """K1 and K5 at a TP head shard's shape against their plain versions,
    with the library call, the bound and the device time."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(77)
    out = {}
    for name, (b, h, lq, lk, d) in (("K1", K1_TP_SHAPE),
                                     ("K5", K5_TP_SHAPE)):
        # q, k, v: a shard's column outputs (B, L, H/n * D), one per group
        q, k, v = (torch.randn(b, n, h * d, generator=gen, device="cuda").to(
            torch.bfloat16).reshape(b, n, h, d).transpose(1, 2)
                   for n in (lq, lk, lk))
        if name == "K1":
            run = lambda: fa.flash_attention_cuda(q, k, v)
            plain = lambda: fa.flash_attention_plain(q, k, v)
            family = "K1 flash fwd"
        else:
            z = torch.zeros(b, dtype=torch.int32, device="cuda")
            run = lambda: fa.flash_attention_pos_cuda(q, k, v, z, z)
            plain = lambda: fa.flash_attention_pos_plain(q, k, v, z, z)
            family = "K5 flash fwd pos"
        (o, lse), (ref, ref_lse) = run(), plain()
        err = (o.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        del ref, ref_lse
        bound_ms, bound_by = attn_bound(b, h, lq, lk, d)
        times = dict(ms=cuda_ms(run), plain_ms=cuda_ms(plain, 5, 1),
                     library_ms=cuda_ms(
                         lambda: F.scaled_dot_product_attention(q, k, v),
                         10, 2),
                     bound_ms=bound_ms, bound_by=bound_by,
                     device_ms=kernel_device_ms(run, family))
        print(f"{name} at a TP head shard (B,H,Lq,Lk,D)={(b, h, lq, lk, d)} "
              f"bf16: max|out err|={err:.3e} (atol 2e-2) max|lse err|="
              f"{lse_err:.3e} (atol 1e-3); kernel {times['ms']:.4f} ms, "
              f"device {fmt_ms(times['device_ms'])}, plain "
              f"{times['plain_ms']:.4f} ms, library "
              f"{times['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}, {100 * bound_ms / times['ms']:.1f} % of it "
              f"reached) [{card}]", flush=True)
        check(err <= 2e-2 and lse_err <= 1e-3,
              f"{name} disagrees at the TP shard shape: {err} / {lse_err}")
        out[name] = dict(shape=[b, h, lq, lk, d], max_abs_err=err, **times)
    return out


def drop_tp(*models):
    """Back to the meshless forward: in mesh form (a) ``apply_tp`` keeps
    every tensor whole, so clearing the modules' ``tp`` undoes it."""
    for model in models:
        if model is None:
            continue
        for m in model.modules():
            if getattr(m, "tp", None) is not None:
                m.tp = None


def phase_tp_sd1(card, models):
    """SD1 at 512^2 through ``SD1Generator(mesh={"model": 2})`` (k-LMS, CFG
    7.5, ``TP_SD1_STEPS`` steps; the mesh is the card repeated) against the
    same request without a mesh: final latents and image, K1 launches 2 x
    10 a step + the VAE's whole d = 512, every one on its sm90 kernel, K2's
    count unchanged; then ``sd1 generate --tp 2 --device cuda`` on this
    one-card host raises the JAX mesh-shape error."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.cli import sd1 as sd1_cli
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SD1Generator)

    final = []
    hook = models.decoder.register_forward_pre_hook(
        lambda m, a: final.append(a[0].detach().clone()))
    kw = dict(sampler="k_lms", n_inference_steps=TP_SD1_STEPS,
              cfg_scale=7.5, height=512, width=512)
    prompt = ["a photograph of an astronaut riding a horse"]
    try:
        plain_gen = SD1Generator(models, **kw)
        plain = plain_gen(prompt, per_sample_seeds=[11])
        want = final.pop()
        plain_gen(prompt * 2, per_sample_seeds=[11, 12])
        jitter = rel_l2(final.pop()[:1], want)
        gen = SD1Generator(models, mesh=card_mesh(TP_N, "model"), **kw)
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        image = gen(prompt, per_sample_seeds=[11])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = read_counts()
        rel = rel_l2(final.pop(), want)
        lv = levels(image, plain)
        k1_routes = dict(got.k1_routes)
        tol = tp_tolerance(jitter)
        print(f"SD1 over a {{'model': {TP_N}}} mesh of the card (512^2, "
              f"{TP_SD1_STEPS} k-LMS steps, CFG 7.5): {secs:.3f} s/image "
              f"(the shards one after the other); against the meshless "
              f"request: final latents rel L2 {rel:.3e} (tol {tol:.3e}; the "
              f"meshless request's own batch-2 jitter {jitter:.3e}), image "
              f"max {lv[0]} mean {lv[1]:.4f} levels; K1 {got['K1']} by "
              f"kernel {k1_routes} by head dim {got.k1_head_dims}, K2 "
              f"{got['K2']} [{card}]", flush=True)
        check(image.shape == (1, 512, 512, 3) and rel <= tol,
              f"SD1 TP request off the meshless one: rel L2 {rel} > {tol}")
        check(got["K1"] == SD1_TP_K1 and k1_routes == {
            "sm90": SD1_TP_K1 - 1, "d512": 1},
              f"SD1 TP K1 launches {got['K1']} {k1_routes}, not "
              f"{SD1_TP_K1} (sm90 but the VAE's d = 512)")
        check(got["K2"] == SD1_TP_K2, f"SD1 TP K2 launches {got['K2']}, "
                                      f"not {SD1_TP_K2}")
        check(models.unet.enc1_att.attn1.tp is not None
              and models.decoder.mid_attn.attn.tp is None,
              "SD1Generator(mesh=) did not switch the UNet, or split the "
              "VAE's one head")
    finally:
        hook.remove()
        drop_tp(models.clip, models.unet, models.encoder, models.decoder)
    try:
        sd1_cli.main(["generate", "--prompt", "x", "--tp", str(TP_N),
                      "--device", "cuda"])
        raised = ""
    except ValueError as err:
        raised = str(err)
    print(f"sd1 generate --tp {TP_N} --device cuda on a host with "
          f"{torch.cuda.device_count()} card(s): ValueError {raised!r}",
          flush=True)
    check(raised == f"mesh shape {{'model': {TP_N}}} != "
                    f"{torch.cuda.device_count()} devices"
          or torch.cuda.device_count() >= TP_N,
          f"sd1 --tp {TP_N} on one card did not raise the mesh error")
    return got


def phase_tp_sd3(card, source):
    """SD3-medium at 1024^2 through ``SD3Inferencer(mesh={"model": 2})``
    (MMDiT, CLIP-L / G, T5 switched; the VAE's one head whole),
    ``TP_SD3_STEPS`` flow-Euler steps, CFG 5: final latents against the
    meshless request of as many steps, K5 launches 2 x its count, every one
    on sm90. Returns the launches and the meshless request (image, final
    latents, its own batch-2 jitter in rel L2 and in levels, launches) for
    ``phase_tp_sp_sd3``."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer)

    models = source["models"]
    step_events, final_latents = [], []
    hooks = request_hooks(models, step_events, final_latents)
    tokens = np.zeros((1, 77), np.int32)
    seed = source["seed"]
    kw = dict(width=1024, height=1024, steps=TP_SD3_STEPS, cfg_scale=5.0,
              per_sample_seeds=[seed])
    try:
        # the whole decode, image by image, at batch 2 too: the decoder's
        # hook sees sample 0 first
        plain_inf = SD3Inferencer(models, shift=3.0, decode_mode="whole")
        n0 = read_counts()
        plain_image = plain_inf.gen_image(tokens, **kw)
        plain = launches_since(n0)
        want_latents = final_latents.pop()
        two = plain_inf.gen_image(np.zeros((2, 77), np.int32), **dict(
            kw, per_sample_seeds=[seed, seed + 1]))
        jitter = rel_l2(final_latents[0], want_latents)
        level_jitter = levels(two[:1], plain_image)
        final_latents.clear()
        inf = SD3Inferencer(models, shift=3.0,
                            mesh=card_mesh(TP_N, "model"))
        step_events.clear()
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        image = inf.gen_image(tokens, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = read_counts()
        rel = rel_l2(final_latents.pop(), want_latents)
        lv = levels(image, plain_image)
        want = dict(plain, K5=TP_N * plain["K5"])
        tol = tp_tolerance(jitter)
        print(f"SD3 over a {{'model': {TP_N}}} mesh of the card (1024^2, "
              f"{TP_SD3_STEPS} flow-Euler steps, CFG 5): {secs:.3f} s/image, "
              f"{step_ms(step_events):.2f} ms/denoise step (the shards one "
              f"after the other); against the meshless request: final "
              f"latents rel L2 {rel:.3e} (tol {tol:.3e}; the meshless "
              f"request's own batch-2 jitter {jitter:.3e}), image max "
              f"{lv[0]} mean {lv[1]:.4f} levels; launches {dict(got)} "
              f"(meshless {plain}), K5 {got.k5_routes} [{card}]",
              flush=True)
        check(rel <= tol, f"SD3 TP latents rel L2 {rel} > {tol}")
        check(dict(got) == want and got.k5_routes == {"sm90": got["K5"]},
              f"SD3 TP launches {dict(got)} {got.k5_routes}, not {want}")
        check(models.mmdit.joint_block0.x_block.tp is not None
              and models.t5.block0.attn.tp is not None,
              "SD3Inferencer(mesh=) did not switch the MMDiT and T5")
    finally:
        for h in hooks:
            h.remove()
        drop_tp(*(getattr(models, f.name)
                  for f in dataclasses.fields(models)))
    return got, dict(image=plain_image, latents=want_latents, jitter=jitter,
                     level_jitter=level_jitter, plain=plain, kw=kw)


def phase_tp_int8(card, source):
    """W8A8 under TP on the card: for quantized copies of the MMDiT's and
    T5's block projections, a row-parallel layer's int32 accumulators
    summed over 2 shards (the per-token abs-max reduced with max first)
    equal the unsharded accumulators bit for bit, and a column-parallel
    layer's shard outputs put together equal its unsharded output."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import quantize as Q
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel import sharding

    models = source["models"]
    blk, t5 = models.mmdit.joint_block0.x_block, models.t5.block0
    layers = [("mmdit qkv", blk.qkv, 3, 2 * 4096),
              ("mmdit proj", blk.proj, 0, 2 * 4096),
              ("mmdit mlp_fc1", blk.mlp_fc1, 1, 2 * 4096),
              ("mmdit mlp_fc2", blk.mlp_fc2, 0, 2 * 4096),
              ("t5 q", t5.attn.q, 1, 2 * 77), ("t5 o", t5.attn.o, 0, 2 * 77),
              ("t5 wi_0", t5.wi_0, 1, 2 * 77), ("t5 wo", t5.wo, 0, 2 * 77)]
    comm = card_mesh(TP_N, "model").comm("model")
    gen = torch.Generator(device="cuda").manual_seed(3)
    done = []
    for name, lin, groups, rows in layers:
        q = Q.QuantLinear.from_linear(lin)
        x = torch.randn(rows, q.in_features, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        if groups == 0:      # row-parallel: the accumulators
            xq, xs = Q.quantize_rows(x.to(q.compute_dtype))
            whole = Q.int8_matmul(xq, q.q.t())
            acc, scale = sharding.row_int8_accumulators(
                q, comm.local_shards(x, 1), comm)
            ok = (acc.dtype == torch.int32 and torch.equal(acc, whole)
                  and torch.equal(scale, xs)
                  and torch.equal(sharding.row_replicated(q, x, comm),
                                  q(x)))
        else:                # column-parallel: the output, shard by shard
            outs = sharding.column(q, x, comm, groups)
            if groups > 1:
                outs = [torch.cat([o[g] for o in outs], -1)
                        for g in range(groups)]
            ok = torch.equal(torch.cat(outs, -1), q(x))
        check(ok, f"W8A8 under TP: {name} differs from the unsharded layer")
        done.append((name, rows, q.in_features, q.out_features,
                     "row" if groups == 0 else "column"))
        del q
    print(f"W8A8 under TP over {TP_N} shards of the card: int32 "
          f"accumulators (row layers) and outputs (column layers) equal to "
          f"the unsharded ones at (layer, M, K, N, kind) {done}", flush=True)


def phase_tp_training(card, trainer, state, flash_step):
    """The MMDiT trainer at SD3's operating point (depth 24, latent 128,
    batch 2, bf16 over fp32) laid out on {"data": 2, "model": 2} with FSDP
    (the card repeated): one batch's loss and whole gradient against the
    meshless model's from the same state and draws, then 1 + 2 hybrid
    steps, with K5 / K6 / K7 launches 2 x the meshless ones, all sm90, and
    the peak beside the meshless one (on one card the shards are views of
    one tensor: neither TP nor FSDP saves memory here). The state goes back
    to its meshless layout after."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        StateLayout, lay_out)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
        MMDiTTrainer)

    model = state.model
    mesh = build_mesh({"data": 2, "model": TP_N},
                      [torch.device("cuda")] * (2 * TP_N))
    hybrid = MMDiTTrainer(trainer.model_cfg, trainer.cfg, device="cuda",
                          mesh=mesh, fsdp=True)
    cfg = trainer.cfg
    latents, context, y = (torch.from_numpy(a).cuda() for a in mmdit_batch(
        cfg.batch_size, cfg.img_size, cfg.context_len, trainer.model_cfg,
        seed=7))
    gen = torch.Generator(device="cuda").manual_seed(41)
    draws = dict(
        t_lin=torch.sigmoid(torch.randn(2, generator=gen, device="cuda")),
        noise=torch.randn(latents.shape, generator=gen, device="cuda"),
        drop=torch.zeros(2, dtype=torch.bool, device="cuda"))

    def loss_and_grads(tr):
        model.zero_grad(set_to_none=True)
        loss = tr.loss(state, latents, context, y, **draws)
        loss.backward()
        return loss.item(), [p.grad.to(torch.bfloat16)
                             for p in model.parameters()]

    model.train()
    n0 = read_counts()
    l_plain, g_plain = loss_and_grads(trainer)
    plain_one = launches_since(n0)
    state.layout = lay_out(model, mesh, True)
    try:
        sharded = sum(d is not None for d in state.layout.fsdp_dims.values())
        n0 = read_counts()
        l_tp, g_tp = loss_and_grads(hybrid)
        one = launches_since(n0)
        num = sum(((a.float() - b.float()) ** 2).sum().item()
                  for a, b in zip(g_tp, g_plain))
        den = sum((b.float() ** 2).sum().item() for b in g_plain)
        g_rel = (num / den) ** 0.5
        l_rel = abs(l_tp - l_plain) / abs(l_plain)
        del g_tp, g_plain
        model.zero_grad(set_to_none=True)
        per_step = dict(MMDIT_PER_STEP, **{k: TP_N * plain_one[k]
                                           for k in ("K5", "K6", "K7")})
        check(dict(one) == per_step and plain_one["K6"] > 0,
              f"a TP MMDiT loss + backward launched {dict(one)}, not "
              f"{per_step} (meshless {plain_one})")
        check(g_rel <= PARALLEL_REL_TOL and l_rel <= PARALLEL_REL_TOL,
              f"hybrid MMDiT gradient off the meshless one: loss rel "
              f"{l_rel}, gradient rel L2 {g_rel}")
        warm, timed = TP_TRAIN_STEPS
        for _ in range(warm):
            state, _ = hybrid.train_step(state, latents, context, y)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = []
        for _ in range(timed):
            state, loss = hybrid.train_step(state, latents, context, y)
            losses.append(loss.item())
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / timed
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = read_counts()
        want = {k: n * timed for k, n in per_step.items()}
        check(dict(launches) == want, f"hybrid MMDiT steps launched "
                                      f"{dict(launches)}, not {want}")
        for k in ("K5", "K6", "K7"):
            r = getattr(launches, k.lower() + "_routes")
            check(r == {"sm90": launches[k]}, f"hybrid MMDiT {k} routes {r}")
        check(all(v == v for v in losses), f"hybrid losses {losses}")
        print(f"MMDiT training on {{'data': 2, 'model': {TP_N}}} with FSDP "
              f"(the card repeated; depth 24, latent 128: 4096 + 154 tokens, "
              f"batch 2, bf16 over fp32; {sharded} parameters stored by "
              f"data shards): one batch's loss {l_tp:.6f} against the "
              f"meshless {l_plain:.6f} (rel {l_rel:.3e}), the whole gradient "
              f"rel L2 {g_rel:.3e} (tol {PARALLEL_REL_TOL}); {timed} hybrid "
              f"steps after {warm}: {ms:.2f} ms/step (CUDA events; the "
              f"meshless step {flash_step['step_ms']:.2f}; the shards one "
              f"after the other), losses {[round(v, 4) for v in losses]}; "
              f"peak {peak:.2f} GiB against the meshless step's "
              f"{flash_step['peak_gib']:.2f} (one card: the shards are views "
              f"of one tensor, no memory saved); launches {dict(launches)} "
              f"[{card}]", flush=True)
    finally:
        drop_tp(model)
        state.layout = StateLayout()
    return state, launches


# --------------------------------------------------------------------------
# TP composed with ring / Ulysses attention on one {"data": 1, "seq": 2,
# "model": 2} mesh of the card repeated: each of the two head shards runs
# its own ring over seq. SD3's joint sequence of 154 + 4096 = 4250 tokens
# splits into two seq shards of 2125 with no padding, so a ring hop is K5 /
# K6 / K7 at (2, 12, 2125, 2125, 64), and a block launches 2 shards x 2^2
# hops of each: 192 of each a forward (backward) of the depth-24 MMDiT.
# --------------------------------------------------------------------------
TP_SP_SEQ = 2
TP_SP_SHAPE = {"data": 1, "seq": TP_SP_SEQ, "model": TP_N}
TP_SP_LEN = (RING_LC + 4096) // TP_SP_SEQ
TP_SP_HOP = (2, 24 // TP_N, TP_SP_LEN, TP_SP_LEN, 64)
TP_SP_PER_FORWARD = SD3_DEPTH * TP_N * TP_SP_SEQ ** 2
TP_SP_TRAIN_STEPS = (1, 2)               # warm, timed
# Ulysses runs plain attention (as the JAX package does): its saved fp32
# logits and probabilities at 4250 tokens would need ~200 GB for 24 blocks
# of 2 x 2 shards on one card, so its step runs at latent 64 (1024 + 154
# tokens), the width whole
TP_SP_ULYSSES_LATENT = 64


def phase_kernels_tp_sp(card):
    """K5 / K6 / K7 at the TP x SP ring hop (2, 12, 2125, 2125, 64): seq
    shard 0's queries of one head shard against seq shard 1's keys, at
    offsets (0, 0) / (2125, 0) under valid_len 4250, against their plain
    versions, timed with the library call and the bound."""
    import torch

    b, h, n_l, _, d = TP_SP_HOP
    gen = torch.Generator(device="cuda").manual_seed(53)
    rnd = lambda n: torch.randn(b, h, n, d, generator=gen,
                                device="cuda").to(torch.bfloat16)
    qs, ks, vs, gs = rnd(n_l), rnd(n_l), rnd(n_l), rnd(n_l)
    hop, errs = hop_kernels(card, "the TP x SP ring hop", qs, ks, vs, gs,
                            (0, 0), (n_l, 0), 2 * n_l,
                            dict(launches_per_step=TP_SP_PER_FORWARD))
    print(f"TP x SP ring hop errors: {errs}", flush=True)
    return hop


def phase_tp_sp_training(card, trainer, state, flash_step):
    """The MMDiT trainer at SD3's operating point (depth 24, latent 128,
    batch 2, bf16 over fp32) with ring attention on TP_SP_SHAPE, the card
    repeated: each head shard's ring over seq. One batch's loss and whole
    gradient through the composed model against the meshless one, from
    the same state and draws, within 3 x a jitter measured here on the same
    batch: the larger of the meshless gradient's own batch-2 jitter (the
    two examples' batch-1 gradients averaged against the batch-2 one) and
    TP alone's deviation ({"model": 2}, flash). The batch jitter alone
    cannot bound a sharded gradient: the forward is bit-identical across
    batch sizes (its loss jitter is 0), so it moves only the weight
    gradients' sums over the batch, while Megatron's row layers round each
    shard's partial product to bf16 before the sum, in every block (rel L2
    of the whole gradient, each side in bf16; the loss held to the same
    bound). Then 1 + 2 composed steps (K5 / K6 / K7 192 each a step, all
    sm90) with ms/step and peak, and one more under the profiler for the
    device's busy time, beside the meshless step; then one Ulysses step on
    the same mesh at latent 64 (plain attention: no flash launch). The
    model goes back to flash and its meshless layout after."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        StateLayout, lay_out)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.mmdit_trainer import (
        MMDiTTrainer)

    model = state.model
    cfg = trainer.cfg
    mesh = build_mesh(TP_SP_SHAPE, [torch.device("cuda")] * (TP_SP_SEQ * TP_N))
    composed = MMDiTTrainer(dataclasses.replace(
        trainer.model_cfg, attention_impl="ring"), cfg, device="cuda",
        mesh=mesh)
    batch = [torch.from_numpy(a).cuda() for a in mmdit_batch(
        cfg.batch_size, cfg.img_size, cfg.context_len, trainer.model_cfg,
        seed=9)]
    gen = torch.Generator(device="cuda").manual_seed(43)
    draws = dict(
        t_lin=torch.sigmoid(torch.randn(2, generator=gen, device="cuda")),
        noise=torch.randn(batch[0].shape, generator=gen, device="cuda"),
        drop=torch.zeros(2, dtype=torch.bool, device="cuda"))

    def backward(tr, rows=slice(None), weight=1.0):
        """The loss of the batch's ``rows``; its gradient, times
        ``weight``, added to the parameters' ``.grad``."""
        loss = tr.loss(state, *(a[rows] for a in batch),
                       **{k: v[rows] for k, v in draws.items()})
        (loss * weight).backward()
        return loss.item()

    def grads():
        return [p.grad.to(torch.bfloat16) for p in model.parameters()]

    def rel(got, want):
        num = sum(((a.float() - b.float()) ** 2).sum().item()
                  for a, b in zip(got, want))
        return (num / sum((b.float() ** 2).sum().item()
                          for b in want)) ** 0.5

    model.train()
    model.zero_grad(set_to_none=True)
    n0 = read_counts()
    l_plain = backward(trainer)
    plain_one = launches_since(n0)
    g_plain = grads()
    model.zero_grad(set_to_none=True)
    l_split = sum(backward(trainer, slice(i, i + 1), 0.5) / 2
                  for i in range(2))
    g_jitter = rel(grads(), g_plain)
    l_jitter = abs(l_split - l_plain) / abs(l_plain)
    state.layout = lay_out(model, card_mesh(TP_N, "model"), False)
    try:
        model.zero_grad(set_to_none=True)
        l_tp_alone = backward(trainer)
        g_tp_alone = rel(grads(), g_plain)
    finally:
        drop_tp(model)
        state.layout = StateLayout()
    yardstick = max(g_jitter, g_tp_alone)
    model.set_attention("ring", mesh)
    state.layout = lay_out(model, mesh, False)
    try:
        model.zero_grad(set_to_none=True)
        n0 = read_counts()
        l_tp = backward(composed)
        one = launches_since(n0)
        g_rel, l_rel = rel(grads(), g_plain), abs(l_tp - l_plain) / abs(
            l_plain)
        del g_plain
        model.zero_grad(set_to_none=True)
        per_step = dict(MMDIT_PER_STEP, K5=TP_SP_PER_FORWARD,
                        K6=TP_SP_PER_FORWARD, K7=TP_SP_PER_FORWARD)
        check(dict(one) == per_step and plain_one["K5"] > 0,
              f"a TP x SP MMDiT loss + backward launched {dict(one)}, not "
              f"{per_step} (meshless {plain_one})")
        check(g_rel <= 3 * yardstick and l_rel <= 3 * yardstick,
              f"TP x SP MMDiT off the meshless one: gradient rel L2 {g_rel}, "
              f"loss rel {l_rel} (3 x jitter {3 * yardstick})")
        warm, timed = TP_SP_TRAIN_STEPS
        for _ in range(warm):
            state, _ = composed.train_step(state, *batch)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses = []
        for _ in range(timed):
            state, loss = composed.train_step(state, *batch)
            losses.append(loss.item())
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / timed
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = read_counts()
        want = {k: n * timed for k, n in per_step.items()}
        check(dict(launches) == want, f"TP x SP MMDiT steps launched "
                                      f"{dict(launches)}, not {want}")
        for k in ("K5", "K6", "K7"):
            r = getattr(launches, k.lower() + "_routes")
            check(r == {"sm90": launches[k]}, f"TP x SP MMDiT {k} routes "
                                              f"{r}")
        check(all(v == v for v in losses), f"TP x SP losses {losses}")
        (state, _), _, fams, _, _ = profile_device(
            lambda: composed.train_step(state, *batch), cpu=False)
        busy = sum(fams.values())
        print(f"MMDiT training on {TP_SP_SHAPE} with ring attention (the "
              f"card repeated; depth 24, latent 128: 4096 + 154 tokens, "
              f"batch 2, bf16 over fp32): one batch's loss {l_tp:.6f} "
              f"against the meshless {l_plain:.6f} (rel {l_rel:.3e}), the "
              f"whole gradient rel L2 {g_rel:.3e}, each within 3 x "
              f"{yardstick:.3e}: the larger of the meshless batch-2 jitter "
              f"(gradient {g_jitter:.3e}, loss {l_jitter:.3e}) and TP "
              f"alone's deviation (gradient {g_tp_alone:.3e}, loss "
              f"{abs(l_tp_alone - l_plain) / abs(l_plain):.3e}); {timed} "
              f"steps after {warm}: {ms:.2f} "
              f"ms/step (CUDA events), device busy {busy:.2f} ms (one "
              f"profiled step; K5 {fmt_ms(fams.get('K5 flash fwd pos'))}, "
              f"K6 {fmt_ms(fams.get('K6 flash bwd pos dq'))}, K7 "
              f"{fmt_ms(fams.get('K7 flash bwd pos dk/dv'))}), peak "
              f"{peak:.2f} GiB; the meshless step {flash_step['step_ms']:.2f}"
              f" ms, busy {flash_step['busy_ms']:.2f} ms, peak "
              f"{flash_step['peak_gib']:.2f} GiB (the shards one after the "
              f"other on one card); losses {[round(v, 4) for v in losses]}; "
              f"launches {dict(launches)} [{card}]", flush=True)
        print("TP x SP MMDiT step profile:", flush=True)
        print_profile(fams, [], 1, "step")
        # one Ulysses step: 12 heads a shard over seq 2, plain attention
        model.set_attention("ulysses", mesh)
        small = [torch.from_numpy(a).cuda() for a in mmdit_batch(
            cfg.batch_size, TP_SP_ULYSSES_LATENT, cfg.context_len,
            trainer.model_cfg, seed=11)]
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, u_loss = composed.train_step(state, *small)
        torch.cuda.synchronize()
        u_s = time.perf_counter() - t
        ulysses = read_counts()
        check(dict(ulysses) == NO_LAUNCHES and bool(u_loss.isfinite()),
              f"TP x SP Ulysses step: launches {dict(ulysses)}, loss "
              f"{u_loss}")
        print(f"MMDiT Ulysses training step on {TP_SP_SHAPE} (latent "
              f"{TP_SP_ULYSSES_LATENT}: 1024 + 154 tokens, batch 2, the "
              f"width whole): {u_s:.3f} s, loss {u_loss.item():.4f}, "
              f"launches {dict(ulysses)} (plain attention) [{card}]",
              flush=True)
    finally:
        drop_tp(model)
        model.set_attention("flash")
        state.layout = StateLayout()
    return state, launches, ulysses


def phase_tp_sp_sd3(card, source, ref):
    """SD3-medium at 1024^2 through ``SD3Inferencer(mesh=)`` over a ring
    MMDiT on one {"seq": 2, "model": 2} mesh of the card repeated (each head
    shard's ring over seq), the request of ``phase_tp_sd3`` (TP_SD3_STEPS
    steps, CFG 5, its seed): the image against the meshless one within 3 x
    that request's own batch-2 levels (max and mean), the final latents
    within 3 x their batch-2 jitter; K5 192 a step, all sm90."""
    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.parallel import build_mesh
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd3 import (
        SD3Inferencer)

    models = source["models"]
    step_events, final_latents = [], []
    hooks = request_hooks(models, step_events, final_latents)
    mesh = build_mesh({"seq": TP_SP_SEQ, "model": TP_N},
                      [torch.device("cuda")] * (TP_SP_SEQ * TP_N))
    try:
        models.mmdit.set_attention("ring", mesh)
        inf = SD3Inferencer(models, shift=3.0, mesh=mesh)
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        image = inf.gen_image(np.zeros((1, 77), np.int32), **ref["kw"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = read_counts()
        rel = rel_l2(final_latents.pop(), ref["latents"])
        lv, jl = levels(image, ref["image"]), ref["level_jitter"]
        want = dict(ref["plain"], K5=TP_SP_PER_FORWARD * TP_SD3_STEPS)
        print(f"SD3 over one {{'seq': {TP_SP_SEQ}, 'model': {TP_N}}} mesh of "
              f"the card, ring MMDiT (1024^2, {TP_SD3_STEPS} flow-Euler "
              f"steps, "
              f"CFG 5): {secs:.3f} s/image, {step_ms(step_events):.2f} "
              f"ms/denoise step (the shards one after the other); against "
              f"the meshless request: image max {lv[0]} mean {lv[1]:.4f} "
              f"levels (3 x its own batch-2 levels: {3 * jl[0]} / "
              f"{3 * jl[1]:.4f}), final latents rel L2 {rel:.3e} (3 x their "
              f"jitter {3 * ref['jitter']:.3e}); launches {dict(got)}, K5 "
              f"{got.k5_routes} [{card}]", flush=True)
        check(image.shape == (1, 1024, 1024, 3)
              and lv[0] <= 3 * jl[0] and lv[1] <= 3 * jl[1]
              and rel <= 3 * ref["jitter"],
              f"SD3 TP x SP request off the meshless one: levels {lv} "
              f"(3 x {jl}), latents rel L2 {rel} (3 x {ref['jitter']})")
        check(dict(got) == want and got.k5_routes == {"sm90": got["K5"]},
              f"SD3 TP x SP launches {dict(got)} {got.k5_routes}, not "
              f"{want}")
        check(models.mmdit.joint_block0.x_block.tp is not None
              and models.mmdit.joint_block0.mesh is mesh,
              "SD3Inferencer(mesh=) did not switch the ring MMDiT")
    finally:
        for h in hooks:
            h.remove()
        drop_tp(*(getattr(models, f.name)
                  for f in dataclasses.fields(models)))
        models.mmdit.set_attention("flash")
    return got


def phase_ddpm_fsdp(card):
    """``DDPMTrainer(TinySDConfig(), mesh={"data": 2}, fsdp=True)`` on the
    card repeated against the plain trainer: 2 + 3 steps each from the same
    seed, batches, draws and dropout masks: losses (within 1e-5: the
    embedding's backward sums by atomics), K3 / K4 on sm90, ms/step."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        DDPMTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        TinySDConfig)

    cfg = TinySDConfig()
    warm, timed = DDPM_FSDP_STEPS
    batches = tiny_sd_batches(cfg, warm + timed, seed=17)
    gen = torch.Generator(device="cuda").manual_seed(23)
    shape = (cfg.batch_size, cfg.img_size, cfg.img_size, cfg.img_channel)
    draws = [dict(drop=torch.rand(cfg.batch_size, generator=gen,
                                  device="cuda") < cfg.train_rand,
                  t=torch.randint(0, cfg.T, (cfg.batch_size,), generator=gen,
                                  device="cuda"),
                  noise=torch.randn(shape, generator=gen, device="cuda"))
             for _ in batches]
    out = {}
    for what, kw in (("plain", {}), ("fsdp", dict(
            mesh=card_mesh(2, "data"), fsdp=True))):
        trainer = DDPMTrainer(cfg, device="cuda", **kw)
        state = trainer.create_state(len(batches))
        torch.manual_seed(29)   # the dropout masks: the global generator's
        losses = []
        for (x, labels), d in list(zip(batches, draws))[:warm]:
            state, loss = trainer.train_step(state, x, labels, **d)
            losses.append(loss.item())
        reset_counts()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for (x, labels), d in list(zip(batches, draws))[warm:]:
            state, loss = trainer.train_step(state, x, labels, **d)
            losses.append(loss.item())
        end.record()
        torch.cuda.synchronize()
        out[what] = dict(losses=losses, launches=read_counts(),
                         ms=start.elapsed_time(end) / timed,
                         sharded=sum(d is not None for d in
                                     state.layout.fsdp_dims.values()),
                         n=len(state.layout.fsdp_dims))
        del trainer, state
    f, p = out["fsdp"], out["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(f["losses"], p["losses"]))
    want = {k: n * timed for k, n in TRAIN_PER_STEP.items()}
    print(f"tiny-SD training, TinySDConfig() (64^2, batch 32, bf16 over "
          f"fp32), with FSDP on {{'data': 2}} (the card repeated; "
          f"{f['sharded']} of {f['n']} parameters stored by data shards, "
          f"views of one tensor here) against the plain trainer, "
          f"{warm} + {timed} steps from the same state and draws: losses "
          f"{[round(v, 5) for v in f['losses']]} against "
          f"{[round(v, 5) for v in p['losses']]} (largest rel {rel:.3e}); "
          f"{f['ms']:.2f} ms/step against {p['ms']:.2f}; launches "
          f"{dict(f['launches'])}, K3 {f['launches'].k3_routes} K4 "
          f"{f['launches'].k4_routes} [{card}]", flush=True)
    check(rel <= 1e-5, f"FSDP tiny-SD losses off the plain trainer's: {rel}")
    check(f["sharded"] > 0, "FSDP stored no parameter by shards")
    check(dict(f["launches"]) == want, f"FSDP tiny-SD launches "
                                       f"{dict(f['launches'])}, not {want}")
    return f["launches"]


# The SD1 trajectory loop (pipelines/sd1.py::Trajectory): a request's first
# use of a (batch, start_step) key runs one eager step (its warm-up) and
# captures the rest of the loop into a CUDA graph; the VAE decoder runs
# outside the graph. So a cold 512^2 / 50-step request launches K1 10 + 500
# + 1 and K2 61 + 3050 + 30 times, of which 500 and 3050 inside the graph,
# and a warm one only the decoder's 1 and 30 (the replay calls no wrapper).
# cut from 50 to 20 to pay for the forms phase, to 10 for the wide
# position-kernel phase
TRAJ_STEPS = 10
TRAJ_STRENGTH = 0.6
TRAJ_GRAPH = dict(K1=10 * TRAJ_STEPS, K2=61 * TRAJ_STEPS)
TRAJ_COLD = dict(K1=10 + 10 * TRAJ_STEPS + 1, K2=61 + 61 * TRAJ_STEPS + 30,
                 K3=0, K4=0, K5=0, K6=0, K7=0)


def phase_trajectory(card, models, image):
    """``SD1Generator(loop="trajectory")`` on the resident bf16 bundle at
    512^2, TRAJ_STEPS k-LMS steps, CFG 7.5, against ``loop="steps"`` on the
    same draws: captures at batch 1 and 4 (K1 / K2 launches inside each graph
    counted), a second seed through the batch-1 graph, img2img at strength
    0.6 (a second key), ``k_euler_ancestral`` (step noise staged from the
    generator in the step loop's order) and TP over {"model": 2} of the card
    repeated (``TP_SD1_STEPS`` steps); each replay's final latents bit-equal
    to the eager loop's or its image within 1 level. Then, per loop: ms per
    denoise step at batch 1 and 4 (CUDA events around the loop alone, from
    the same latents and context) and s/image at batch 1 (host clock);
    then, with every graph freed, an eager
    request again, bit for bit the first one (K2's scratch of the eager
    stream untouched by the captures). Returns the counts of the cold
    batch-1 trajectory request."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import groupnorm as gn
    from from_ddpm_to_stable_diffusion_tpu_torch.ops.image import to_uint8
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        SD1Generator, Trajectory)

    kw = dict(n_inference_steps=TRAJ_STEPS, cfg_scale=7.5, height=512,
              width=512)
    prompts = ["a photograph of an astronaut riding a horse",
               "a watercolor fox in the snow", "a lighthouse at dusk",
               "a bowl of ramen, studio lighting"]
    in_graph = []     # ((batch, start_step), launches inside), by capture
    capture = Trajectory._capture

    def counted_capture(self, stream):
        n0 = read_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        capture(self, stream)
        torch.cuda.synchronize()
        key = (self.latents.shape[0], self.start)
        inside = launches_since(n0)
        in_graph.append((key, inside))
        print(f"trajectory {key}: captured {len(self.steps)} steps in "
              f"{time.perf_counter() - t:.3f} s, launches inside the graph "
              f"K1 {inside['K1']} K2 {inside['K2']}", flush=True)

    def latents(gen, batch, **call):
        return gen._run(batch, None, call.get("seed"),
                        call.get("input_images"), call.get("strength", 0.8),
                        None, None, None, None, True)

    @torch.inference_mode()
    def decode(z):
        return to_uint8(models.decoder(z)).cpu().numpy()

    def against(what, traj, eager):
        z, z_ref = latents(traj[0], traj[1], **traj[2]), latents(
            eager[0], eager[1], **eager[2])
        same = torch.equal(z, z_ref)
        lv = levels(decode(z), decode(z_ref))
        print(f"trajectory {what}: final latents bit-equal to the step "
              f"loop's: {same} (rel L2 {rel_l2(z, z_ref):.3e}), image max "
              f"{lv[0]} mean {lv[1]:.4f} levels [{card}]", flush=True)
        check(bool(torch.isfinite(z).all()) and (same or lv[0] <= 1),
              f"trajectory {what}: the replay is off the step loop: "
              f"{lv[0]} levels")
        return z_ref

    Trajectory._capture = counted_capture
    scratch0 = dict(gn._scratch)
    try:
        steps = SD1Generator(models, sampler="k_lms", **kw)
        traj = SD1Generator(models, sampler="k_lms", loop="trajectory", **kw)
        reset_counts()
        traj(prompts[:1], seed=1)         # a cold request, decoded
        launches = read_counts()
        k1_routes = dict(launches.k1_routes)
        print(f"trajectory cold request bs=1: K1 {launches['K1']} by kernel "
              f"{k1_routes}, K2 {launches['K2']} [{card}]", flush=True)
        check(all(launches[k] == n for k, n in TRAJ_COLD.items())
              and k1_routes == {"sm90": TRAJ_COLD["K1"] - 1, "d512": 1},
              f"trajectory cold request launches {dict(launches)} "
              f"{k1_routes}, not {TRAJ_COLD} (the VAE's d = 512 aside, all "
              f"sm90)")
        first = against("bs=1 seed 1 (the capture's request)",
                        (traj, prompts[:1], dict(seed=1)),
                        (steps, prompts[:1], dict(seed=1)))
        against("bs=4 seed 3", (traj, prompts, dict(seed=3)),
                (steps, prompts, dict(seed=3)))
        against("bs=1 seed 2 (the bs=1 graph again)",
                (traj, prompts[:1], dict(seed=2)),
                (steps, prompts[:1], dict(seed=2)))
        img = dict(seed=4, input_images=[image[0]], strength=TRAJ_STRENGTH)
        against(f"img2img strength {TRAJ_STRENGTH}", (traj, prompts[:1], img),
                (steps, prompts[:1], img))
        anc = [SD1Generator(models, sampler="k_euler_ancestral",
                            loop=loop, **kw) for loop in ("trajectory",
                                                           "steps")]
        against("k_euler_ancestral bs=1 seed 5",
                (anc[0], prompts[:1], dict(seed=5)),
                (anc[1], prompts[:1], dict(seed=5)))
        del anc
        tp_kw = dict(kw, n_inference_steps=TP_SD1_STEPS)
        tp = [SD1Generator(models, sampler="k_lms", loop=loop,
                           mesh=card_mesh(TP_N, "model"), **tp_kw)
              for loop in ("trajectory", "steps")]
        try:
            against(f"TP {{'model': {TP_N}}} ({TP_SD1_STEPS} steps)",
                    (tp[0], prompts[:1], dict(seed=6)),
                    (tp[1], prompts[:1], dict(seed=6)))
        finally:
            drop_tp(models.clip, models.unet, models.encoder, models.decoder)
        del tp
        # the captures in order: k-LMS bs=1, bs=4, img2img, the ancestral
        # bs=1, TP bs=1 (each head shard's attention apart, GroupNorm whole)
        start = TRAJ_STEPS - int(TRAJ_STEPS * TRAJ_STRENGTH)
        want = [((1, 0), TRAJ_GRAPH), ((4, 0), TRAJ_GRAPH),
                ((1, start), dict(K1=10 * (TRAJ_STEPS - start),
                                  K2=61 * (TRAJ_STEPS - start))),
                ((1, 0), TRAJ_GRAPH),
                ((1, 0), dict(K1=TP_N * 10 * TP_SD1_STEPS,
                              K2=61 * TP_SD1_STEPS))]
        got = [(key, dict(K1=n["K1"], K2=n["K2"])) for key, n in in_graph]
        check(got == want, f"the graphs' keys and launches inside {got}, "
                           f"not {want}")
        # both loops by batch: ms per denoise step (CUDA events around the
        # loop alone) at batch 1 and 4, s/image (host clock) at batch 1; the
        # profiled requests and the batch-4 requests are not repeated here
        # (the script's time limit: their numbers stand in PERF.md)
        for b in (1, 4):
            batch = prompts[:b]
            with torch.inference_mode():
                context = steps._encode_text(batch, None)
                noise = steps.initial_noise(b, 9) * steps.tables[
                    "initial_scale"]
            for name, gen in (("steps", steps), ("trajectory", traj)):
                # both warm: the step loop from the requests above, the
                # graph of this batch captured
                request = "not measured"
                if b == 1:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    gen(batch, seed=9)
                    torch.cuda.synchronize()
                    request = f"{time.perf_counter() - t:.3f} s"
                start_ev = torch.cuda.Event(enable_timing=True)
                end_ev = torch.cuda.Event(enable_timing=True)
                with torch.inference_mode():
                    start_ev.record()
                    gen._sample(noise, context)
                    end_ev.record()
                end_ev.synchronize()
                step_ms = start_ev.elapsed_time(end_ev) / TRAJ_STEPS
                print(f"SD1 loop={name} bs={b}: {request} a request, "
                      f"{step_ms:.2f} ms/denoise step (the loop alone, CUDA "
                      f"events) [{card}]", flush=True)
        del traj
        gc.collect()
        torch.cuda.empty_cache()
        again = latents(steps, prompts[:1], seed=1)
        print(f"after the graphs were freed: an eager request bit-equal to "
              f"the first: {torch.equal(again, first)}; K2 scratch buffers "
              f"{len(scratch0)} -> {len(gn._scratch)} (the captures' "
              f"streams' warm-up steps add theirs) [{card}]", flush=True)
        check(torch.equal(again, first) or levels(
            decode(again), decode(first))[0] <= 1,
              "an eager request after the graphs were freed differs")
        check(all(gn._scratch.get(key) is buf
                  for key, buf in scratch0.items()),
              "a capture replaced a K2 scratch buffer of an eager stream")
    finally:
        Trajectory._capture = capture
    return launches


def phase_dp(card):
    """One step of each of the VAE, ViT, CLIP and VLM trainers over
    {"data": 2} of the card repeated (mesh form (a), the identity) against
    the meshless step from the same state on the same batch and draws: the
    VanillaVAE at 512^2 (batch 8, bf16), the ViT at ``ViTTrainConfig()``
    (128^2, batch 256, dropout 0.1 from one seed), CLIP ViT-L/14@336
    (batch 32, bf16; K1 / K3 / K4 24 each) and the TinyVLM at SigLIP-base
    width and depth (384^2, batch 16, bf16; K1 / K3 / K4 24 each). The loss
    within rtol 1e-5 and at most 1 in 10^3 parameters more than 1e-5 apart
    (a non-deterministic backward can flip the sign of a gradient that is
    rounding noise, which AdamW's first update turns into +-lr). Returns the
    counts of the mesh steps."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io.shapes_dataset import (
        CaptionedShapesDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.models.clip import CLIP
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.clip_trainer import (
        CLIPTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vae_trainer import (
        VAETrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.vit_trainer import (
        ViTTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        VAETrainConfig, ViTTrainConfig)

    gen = torch.Generator(device="cuda").manual_seed(91)
    with torch.device("meta"):
        clip_template = CLIP(image_resolution=336, dtype=torch.bfloat16)
    vlm_data = CaptionedShapesDataset(16, img_size=384, seed=3)
    vlm_images, vlm_tokens = (torch.from_numpy(a).cuda()
                              for a in vlm_batch(vlm_data, 0, 16))
    cases = {
        "vae": (lambda mesh: VAETrainer(VAETrainConfig(
            model="vanilla", img_size=512, batch_size=8, dtype="bf16"),
            mesh=mesh), lambda t: t.create_state(),
                (torch.rand((8, 512, 512, 3), generator=gen, device="cuda")
                 * 2 - 1,)),
        "vit": (lambda mesh: ViTTrainer(ViTTrainConfig(dtype="bf16"),
                                        mesh=mesh),
                lambda t: t.create_state(),
                (torch.rand((256, 128, 128, 3), generator=gen,
                            device="cuda") * 2 - 1,
                 torch.randint(0, 3, (256,), generator=gen, device="cuda"))),
        "clip": (lambda mesh: CLIPTrainer(clip_template, mesh=mesh),
                 lambda t: t.create_state((336, 336, 3), 77),
                 clip_pairs(CLIP_BATCH, 336, 92)),
        "vlm": (lambda mesh: vlm_trainer("cuda", "bf16", VLM_LAYERS,
                                         warmup_steps=0, total_steps=10,
                                         mesh=mesh),
                lambda t: t.create_state(384), (vlm_images, vlm_tokens)),
    }

    def step(make, create, batch, mesh):
        torch.manual_seed(0)          # the ViT's dropout
        trainer = make(mesh)
        state = create(trainer)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, loss = trainer.train_step(state, *batch)[:2]
        loss = loss["loss"] if isinstance(loss, dict) else loss
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        params = {n: p.detach().clone()
                  for n, p in state.params.items()}
        return float(loss), params, secs

    plain = {name: step(*case, None) for name, case in cases.items()}
    mesh = card_mesh(2, "data")
    reset_counts()
    meshed = {name: step(*case, mesh) for name, case in cases.items()}
    launches = read_counts()
    for name in cases:
        (loss, params, secs), (want_loss, want, want_secs) = (
            meshed[name], plain[name])
        off = total = 0
        max_diff = 0.0
        for n, w in want.items():
            d = (params[n].float() - w.float()).abs()
            off += int((d > 1e-5 + 1e-5 * w.float().abs()).sum())
            total += d.numel()
            max_diff = max(max_diff, float(d.max()))
        print(f"dp {name} over {{'data': 2}} of the card against no mesh: "
              f"loss {loss:.6f} vs {want_loss:.6f}, parameters max|diff| "
              f"{max_diff:.3e}, {off} of {total} more than 1e-5 apart; step "
              f"{1e3 * secs:.1f} ms vs {1e3 * want_secs:.1f} ms (first step "
              f"of each) [{card}]", flush=True)
        check(abs(loss - want_loss) <= 1e-5 * abs(want_loss)
              and off <= 1e-3 * total,
              f"dp {name}: the mesh step is off the meshless one")
    print(f"dp mesh steps' launches: K1 {launches['K1']} {launches.k1_routes}"
          f", K3 {launches['K3']} {launches.k3_routes}, K4 {launches['K4']} "
          f"{launches.k4_routes} [{card}]", flush=True)
    check(launches["K1"] == launches["K3"] == launches["K4"] == 48
          and launches.k3_routes == {"sm90": 48}
          and launches.k4_routes == {"sm90": 48},
          f"dp: CLIP's and the VLM's K1 / K3 / K4 launches {dict(launches)}")
    return launches


def phase_native(card):
    """``io/native.py`` on the card's host: the C++ tokenizer and
    safetensors reader built with g++ into the package's ``_build/`` (not
    ``native/``), the tokenizer's ids against ``io/tokenizer.py`` on a
    synthetic vocabulary, and ``load_safetensors_dict`` of a 268 MB file
    from the port's writer (every dtype, 8 bf16 (4096, 4096) tensors) read
    through the native reader, which it must take (its opens counted), bit
    for bit against the Python reader, both timed on a warm file; a write
    to a view stays private."""
    import json as json_mod
    import os
    import shutil
    import tempfile

    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.io import native
    from from_ddpm_to_stable_diffusion_tpu_torch.io import weights as tw
    from from_ddpm_to_stable_diffusion_tpu_torch.io.tokenizer import (
        CLIPTokenizer, build_simple_vocab)
    from from_ddpm_to_stable_diffusion_tpu_torch.ops._build import BUILD_DIR

    t = time.perf_counter()
    libs = [native.build_native(n) for n in ("bpe_tokenizer",
                                              "safetensors_reader")]
    print(f"native: built {[os.path.basename(p) for p in libs]} with g++ "
          f"in {time.perf_counter() - t:.2f} s", flush=True)
    check(all(p.startswith(str(BUILD_DIR)) for p in libs),
          f"native libraries outside _build/: {libs}")
    tmp = tempfile.mkdtemp()
    try:
        vocab, merges = build_simple_vocab(SLICE_WORDS)
        vpath, mpath = os.path.join(tmp, "vocab.json"), os.path.join(
            tmp, "merges.txt")
        with open(vpath, "w") as f:
            json_mod.dump(vocab, f, ensure_ascii=False)
        with open(mpath, "w") as f:
            f.write("\n".join(["#version: 0.2"] + [
                f"{a} {b}" for (a, b), _ in sorted(merges.items(),
                                                   key=lambda kv: kv[1])])
                    + "\n")
        cc = native.NativeBPETokenizer(vpath, mpath)
        py = CLIPTokenizer.from_files(vpath, mpath)
        texts = [" ".join(SLICE_WORDS[i:] + SLICE_WORDS[:i])
                 for i in range(len(SLICE_WORDS))] + ["", "  A   Horse!! "]
        same = all(cc.encode(x) == py.encode(x) for x in texts)
        timing = {}
        for name, tok in (("native", cc), ("python", py)):
            t = time.perf_counter()
            for _ in range(20):
                tok.encode_batch(texts)
            timing[name] = 1e6 * (time.perf_counter() - t) / (
                20 * len(texts))
        print(f"native tokenizer: ids equal to io/tokenizer.py on "
              f"{len(texts)} prompts: {same}; {timing['native']:.1f} us vs "
              f"{timing['python']:.1f} us a prompt (host) [{card}]",
              flush=True)
        check(same, "the native tokenizer's ids differ from the Python one's")
        gen = torch.Generator().manual_seed(93)
        tensors = {f"w{i}": torch.randn(4096, 4096, generator=gen).to(
            torch.bfloat16) for i in range(8)}
        tensors.update(f32=torch.randn(3, 5, generator=gen),
                       f16=torch.randn(7, generator=gen).half(),
                       i64=torch.arange(6).reshape(2, 3),
                       u8=torch.arange(9, dtype=torch.uint8),
                       flag=torch.tensor([True, False]),
                       scalar=torch.tensor(2.5))
        path = os.path.join(tmp, "native.safetensors")
        tw.save_safetensors_dict(tensors, path)
        opened = []
        reader = native.NativeSafetensors

        class Counting(reader):
            def __init__(self, p):
                opened.append(p)
                super().__init__(p)

        native.NativeSafetensors = Counting
        try:
            tw.load_safetensors_dict(path)              # warm the file
            t = time.perf_counter()
            got = tw.load_safetensors_dict(path)
            native_s = time.perf_counter() - t
        finally:
            native.NativeSafetensors = reader
        t = time.perf_counter()
        want = tw.load_safetensors_python(path)
        python_s = time.perf_counter() - t
        bits = lambda x: x.reshape(-1).view(torch.uint8)
        equal = sorted(got) == sorted(want) == sorted(tensors) and all(
            got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            and torch.equal(bits(got[k]), bits(want[k]))
            and torch.equal(bits(want[k]), bits(tensors[k])) for k in want)
        got["w0"].add_(1.0)           # a private copy of its pages
        kept = torch.equal(bits(tw.load_safetensors_dict(path)["w0"]),
                           bits(tensors["w0"]))
        size = os.path.getsize(path)
        print(f"native safetensors reader: {size} bytes read through it "
              f"({len(opened)} opens) in {native_s:.3f} s, the Python "
              f"reader {python_s:.3f} s (both views of a copy-on-write map, "
              f"read when used); bit-equal: {equal}; a write to a view left "
              f"the file as it was: {kept} (warm file) [{card}]", flush=True)
        check(kept, "a write to a native view reached the file")
        check(len(opened) == 2, "load_safetensors_dict did not take the "
                                f"native reader: {len(opened)} opens")
        check(equal, "the native reader's tensors differ from the Python "
                     "reader's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# K1, K3 and K4 at every head dim up to 256, and tiny-SD at YAML widths whose
# heads are not 64 or 128 wide.
# Correctness: bf16 at these head dims (36 is not a multiple of 8: the
# wrapper pads it) over (B, H, Lq, Lk) = HEAD_DIM_CASE, more than one tile on
# each side and a ragged one, without a mask and causal, and in every mask
# form at HEAD_DIM_ALL_FORMS (K4 above 128: one block a 64-key tile, at 160
# and 256); fp32 without a mask and causal at HEAD_DIM_FP32 (above 128 the
# two-block TF32 backward at each of its widths: 136, 144, 160 -> 160; 192;
# 200 -> 224; 232, 256 -> 256; above 160 the streaming TF32 forward at 192,
# 224 and 256).
HEAD_DIM_BF16 = (8, 16, 32, 36, 96, 144, 160, 192, 224, 256)
HEAD_DIM_ALL_FORMS = (96, 160, 256)
HEAD_DIM_FP32 = (24, 36, 96, 112, 136, 144, 160, 192, 200, 232, 256)
# fp32 K1, K3 and K4 against fp64 at HEAD_DIM_CASE: the wide kernels' head
# dims (K1's streaming kernel at 256, the two-block K3 / K4 at 160 and 256)
# beside the one-block kernels' widest, in one call; the wide ones' error
# may be at most FP64_WIDE_RATIO times the d = 128 one's
HEAD_DIM_FP64 = (128, 160, 256)
FP64_WIDE_RATIO = 2.0
HEAD_DIM_CASE = (2, 2, 600, 520)
MASK_FORMS = [(c, b, s) for c in (False, True) for b in (False, True)
              for s in (False, True)]      # (causal, bias, segment ids)
# The timed shapes (B, H, Lq, Lk, D): tiny-SD at batch 32 at `channel: 96`
# (one head of 96 at 64^2, one of 192 at 32^2) and `channel: 320` (two heads
# of 160 at 64^2), and head dim 256 at 1024 tokens.
HEAD_DIM_TIMED = [(32, 1, 4096, 4096, 96), (32, 1, 1024, 1024, 192),
                  (32, 2, 4096, 4096, 160), (16, 2, 1024, 1024, 256)]
# tiny-SD widths: TinySDConfig() changed only by `channel`; K1, K3 and K4
# launches a train step by head dim (the six transformer blocks at 64^2 and
# 32^2: enc1, dec6, dec7 at 64^2 and dec4, dec5 at 32^2 at the base width,
# enc3 at 32^2 at twice it; heads = max(1, channels // 128)).
TINY_SD_WIDTHS = {96: {96: 5, 192: 1}, 320: {160: 5, 128: 1}}
WIDTH_TRAIN_STEPS = (1, 3)   # warm-up, timed
WIDTH_SAMPLE_T = 10   # cut from 20 to pay for the wide heads phase


def head_dim_inputs(rnd, dtype, d, form, shape=HEAD_DIM_CASE):
    """q, k, v, dO at (B, H, Lq | Lk, d) and the masks of ``form``: a bias
    (1, H, Lq, Lk) fp32, segment ids of runs of 200 queries and 173 keys."""
    import torch

    b, h, lq, lk = shape
    q, g = (rnd(b, h, lq, d).to(dtype) for _ in range(2))
    k, v = (rnd(b, h, lk, d).to(dtype) for _ in range(2))
    causal, bias, seg = form
    masks = dict(causal=causal)
    if bias:
        masks["bias"] = rnd(1, h, lq, lk)
    if seg:
        masks["segment_ids"] = tuple(
            (torch.arange(n, device="cuda") // run).int().repeat(b, 1)
            for n, run in ((lq, 200), (lk, 173)))
    return q, k, v, g, masks


def head_dim_check(fa, q, k, v, g, masks, what):
    """K1, K3 and K4 against their plain versions on one input: out and lse
    (bf16 2e-2 / 1e-3, fp32 1e-4), each gradient (dbias too) within 2e-2
    (fp32: 1e-4) of its largest magnitude; the launches counted at the
    caller's head dim. Returns the largest errors by kernel."""
    import torch

    d = q.shape[-1]
    fns = (fa.flash_attention_cuda, fa.flash_attention_bwd_dq_cuda,
           fa.flash_attention_bwd_dkv_cuda)
    before = [fn.head_dims[d] for fn in fns]
    out, lse = fa.flash_attention_cuda(q, k, v, **masks)
    need_dbias = "bias" in masks
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **masks,
                                        need_dbias=need_dbias)
    torch.cuda.synchronize()
    counted = all(fn.head_dims[d] == n + 1 for fn, n in zip(fns, before))
    ref, ref_lse = fa.flash_attention_plain(q, k, v, **masks)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, **masks,
                                        need_dbias=need_dbias)
    tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
    seen = ref_lse > -1e29
    err_out = (out.float() - ref.float()).abs().max().item()
    err_lse = (lse - ref_lse)[seen].abs().max().item()
    ok = err_out <= tol and err_lse <= max(tol, 1e-3) and counted
    errs = dict(K1=err_out, K3=0.0, K4=0.0)
    parts = [f"out {err_out:.2e} lse {err_lse:.2e}"]
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), grads, want):
        err = (a.float() - w.float()).abs().max().item()
        ref_max = w.float().abs().max().item()
        ok = ok and err <= tol * ref_max + 1e-6
        kernel = "K3" if name in ("dq", "dbias") else "K4"
        errs[kernel] = max(errs[kernel], err)
        parts.append(f"{name} {err:.2e} (of {ref_max:.2e})")
    print(f"head dims: {what}: {', '.join(parts)}; counted at d={d}: "
          f"{counted}", flush=True)
    check(ok, f"K1/K3/K4 disagree with the plain versions at {what}: "
          f"{', '.join(parts)}, counted {counted}")
    return errs


def phase_kernels_head_dims(card, tail):
    """K1, K3 and K4 at the head dims of HEAD_DIM_BF16 and HEAD_DIM_FP32
    against their plain versions (:func:`head_dim_check`), then timed at
    HEAD_DIM_TIMED in bf16 and fp32 beside the plain versions, one
    ``scaled_dot_product_attention`` (its backward: its whole one) and the
    bound. Returns (largest error by kernel, the timed records by
    kernel)."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2200)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    errs = dict(K1=0.0, K3=0.0, K4=0.0)
    n_cases = 0
    for dtype, dims in ((bf16, HEAD_DIM_BF16), (fp32, HEAD_DIM_FP32)):
        for d in dims:
            forms = (MASK_FORMS if dtype == bf16 and d in HEAD_DIM_ALL_FORMS
                     else MASK_FORMS[:1] + MASK_FORMS[4:5])
            for form in forms:
                q, k, v, g, masks = head_dim_inputs(rnd, dtype, d, form)
                dt = "bf16" if dtype == bf16 else "fp32"
                route = "/".join(r(dtype, d, *form) for r in (
                    fa.k1_route, fa.k3_route, fa.k4_route))
                what = (f"{dt} d={d} {HEAD_DIM_CASE} causal={form[0]} "
                        f"bias={form[1]} segments={form[2]} ({route})")
                for key, e in head_dim_check(fa, q, k, v, g, masks,
                                             what).items():
                    errs[key] = max(errs[key], e)
                n_cases += 1
    print(f"head dims: {n_cases} cases held against the plain versions; "
          f"largest errors {errs}", flush=True)

    # fp32 K1, K3 / K4 against fp64: out and lse absolute, dq, dk and dv
    # relative to their largest magnitude, the wide head dims beside d = 128
    # on the same seed
    fp64_err, fp64_fwd_err = {}, {}
    for d in HEAD_DIM_FP64:
        g64 = torch.Generator(device="cuda").manual_seed(2300)
        q, k, v, g = (torch.randn((*HEAD_DIM_CASE[:2], n, d), generator=g64,
                                  device="cuda")
                      for n in (HEAD_DIM_CASE[2], HEAD_DIM_CASE[3],
                                HEAD_DIM_CASE[3], HEAD_DIM_CASE[2]))
        out, lse = fa.flash_attention_cuda(q, k, v)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g)
        d64 = [x.double() for x in (q, k, v)]
        o64, l64 = fa.flash_attention_plain(*d64)
        fp64_fwd_err[d] = dict(out=(out.double() - o64).abs().max().item(),
                               lse=(lse.double() - l64).abs().max().item())
        ref = fa.flash_attention_bwd_plain(*d64, o64, l64, g.double())
        fp64_err[d] = {name: ((a.double() - w).abs().max()
                              / w.abs().max()).item()
                       for name, a, w in zip(("dq", "dk", "dv"), got, ref)}
        del q, k, v, g, out, lse, got, d64, o64, l64, ref
    base = max(fp64_err[128].values())
    print("head dims: fp32 K3 / K4 against fp64 at " + str(HEAD_DIM_CASE)
          + ", of each gradient's largest: " + "; ".join(
              f"d={d} (width {-(-d // 32) * 32 if d > 128 else d}, "
              f"{'two blocks' if d > 128 else 'one block'}): " + ", ".join(
                  f"{n} {e:.3e}" for n, e in fp64_err[d].items())
              for d in HEAD_DIM_FP64)
          + f"; the wide widths' largest over d = 128's: " + ", ".join(
              f"d={d} {max(fp64_err[d].values()) / base:.2f}"
              for d in HEAD_DIM_FP64 if d > 128), flush=True)
    check(all(max(fp64_err[d].values()) <= FP64_WIDE_RATIO * base
              for d in HEAD_DIM_FP64 if d > 128),
          f"fp32 K3 / K4 above 128 further from fp64 than {FP64_WIDE_RATIO}"
          f" x d = 128: {fp64_err}")
    base_fwd = max(fp64_fwd_err[128].values())
    print("head dims: fp32 K1 against fp64 at " + str(HEAD_DIM_CASE)
          + ": " + "; ".join(
              f"d={d} ({fa.k1_route(fp32, d)}, "
              f"{'streaming' if d > 160 else 'resident Q'}): out "
              f"{e['out']:.3e}, lse {e['lse']:.3e}"
              for d, e in fp64_fwd_err.items())
          + "; the wide widths' largest over d = 128's: " + ", ".join(
              f"d={d} {max(fp64_fwd_err[d].values()) / base_fwd:.2f}"
              for d in HEAD_DIM_FP64 if d > 128), flush=True)
    check(all(max(fp64_fwd_err[d].values()) <= FP64_WIDE_RATIO * base_fwd
              for d in HEAD_DIM_FP64 if d > 128),
          f"fp32 K1 above 128 further from fp64 than {FP64_WIDE_RATIO} x "
          f"d = 128: {fp64_fwd_err}")

    sdpa = F.scaled_dot_product_attention
    records = dict(K1=[], K3=[], K4=[], fp64=fp64_err, fp64_fwd=fp64_fwd_err,
                   K1_any=[])
    # K1's ANY instantiation (every mask path compiled in) timed in the form
    # with all three masks at HEAD_DIM_CASE, beside the plain version and
    # one scaled_dot_product_attention call given the same masks as one
    # additive fp32 mask (built outside the timing); the bound counts the
    # visible pairs, the bias and the ids
    b_, h_, lq_, lk_ = HEAD_DIM_CASE
    for d in HEAD_DIM_ALL_FORMS:
        q, k, v, _, masks = head_dim_inputs(rnd, bf16, d, MASK_FORMS[-1])
        q_ids, kv_ids = masks["segment_ids"]
        seen = ((q_ids[:, None, :, None] == kv_ids[:, None, None, :])
                & (torch.arange(lk_, device="cuda")[None, :]
                   <= torch.arange(lq_, device="cuda")[:, None]))
        add = masks["bias"] + torch.where(seen, 0.0, float("-inf"))
        share = seen.float().mean().item()
        nbytes = (b_ * h_ * (2.0 * d * 2 * (lq_ + lk_) + 4.0 * lq_)
                  + 4.0 * h_ * lq_ * lk_ + 4.0 * b_ * (lq_ + lk_))
        bnd = bound(4.0 * b_ * h_ * lq_ * lk_ * d * share, nbytes)
        t = dict(ms=cuda_ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                            **masks)),
                 plain_ms=cuda_ms(lambda: fa.flash_attention_plain(
                     q, k, v, **masks), 5, 1),
                 library_ms=cuda_ms(lambda: sdpa(q, k, v,
                                                 attn_mask=add.to(bf16))),
                 bound_ms=bnd[0], bound_by=bnd[1])
        records["K1_any"].append(dict(shape=[b_, h_, lq_, lk_, d],
                                      form="causal+bias+segments",
                                      visible_share=share, **t))
        print(f"head dims: K1 ANY bf16 causal + bias + segments "
              f"{(b_, h_, lq_, lk_, d)} ({100 * share:.1f} % of the pairs "
              f"visible): {tail(**t)}", flush=True)
        del q, k, v, masks, seen, add
    for dtype in (bf16, fp32):
        dt = "bf16" if dtype == bf16 else "fp32"
        heavy = dtype == fp32
        for b, h, lq, lk, d in HEAD_DIM_TIMED:
            q, k, v, g, _ = head_dim_inputs(rnd, dtype, d, MASK_FORMS[0],
                                            (b, h, lq, lk))
            out, lse = fa.flash_attention_cuda(q, k, v)
            delta = (g.float() * out.float()).sum(-1)
            routes = [r(dtype, d) for r in (fa.k1_route, fa.k3_route,
                                             fa.k4_route)]
            n, w = (3, 1) if heavy else (10, 2)
            plain_fwd = cuda_ms(lambda: fa.flash_attention_plain(q, k, v),
                                2, 1)
            plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, lse, g), 2, 1)
            lib_fwd = cuda_ms(lambda: sdpa(q, k, v), n, w)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            ol = sdpa(ql, kl, vl)
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(
                ol, (ql, kl, vl), g, retain_graph=True), n, w)
            del ol, ql, kl, vl
            runs = dict(
                K1=lambda: fa.flash_attention_cuda(q, k, v),
                K3=lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, g, lse,
                                                          delta),
                K4=lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, g, lse,
                                                           delta))
            # (products, Lq-like tensors, Lk-like tensors, row statistics)
            work = dict(K1=(2, 2, 2, 1), K3=(3, 3, 2, 2), K4=(4, 2, 4, 2))
            line = []
            for (kernel, run), route in zip(runs.items(), routes):
                shape = (b, h, lq, lk, d, *work[kernel])
                if dtype == bf16:
                    bnd = dict(zip(("bound_ms", "bound_by"),
                                   attn_bound(*shape)))
                else:                     # the TF32 kernels
                    bnd = tf32_bound(b, h, lq, lk, d, 1.0, *work[kernel])
                fwd = kernel == "K1"
                times = dict(ms=cuda_ms(run, n, w),
                             plain_ms=plain_fwd if fwd else plain_bwd,
                             library_ms=lib_fwd if fwd else lib_bwd,
                             bound_ms=bnd["bound_ms"],
                             bound_by=bnd["bound_by"])
                # the kernel's own device time (profiler), beside the wall:
                # bf16 K1 and K4; fp32 K1 with its split pre-pass apart
                device = {}
                if dtype == bf16 and kernel in ("K1", "K4"):
                    device["device_ms"] = kernel_device_ms(
                        run, "K1 flash fwd" if fwd else "K4 flash bwd dk/dv")
                elif fwd:
                    device = fp32_fwd_device_ms(run)
                records[kernel].append(dict(
                    dtype=dt, shape=[b, h, lq, lk, d], route=route,
                    bound_basis=bnd.get("bound_basis",
                                        "bf16 at 989 TFLOP/s"), **times,
                    **device))
                share = times["bound_ms"] / times["ms"]
                records[kernel][-1]["bound_share"] = share
                line.append(f"{kernel} ({route}): {tail(**times)}, "
                            f"{100 * share:.1f} % of the bound" + "".join(
                                f", {k.replace('_ms', '')} {fmt_ms(v)}"
                                for k, v in device.items()))
            pair = sum(r[-1]["ms"] for r in (records["K3"], records["K4"]))
            print(f"head dims: timed {dt} (B,H,Lq,Lk,D)=({b},{h},{lq},{lk},"
                  f"{d}) (plain and library backward: dq, dk and dv "
                  f"together); " + "; ".join(line) + f"; K3 + K4 "
                  f"{pair:.4f} ms against the library's whole backward "
                  f"{lib_bwd:.4f} ms ({lib_bwd / pair:.2f} x)", flush=True)
            del q, k, v, g, out, lse, delta
            torch.cuda.empty_cache()
    return errs, records


# ---------------------------------------------------------------------------
# Every flash form up to head dim 256 in both dtypes: the fp32 bias (with
# dbias), segment-id and causal forms of K1, K3 and K4, and K5, K6 and K7 at
# every head dim, online and bounded.
# Correctness at FORMS_CASE, ragged on both sides, at FORMS_DIMS (36 is not a
# multiple of 8: the wrappers pad it; 8 and 36 run at width 32 in the fp32
# mask forms, 160 on the one-block fp32 K1 and the two-block K3 / K4, 192
# and 256 on the streaming fp32 K1): bf16 against the plain versions at the
# ANY row's tolerance (out 2e-2, lse 1e-3, gradients 2e-2 of their largest);
# fp32 against the plain versions in fp64, each kernel within FORMS_FP64_RATIO
# times the error the no-mask form shows at the same head dim in the same
# call. There every error is taken relative to the largest magnitude of what
# it measures (out, lse over the rows that see a key, each gradient), as a
# mask changes those magnitudes (a causal row of one key gives out = v, a
# bias moves lse past 8, where an fp32 ulp doubles), and the no-mask form's
# error is the largest over its kernels (K1, K3, K4; K5, K6, K7) and over
# FORMS_BASE_DRAWS draws of its inputs: at these sizes each is a few fp32
# ulps, and one kernel's moves by up to 1.9 x from one draw to the next
# (each draw's errors are printed). A kernel that rounded an operand to one TF32
# pass would be ~1e-3 off, a wrong mask O(1). The position masks: two
# segments a side, valid_len, causal; the first 30 queries (positions 20 ..
# 49) see no key under causal (out 0, lse -1e30).
FORMS_DIMS = (8, 32, 36, 96, 128, 160, 192, 256)
FORMS_CASE = (2, 2, 600, 520)
FORMS_FP64_RATIO = 2.0
FORMS_BASE_DRAWS = 2
FORMS_POS = dict(q_off=(20, 1000), k_off=(50, 900), seg_q=300, seg_k=260,
                 valid_len=1100)
# The timed shapes: the fp32 bias at (B, H, L, L, D) with a (1, H, L, L)
# bias; the packed segment row of K1_FORMS in fp32, with and without causal
# (8 ragged sequences a row); SD3-medium's joint attention (hidden 1536,
# 154 + 4096 tokens, batch 2) cut into heads of FORMS_POS_DIMS. At each the
# kernels are held to the plain versions too, dbias into a NaN-poisoned
# pool: fp32 (TF32 off) within FP32_TOL, out and lse absolute and each
# gradient of its largest; bf16 at the ANY row's tolerance.
FORMS_BIAS_SHAPE = (2, 8, 4096, 4096, 128)
FORMS_SEG_SHAPE = (2, 12, 4096, 4096, 64)
FORMS_POS_DIMS = (32, 96, 128, 192, 256)
SD3_HIDDEN = 1536


def _poison(*shape):
    """NaNs in the allocator's pool at ``shape`` (fp32): a dbias tile the
    kernel leaves unwritten shows."""
    import torch

    junk = torch.full(shape, float("nan"), device="cuda")
    del junk


def _rel_err(a, w):
    """max|a - w| over max|w|, in fp64 (0 where w is 0 everywhere)."""
    top = w.double().abs().max().item()
    return (a.double() - w.double()).abs().max().item() / (top or 1.0)


def full_width_errors(fwd, want_fwd, grads, want_grads):
    """A kernel's (out, lse) and gradients against the plain versions':
    out and lse absolute, each gradient relative to its largest magnitude
    (:func:`_rel_err`), inf where a value is not finite; keyed out, lse,
    dq, dk, dv (, dbias)."""
    import math

    (out, lse), (w_out, w_lse) = fwd, want_fwd
    errs = dict(out=(out.double() - w_out.double()).abs().max().item(),
                lse=(lse.double() - w_lse.double()).abs().max().item())
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), grads, want_grads):
        errs[name] = _rel_err(a, w)
    return {k: x if math.isfinite(x) else float("inf")
            for k, x in errs.items()}


def forms_masks_check(fa, rnd, d):
    """fp32 K1, K3, K4 in the 7 mask forms of MASK_FORMS at head dim ``d``
    against the fp64 plain versions; returns {form: errors by kernel} and
    the no-mask form's errors on each of its draws (the yardstick is the
    largest)."""
    import torch

    fp32 = torch.float32
    errs, draws = {}, []
    for form in MASK_FORMS[:1] * FORMS_BASE_DRAWS + MASK_FORMS[1:]:
        q, k, v, g, masks = head_dim_inputs(rnd, fp32, d, form, FORMS_CASE)
        need = "bias" in masks
        d64 = [x.double() for x in (q, k, v)]
        m64 = dict(masks, **({"bias": masks["bias"].double()} if need
                             else {}))
        o64, l64 = fa.flash_attention_plain(*d64, **m64)
        ref = fa.flash_attention_bwd_plain(*d64, o64, l64, g.double(), **m64,
                                           need_dbias=need)
        out, lse = fa.flash_attention_cuda(q, k, v, **masks)
        if need:
            _poison(*q.shape[:3], k.shape[2])
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **masks,
                                          need_dbias=need)
        torch.cuda.synchronize()
        seen = l64 > -1e29
        blank = bool((lse[~seen] <= -1e29).all()) and not bool(
            out[~seen].any())
        e1 = max(_rel_err(out, o64), _rel_err(lse[seen], l64[seen]))
        rel = [_rel_err(a, w) for a, w in zip(got, ref)]
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        e = dict(K1=e1 if blank else float("inf"),
                 K3=max([rel[0]] + rel[3:]) if finite else float("inf"),
                 K4=max(rel[1:3]) if finite else float("inf"))
        # the no-mask form: the largest over its draws
        errs[form] = {k: max(x, errs.get(form, {}).get(k, 0.0))
                      for k, x in e.items()}
        if form == MASK_FORMS[0]:
            draws.append(e)
        del q, k, v, g, masks, d64, m64, o64, l64, ref, out, lse, got
    return errs, draws


def forms_pos_inputs(rnd, dtype, d, shape=FORMS_CASE):
    import torch

    b, h, lq, lk = shape
    q, g = (rnd(b, h, lq, d).to(dtype) for _ in range(2))
    k, v = (rnd(b, h, lk, d).to(dtype) for _ in range(2))
    return q, k, v, g


def forms_pos_check(fa, rnd, dtype, d, masked):
    """K5 (online and bounded), K6 and K7 at head dim ``d`` under the masks
    of FORMS_POS (``masked``) or none, against the plain versions (fp64
    ones for fp32 inputs). Returns the errors by kernel (K5 online and
    bounded apart) and whether the rows that see no key came out blank."""
    import torch

    off = lambda a: torch.tensor(a, dtype=torch.int32, device="cuda")
    q, k, v, g = forms_pos_inputs(rnd, dtype, d)
    if masked:
        kw = dict(causal=True, valid_len=FORMS_POS["valid_len"],
                  seg_q=FORMS_POS["seg_q"], seg_k=FORMS_POS["seg_k"])
        qo, ko = off(FORMS_POS["q_off"]), off(FORMS_POS["k_off"])
    else:
        kw, qo, ko = {}, off((0, 0)), off((0, 0))
    wide = dtype == torch.float32
    ins = [x.double() for x in (q, k, v)] if wide else [q, k, v]
    ref, ref_lse = fa.flash_attention_pos_plain(*ins, qo, ko, **kw)
    seen = ref_lse > -1e29
    errs, blank = {}, True
    for stability in ("online", "bounded"):
        out, lse = fa.flash_attention_pos_cuda(q, k, v, qo, ko,
                                               stability=stability, **kw)
        torch.cuda.synchronize()
        blank = blank and bool((lse[~seen] <= -1e29).all()) and not bool(
            out[~seen].any())
        # absolute (bf16's tolerances), then relative to the largest
        # magnitude (fp32's)
        errs["K5 " + stability] = (
            (out.double() - ref.double())[seen].abs().max().item(),
            (lse.double() - ref_lse.double())[seen].abs().max().item(),
            _rel_err(out[seen], ref[seen]),
            _rel_err(lse[seen], ref_lse[seen]))
    lse32 = ref_lse.float().contiguous()
    delta = (g.double() * ref.double()).sum(-1)
    gw = g.double() if wide else g
    want = fa.flash_bwd_pos_plain(*ins, gw, ref_lse if wide else lse32,
                                  delta if wide else delta.float(), qo, ko,
                                  **kw)
    got = (fa.flash_bwd_pos_dq_cuda(q, k, v, g, lse32, delta.float(), qo, ko,
                                    **kw),
           *fa.flash_bwd_pos_dkv_cuda(q, k, v, g, lse32, delta.float(), qo,
                                      ko, **kw))
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    rel = [_rel_err(a, w) if finite else float("inf")
           for a, w in zip(got, want)]
    errs["K6"], errs["K7"] = rel[0], max(rel[1:])
    return errs, blank and int((~seen).sum()) == (
        2 * 2 * 30 if masked else 0)


def joint_calls(fa, c_, x_, gs, z):
    """The four stream pairs of one joint attention call, each query stream
    (q of ``c_`` or ``x_``, [q, k, v] lists) against each key stream, and
    the calls that run them: ``fwd(stability)()`` K5 over the pairs,
    ``dq()`` K6, ``dkv()`` K7 (under each query stream's merged lse and
    delta with its cotangent in ``gs``), ``plain_fwd()`` and ``plain_bwd()``
    their plain versions. Returns them in a dict beside the pairs, the
    query streams and the merged row statistics."""
    qs = dict(c=c_[0], x=x_[0])
    pairs = [(sq, kv) for sq in ("c", "x") for kv in (c_, x_)]
    stats = {}
    for sq in ("c", "x"):
        o, l = fa.merge_attention_partials(
            *fa.flash_attention_pos(qs[sq], c_[1], c_[2], z, z),
            *fa.flash_attention_pos(qs[sq], x_[1], x_[2], z, z))
        stats[sq] = (l.contiguous(), (gs[sq].float() * o.float()).sum(-1))
    return dict(
        qs=qs, pairs=pairs, stats=stats,
        fwd=lambda st: lambda: [fa.flash_attention_pos_cuda(
            qs[sq], kv[1], kv[2], z, z, stability=st) for sq, kv in pairs],
        dq=lambda: [fa.flash_bwd_pos_dq_cuda(
            qs[sq], kv[1], kv[2], gs[sq], *stats[sq], z, z)
            for sq, kv in pairs],
        dkv=lambda: [fa.flash_bwd_pos_dkv_cuda(
            qs[sq], kv[1], kv[2], gs[sq], *stats[sq], z, z)
            for sq, kv in pairs],
        plain_fwd=lambda: [fa.flash_attention_pos_plain(
            qs[sq], kv[1], kv[2], z, z) for sq, kv in pairs],
        plain_bwd=lambda: [fa.flash_bwd_pos_plain(
            qs[sq], kv[1], kv[2], gs[sq], *stats[sq], z, z)
            for sq, kv in pairs])


def joint_library_ms(cat, gcat):
    """One scaled_dot_product_attention over the concatenated streams
    ``cat`` ([q, k, v]) and its whole backward under ``gcat``: (forward ms,
    backward ms)."""
    import torch
    import torch.nn.functional as F

    sdpa = F.scaled_dot_product_attention
    ql, kl, vl = (t.detach().requires_grad_() for t in cat)
    ol = sdpa(ql, kl, vl)
    lib_f = cuda_ms(lambda: sdpa(*cat), 3, 1)
    lib_b = cuda_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), gcat, retain_graph=True), 3, 1)
    return lib_f, lib_b


def phase_kernels_forms(card, tail):
    """The forms this slice added, against their plain versions at
    FORMS_DIMS (:func:`forms_masks_check`, :func:`forms_pos_check`), then
    held to them and timed at the full-width shapes (FORMS_BIAS_SHAPE,
    FORMS_SEG_SHAPE and SD3's joint attention at FORMS_POS_DIMS), beside
    the plain versions, one
    ``scaled_dot_product_attention`` call given the same masks as one mask
    (TF32 off) and the bound. Returns the records by kernel."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2500)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    sdpa = F.scaled_dot_product_attention
    records = {k: dict(errors=[], timed=[]) for k in
               ("K1", "K3", "K4", "K5", "K6", "K7")}

    # fp32 K1 / K3 / K4: the 7 mask forms against the no-mask form's error
    for d in FORMS_DIMS:
        errs, draws = forms_masks_check(fa, rnd, d)
        base = max(errs[MASK_FORMS[0]].values())
        print(f"forms: fp32 d={d} {FORMS_CASE} no mask against fp64, by "
              f"draw: " + "; ".join(", ".join(f"{k} {x:.3e}" for k, x in
                                               e.items()) for e in draws)
              + f" (the yardstick: {base:.3e})", flush=True)
        for form in MASK_FORMS[1:]:
            e = errs[form]
            ok = all(x <= FORMS_FP64_RATIO * base for x in e.values())
            name = "+".join(n for n, on in zip(("causal", "bias", "segments"),
                                               form) if on)
            print(f"forms: fp32 d={d} {FORMS_CASE} {name} "
                  f"({fa.k1_route(fp32, d, *form)}, K1 tiles "
                  f"{fa._f32_tiles('k1', -(-d // 8) * 8)}) against fp64, "
                  f"of each output's largest: " + ", ".join(
                      f"{k} {x:.3e}" for k, x in e.items())
                  + f" (the no-mask form's {base:.3e}: "
                  f"{max(e.values()) / base:.2f} x)", flush=True)
            check(ok, f"fp32 K1/K3/K4 {name} at d={d} further from fp64 "
                  f"than {FORMS_FP64_RATIO} x the no-mask form: {e} / {base}")
            for k in e:
                records[k]["errors"].append(dict(
                    dtype="fp32", d=d, form=name, err=e[k],
                    no_mask_err=base))
    # K5 / K6 / K7 in bf16 and fp32
    for dtype in (bf16, fp32):
        dt = "bf16" if dtype == bf16 else "fp32"
        for d in FORMS_DIMS:
            errs, blank = forms_pos_check(fa, rnd, dtype, d, True)
            if dtype == bf16:
                base = None
                ok = blank and all(
                    errs[k][0] <= 2e-2 and errs[k][1] <= 1e-3
                    for k in ("K5 online", "K5 bounded")) and (
                    errs["K6"] <= 2e-2 and errs["K7"] <= 2e-2)
                tol = "out 2e-2, lse 1e-3, gradients 2e-2 of their largest"
            else:
                rel = lambda e: {k: max(v[2:]) if isinstance(v, tuple) else v
                                 for k, v in e.items()}
                draws = [rel(forms_pos_check(fa, rnd, dtype, d, False)[0])
                         for _ in range(FORMS_BASE_DRAWS)]
                base = max(max(e.values()) for e in draws)
                print(f"forms: fp32 d={d} {FORMS_CASE} position masks off "
                      f"against fp64, by draw: " + "; ".join(", ".join(
                          f"{k} {x:.3e}" for k, x in e.items())
                          for e in draws), flush=True)
                ok = blank and all(x <= FORMS_FP64_RATIO * base
                                   for x in rel(errs).values())
                tol = (f"{FORMS_FP64_RATIO} x the no-mask form's {base:.3e}, "
                       f"each relative to its largest: " + ", ".join(
                           f"{k} {x:.3e}" for k, x in rel(errs).items()))
            print(f"forms: {dt} d={d} {FORMS_CASE} position masks "
                  f"({fa.k5_route(dtype, d)}): " + ", ".join(
                      f"{k} out {v[0]:.3e} lse {v[1]:.3e}"
                      if isinstance(v, tuple) else f"{k} {v:.3e}"
                      for k, v in errs.items())
                  + f"; blank rows blank: {blank} (tol {tol})", flush=True)
            check(ok, f"K5/K6/K7 {dt} at d={d} disagree: {errs} / {base} / "
                  f"blank {blank}")
            for k, v in errs.items():
                kern = k.split()[0]
                err = v if not isinstance(v, tuple) else (
                    max(v[:2]) if dtype == bf16 else max(v[2:]))
                records[kern]["errors"].append(dict(
                    dtype=dt, d=d, form=k, err=err,
                    **({} if base is None else dict(no_mask_err=base))))

    def timed(kernel, what, run, plain, library, bnd, family, **extra):
        n, w = (5, 1)
        t = dict(ms=cuda_ms(run, n, w), plain_ms=plain,
                 library_ms=library, bound_ms=bnd["bound_ms"],
                 bound_by=bnd["bound_by"])
        dev = device_families(lambda: [run() for _ in range(3)], family)
        t["device_ms"] = dev[family] / 3 if family in dev else None
        records[kernel]["timed"].append(dict(form=what, **extra, **t))
        return f"{kernel} {tail(**{k: x for k, x in t.items() if k != 'device_ms'})}, device {fmt_ms(t['device_ms'])}"

    # fp32 K1 / K3 / K4 with a bias, and with segment ids (with and without
    # causal), at full width
    b, h, lq, lk, d = FORMS_BIAS_SHAPE
    q, k, v, g = (rnd(b, h, lq, d) for _ in range(4))
    bias = rnd(1, h, lq, lk)
    cases = [("bias", FORMS_BIAS_SHAPE, dict(bias=bias), 1.0)]
    bs, hs, ls, _, ds_ = FORMS_SEG_SHAPE
    ids = k1_segment_ids("packed", bs, ls)
    seen = (ids[:, None, :, None] == ids[:, None, None, :])
    share = seen.float().mean().item()
    causal_seen = seen & torch.ones(ls, ls, dtype=torch.bool,
                                    device="cuda").tril()
    cshare = causal_seen.float().mean().item()
    del seen, causal_seen
    for name, shape, masks, vis in cases + [
            ("segments", FORMS_SEG_SHAPE, dict(segment_ids=(ids, ids)),
             share),
            ("segments + causal", FORMS_SEG_SHAPE,
             dict(segment_ids=(ids, ids), causal=True), cshare)]:
        b, h, lq, lk, d = shape
        if shape != FORMS_BIAS_SHAPE:
            q, k, v, g = (rnd(b, h, lq, d) for _ in range(4))
        need = "bias" in masks
        out, lse = fa.flash_attention_cuda(q, k, v, **masks)
        delta = (g * out).sum(-1)
        # the kernels held to the plain versions (fp32, TF32 off) at this
        # full width, dbias into a NaN-poisoned pool; the plain calls' first
        # run gives the outputs and warms their timing below
        want_o, want_l = fa.flash_attention_plain(q, k, v, **masks)
        want_g = fa.flash_attention_bwd_plain(q, k, v, want_o, want_l, g,
                                              **masks, need_dbias=need)
        if need:
            _poison(b, h, lq, lk)
        got_g = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **masks,
                                            need_dbias=need)
        torch.cuda.synchronize()
        full = full_width_errors((out, lse), (want_o, want_l), got_g, want_g)
        del want_o, want_l, want_g, got_g
        errs = dict(K1=max(full["out"], full["lse"]),
                    K3=max(v_ for k_, v_ in full.items()
                           if k_ in ("dq", "dbias")),
                    K4=max(full["dk"], full["dv"]))
        print(f"forms: fp32 {name} (B,H,Lq,Lk,D)={shape} against the plain "
              f"versions (fp32, TF32 off; out and lse absolute, each "
              f"gradient of its largest): " + ", ".join(
                  f"{k_} {x:.3e}" for k_, x in full.items())
              + f" (tol {FP32_TOL})", flush=True)
        check(all(x <= FP32_TOL for x in full.values()),
              f"fp32 K1/K3/K4 {name} at {shape} disagree with the plain "
              f"versions: {full}")
        mask = fa._visible_pairs(lq, lk, masks.get("segment_ids"),
                                 masks.get("causal", False), "cuda")
        lib = dict(attn_mask=bias if need else mask)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = sdpa(ql, kl, vl, **lib)
        lib_f = cuda_ms(lambda: sdpa(q, k, v, **lib), 3, 1)
        lib_b = cuda_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), g, retain_graph=True), 3, 1)
        del ol, ql, kl, vl
        pf = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **masks), 1, 0)
        pb = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, g, **masks, need_dbias=need), 1, 0)
        torch.cuda.empty_cache()
        side = 4.0 * (bias.numel() if need else 2 * b * lq)
        bnd = lambda n_p, n_q, n_k, n_s: tf32_bound(
            b, h, lq, lk, d, vis, n_p, n_q, n_k, n_s)
        parts = []
        for kern, run, work, fam in (
                ("K1", lambda: fa.flash_attention_cuda(q, k, v, **masks),
                 (2, 2, 2, 1), F32_FWD),
                ("K3", lambda: fa.flash_attention_bwd_dq_cuda(
                    q, k, v, g, lse, delta, **masks, need_dbias=need),
                 (3, 3, 2, 2), "K3 flash bwd dq"),
                ("K4", lambda: fa.flash_attention_bwd_dkv_cuda(
                    q, k, v, g, lse, delta, **masks),
                 (4, 2, 4, 2), "K4 flash bwd dk/dv")):
            bb = bnd(*work)
            # the bias (and dbias, K3) or the ids moved once beside the
            # operands and row statistics
            moved = side * (2 if kern == "K3" and need else 1)
            bytes_ms = 1e3 * (b * h * 4.0 * (d * (work[1] * lq + work[2] * lk)
                                             + work[3] * lq)
                              + moved) / PEAK_BYTES
            if bytes_ms > bb["bound_ms"]:
                bb.update(bound_ms=bytes_ms, bound_by="bytes")
            parts.append(timed(kern, f"fp32 {name}", run,
                               pf if kern == "K1" else pb,
                               lib_f if kern == "K1" else lib_b, bb, fam,
                               shape=list(shape), dtype="fp32",
                               visible_share=vis, err=errs[kern]))
        print(f"forms: timed fp32 {name} (B,H,Lq,Lk,D)={shape} "
              f"({100 * vis:.1f} % of the pairs visible; the plain and "
              f"library backward compute dq, dk, dv"
              f"{' and dbias' if need else ''} together): "
              + "; ".join(parts), flush=True)
        del out, lse, delta, mask, lib
    del q, k, v, g, bias, ids
    torch.cuda.empty_cache()

    # K5 / K6 / K7 at SD3-medium's joint attention cut into heads of d
    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    for dtype in (bf16, fp32):
        dt = "bf16" if dtype == bf16 else "fp32"
        for d in FORMS_POS_DIMS:
            b, h = 2, SD3_HIDDEN // d
            c_ = [rnd(b, h, 154, d).to(dtype) for _ in range(3)]
            x_ = [rnd(b, h, 4096, d).to(dtype) for _ in range(3)]
            gs = dict(c=rnd(b, h, 154, d).to(dtype),
                      x=rnd(b, h, 4096, d).to(dtype))
            jc = joint_calls(fa, c_, x_, gs, z)
            qs, pairs, stats = jc["qs"], jc["pairs"], jc["stats"]
            fwd, dq, dkv = jc["fwd"], jc["dq"], jc["dkv"]
            cat = [torch.cat([c, x], dim=2) for c, x in zip(c_, x_)]
            lib_f, lib_b = joint_library_ms(
                cat, torch.cat([gs["c"], gs["x"]], dim=2))
            # the kernels held to the plain versions at this full width, pair
            # by pair; the plain calls' first run gives the outputs and warms
            # their timing below
            want_f, want_b = jc["plain_fwd"](), jc["plain_bwd"]()
            got_f = {st: fwd(st)() for st in ("online", "bounded")}
            got_b = [(a, *b_) for a, b_ in zip(dq(), dkv())]
            torch.cuda.synchronize()
            full = {}
            for i in range(len(pairs)):
                for st in ("online", "bounded"):
                    e = full_width_errors(got_f[st][i], want_f[i], (), ())
                    for part in ("out", "lse"):
                        key = f"K5 {st} {part}"
                        full[key] = max(full.get(key, 0.0), e[part])
                e = full_width_errors(got_f["online"][i], want_f[i],
                                      got_b[i], want_b[i])
                full["K6"] = max(full.get("K6", 0.0), e["dq"])
                full["K7"] = max(full.get("K7", 0.0), e["dk"], e["dv"])
            del want_f, want_b, got_f, got_b
            if dtype == bf16:
                tol = {k_: 1e-3 if k_.endswith("lse") else 2e-2
                       for k_ in full}
                said = "out 2e-2, lse 1e-3 absolute, gradients 2e-2 of " \
                       "their largest"
            else:
                tol = {k_: FP32_TOL for k_ in full}
                said = (f"fp32, TF32 off: out and lse within {FP32_TOL} "
                        f"absolute, gradients of their largest")
            print(f"forms: {dt} SD3 joint attention, {h} heads of {d}, the "
                  f"four stream pairs against the plain versions ({said}): "
                  + ", ".join(f"{k_} {x:.3e}" for k_, x in full.items()),
                  flush=True)
            check(all(full[k_] <= tol[k_] for k_ in full),
                  f"K5/K6/K7 {dt} at SD3's joint attention, heads of {d}, "
                  f"disagree with the plain versions: {full}")
            pf = cuda_ms(jc["plain_fwd"], 1, 0)
            pb = cuda_ms(jc["plain_bwd"], 1, 0)
            torch.cuda.empty_cache()
            n = 154 + 4096

            def bnd(n_p, n_q, n_k, n_s):
                if dtype == bf16:
                    return dict(zip(("bound_ms", "bound_by"),
                                    attn_bound(b, h, n, n, d, n_p, n_q, n_k,
                                               n_s)))
                return tf32_bound(b, h, n, n, d, 1.0, n_p, n_q, n_k, n_s)

            fam5 = "K5 flash fwd pos" if dtype == bf16 else F32_FWD
            fam6 = ("K6 flash bwd pos dq" if dtype == bf16
                    else "K3 flash bwd dq")
            fam7 = ("K7 flash bwd pos dk/dv" if dtype == bf16
                    else "K4 flash bwd dk/dv")
            extra = dict(shape=[b, h, n, d], dtype=dt, pairs="four stream "
                         "pairs, 154 + 4096 tokens")
            k5_err = lambda st: max(full[f"K5 {st} out"],
                                    full[f"K5 {st} lse"])
            parts = [
                timed("K5", f"{dt} online", fwd("online"), pf, lib_f,
                      bnd(2, 2, 2, 1), fam5, **extra, stability="online",
                      err=k5_err("online")),
                timed("K5", f"{dt} bounded", fwd("bounded"), pf, lib_f,
                      bnd(2, 2, 2, 1), fam5, **extra, stability="bounded",
                      err=k5_err("bounded")),
                timed("K6", dt, dq, pb, lib_b, bnd(3, 3, 2, 2), fam6,
                      **extra, err=full["K6"]),
                timed("K7", dt, dkv, pb, lib_b, bnd(4, 2, 4, 2), fam7,
                      **extra, err=full["K7"])]
            print(f"forms: timed {dt} SD3 joint attention, {h} heads of "
                  f"{d} (B, H, Lc + Lx, D)=({b},{h},154+4096,{d}), four "
                  f"launches each over the stream pairs (the plain and "
                  f"library backward compute dq, dk, dv together; the "
                  f"library attends over the 4250 tokens concatenated): "
                  + "; ".join(parts), flush=True)
            del c_, x_, gs, qs, stats, cat, jc, fwd, dq, dkv
            torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# K1, K3 and K4 above head dim 256 (the SD1 and SD3 VAEs' one-head mid
# attention at 512; every head dim 257 - 512 in every form): at WIDE_DIMS
# (264 and 300 run at width 384, 300 padded to 304 by the wrapper; 384 and
# 512 at their own) in the forms of WIDE_FORMS at WIDE_CASE (ragged on both
# sides), bf16 against the plain versions at the head-dims phase's
# tolerances (out 2e-2, lse 1e-3, each gradient 2e-2 of its largest), fp32
# against the plain versions in fp64, every error relative to the largest
# magnitude of what it measures and within WIDE_FP64_TOL (a kernel that
# rounded an operand to one TF32 pass would be ~1e-3 off, a wrong mask O(1));
# dbias written into a pool poisoned with NaNs. Then timed: K3 and K4 at the
# SD1 VAE's mid attention (WIDE_VAE_SHAPE) in both dtypes, and one masked
# (causal) K1, K3 and K4 shape at width 320 (WIDE_MASKED, 256 query tiles),
# each beside the plain version, one scaled_dot_product_attention (its
# backward: its whole one; TF32 off; the backend it ran named from its
# kernels) and the bound.
WIDE_DIMS = (264, 300, 384, 512)
WIDE_BWD_DESIGN = (
    "every head dim 257 - 512 in every mask form, at the padded widths 384 "
    "and 512, on a cluster of two blocks that split the head dim (bf16, TMA "
    "+ wgmma; a kernel for dq and one for dk / dv): a pair owns 64 rows, "
    "each block A1 / A2 resident at its DH = DP / 2 columns and B1 / B2 "
    "tiles of 32 rows on a ring of 3 - 4 stages; the partial X = A1 B1^T "
    "and Y = A2 B2^T (m64n32k16 SS) stored into the other block by "
    "st.async and added; dq: the two consumers take alternate tiles "
    "(ping-pong), the swap in two halves, dQ += dS K in RS form "
    "(m64nDHk16) and the consumers' dQ added at the end; dk / dv: both "
    "accumulators in the pair (S^T once a tile), consumer 0 X and dK += "
    "dS^T Q, consumer 1 Y and dV += P^T dO (m64nDHk16 SS from a swizzled T "
    "tile), the column tile's lse and delta staged once a tile; masks per "
    "launch (ANY; a tile without bias, segment ids or a partial position "
    "pair takes a plain loop), dbias written once a tile by block 0; fp32 "
    "the same roles and pairs on the streaming TF32 layout (four 32 KB "
    "slots, 64-column tiles, three passes, the transposed split terms of "
    "K, Q or dO)")
WIDE_CASE = (2, 2, 600, 520)
WIDE_FORMS = [(False, False, False), (True, False, False),
              (False, True, False), (False, False, True), (True, True, True)]
WIDE_FP64_TOL = 1e-5
WIDE_VAE_SHAPE = (1, 1, 4096, 4096, 512)
WIDE_MASKED = (1, 2, 4096, 4096, 320)


def wide_fp64_check(fa, q, k, v, g, masks, what):
    """fp32 K1, K3 and K4 against their plain versions in fp64 on one input
    (:data:`WIDE_FP64_TOL` of each output's largest magnitude; lse over the
    rows that see a key); the launches counted at the caller's head dim.
    Returns the largest errors by kernel."""
    import torch

    d = q.shape[-1]
    fns = (fa.flash_attention_cuda, fa.flash_attention_bwd_dq_cuda,
           fa.flash_attention_bwd_dkv_cuda)
    before = [fn.head_dims[d] for fn in fns]
    need_dbias = "bias" in masks
    out, lse = fa.flash_attention_cuda(q, k, v, **masks)
    if need_dbias:
        _poison(*q.shape[:3], k.shape[2])
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **masks,
                                        need_dbias=need_dbias)
    torch.cuda.synchronize()
    counted = all(fn.head_dims[d] == n + 1 for fn, n in zip(fns, before))
    m64 = dict(masks)
    if need_dbias:
        m64["bias"] = masks["bias"].double()
    x64 = [x.double() for x in (q, k, v)]
    o64, l64 = fa.flash_attention_plain(*x64, **m64)
    want = fa.flash_attention_bwd_plain(*x64, o64, l64, g.double(), **m64,
                                        need_dbias=need_dbias)
    seen = l64 > -1e29
    errs = dict(out=_rel_err(out, o64), lse=_rel_err(lse[seen], l64[seen]))
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), grads, want):
        errs[name] = _rel_err(a, w)
    finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, *grads))
    ok = finite and counted and max(errs.values()) <= WIDE_FP64_TOL
    print(f"wide heads: {what}: against fp64, of each largest: " + ", ".join(
        f"{n} {e:.2e}" for n, e in errs.items()) + f"; counted at d={d}: "
        f"{counted}", flush=True)
    check(ok, f"fp32 K1/K3/K4 off fp64 at {what}: {errs}, finite {finite}, "
          f"counted {counted}")
    return dict(K1=max(errs["out"], errs["lse"]),
                K3=max(errs["dq"], errs.get("dbias", 0.0)),
                K4=max(errs["dk"], errs["dv"]))


def sdpa_backend(run):
    """The scaled_dot_product_attention backend one ``run()`` took, named
    from the kernels it launched (profiler rows): flash, efficient (the
    memory-efficient cutlass kernels), cudnn, or math (GEMMs and a
    softmax); "not measured" where three profiled windows recorded no
    kernel row (the profiler drops one now and then)."""
    rows = []
    for _ in range(3):
        rows = profile_device(run, cpu=False)[4]
        if rows:
            break
    if not rows:
        return "not measured"
    names = " ".join(name.lower() for _, _, name in rows)
    for key, backend in (("flash", "flash"), ("cudnn", "cudnn"),
                         ("fmha", "efficient"), ("efficient", "efficient"),
                         ("mem_eff", "efficient")):
        if key in names:
            return backend
    return "math"


def phase_kernels_wide_heads(card, tail):
    """K1, K3 and K4 above head dim 256: every form of WIDE_FORMS at
    WIDE_DIMS in both dtypes against the plain versions, then timed at
    WIDE_VAE_SHAPE (K3, K4) and WIDE_MASKED (causal K1, K3, K4). Returns
    (largest error by kernel, the timed records by kernel)."""
    import torch
    import torch.nn.functional as F

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2700)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    errs = dict(K1=0.0, K3=0.0, K4=0.0)
    n_cases = 0
    for dtype in (bf16, fp32):
        dt = "bf16" if dtype == bf16 else "fp32"
        for d in WIDE_DIMS:
            for form in WIDE_FORMS:
                q, k, v, g, masks = head_dim_inputs(rnd, dtype, d, form,
                                                    WIDE_CASE)
                route = "/".join(r(dtype, d, *form) for r in (
                    fa.k1_route, fa.k3_route, fa.k4_route))
                what = (f"{dt} d={d} (width {fa._wide_width(d)}) "
                        f"{WIDE_CASE} causal={form[0]} bias={form[1]} "
                        f"segments={form[2]} ({route})")
                if dtype == bf16:
                    if form[1]:
                        _poison(*WIDE_CASE)
                    e = head_dim_check(fa, q, k, v, g, masks, what)
                else:
                    e = wide_fp64_check(fa, q, k, v, g, masks, what)
                for key in errs:
                    errs[key] = max(errs[key], e[key])
                n_cases += 1
                del q, k, v, g, masks
    print(f"wide heads: {n_cases} cases held (bf16 against the plain "
          f"versions, fp32 against fp64); largest errors {errs}", flush=True)

    sdpa = F.scaled_dot_product_attention
    records = dict(K1=[], K3=[], K4=[])
    # (products, Lq-like tensors, Lk-like tensors, row statistics)
    work = dict(K1=(2, 2, 2, 1), K3=(3, 3, 2, 2), K4=(4, 2, 4, 2))
    fams = dict(bf16=dict(K1="K1 flash fwd", K3="K3/K4 flash bwd wide",
                          K4="K3/K4 flash bwd wide"),
                fp32=dict(K1=F32_FWD, K3="K3/K4 fp32 flash bwd stream",
                          K4="K3/K4 fp32 flash bwd stream"))
    for (b, h, lq, lk, d), causal, kernels in (
            (WIDE_VAE_SHAPE, False, ("K3", "K4")),
            (WIDE_MASKED, True, ("K1", "K3", "K4"))):
        share = (sum(min(i + 1, lk) for i in range(lq)) / (lq * lk)
                 if causal else 1.0)
        for dtype in (bf16, fp32):
            dt = "bf16" if dtype == bf16 else "fp32"
            q, k, v, g, _ = head_dim_inputs(rnd, dtype, d, MASK_FORMS[0],
                                            (b, h, lq, lk))
            out, lse = fa.flash_attention_cuda(q, k, v, causal=causal)
            delta = (g.float() * out.float()).sum(-1)
            n, w = (3, 1) if dtype == fp32 else (10, 2)
            plain_fwd = cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=causal), 2, 1)
            plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, out, lse, g, causal=causal), 2, 1)
            lib_fwd = cuda_ms(lambda: sdpa(q, k, v, is_causal=causal), n, w)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            ol = sdpa(ql, kl, vl, is_causal=causal)
            lib_grad = lambda: torch.autograd.grad(ol, (ql, kl, vl), g,
                                                   retain_graph=True)
            lib_bwd = cuda_ms(lib_grad, n, w)
            backend = sdpa_backend(lib_grad)
            del ol, ql, kl, vl
            runs = dict(
                K1=lambda: fa.flash_attention_cuda(q, k, v, causal=causal),
                K3=lambda: fa.flash_attention_bwd_dq_cuda(
                    q, k, v, g, lse, delta, causal=causal),
                K4=lambda: fa.flash_attention_bwd_dkv_cuda(
                    q, k, v, g, lse, delta, causal=causal))
            line = []
            for kernel in kernels:
                run = runs[kernel]
                shape = (b, h, lq, lk, d, *work[kernel])
                if dtype == bf16:
                    p_, ql_, kl_, st_ = work[kernel]
                    flops = 2.0 * p_ * b * h * lq * lk * d * share
                    nbytes = b * h * (2.0 * d * (ql_ * lq + kl_ * lk)
                                      + 4.0 * st_ * lq)
                    bnd = dict(zip(("bound_ms", "bound_by"),
                                   bound(flops, nbytes)),
                               bound_basis="bf16 at 989 TFLOP/s")
                else:
                    bnd = tf32_bound(b, h, lq, lk, d, share, *work[kernel])
                fwd = kernel == "K1"
                times = dict(ms=cuda_ms(run, n, w),
                             plain_ms=plain_fwd if fwd else plain_bwd,
                             library_ms=lib_fwd if fwd else lib_bwd,
                             bound_ms=bnd["bound_ms"],
                             bound_by=bnd["bound_by"])
                device = (fp32_fwd_device_ms(run) if fwd and dtype == fp32
                          else dict(device_ms=kernel_device_ms(
                              run, fams[dt][kernel],
                              3 if dtype == fp32 else 10)))
                rec = dict(dtype=dt, shape=[b, h, lq, lk, d],
                           width=fa._wide_width(d), causal=causal,
                           route=fa.k1_route(dtype, d) if fwd else
                           fa.k3_route(dtype, d), visible_share=share,
                           bound_basis=bnd["bound_basis"],
                           library_backend=None if fwd else backend,
                           **times, **device)
                rec["bound_share"] = times["bound_ms"] / times["ms"]
                records[kernel].append(rec)
                line.append(f"{kernel} ({rec['route']}): {tail(**times)}, "
                            f"{100 * rec['bound_share']:.1f} % of the bound"
                            + "".join(f", {key.replace('_ms', '')} "
                                      f"{fmt_ms(val)}"
                                      for key, val in device.items()))
            pair = sum(r[-1]["ms"] for r in (records["K3"], records["K4"]))
            print(f"wide heads: timed {dt} (B,H,Lq,Lk,D)=({b},{h},{lq},{lk},"
                  f"{d}){' causal' if causal else ''} (plain and library "
                  f"backward: dq, dk and dv together; the library's "
                  f"backward on its {backend} backend): " + "; ".join(line)
                  + f"; K3 + K4 {pair:.4f} ms against the library's whole "
                  f"backward {lib_bwd:.4f} ms ({lib_bwd / pair:.2f} x)",
                  flush=True)
            del q, k, v, g, out, lse, delta
            torch.cuda.empty_cache()
    return errs, records


# ---------------------------------------------------------------------------
# K5, K6 and K7 above head dim 256 (every head dim 257 - 512 in every
# position form): bf16 K5 on K1's kernel of csrc/flash_attention.cu (the
# position predicate and the bounded flag in its ANY form, key splits merged
# by lse), K6 / K7 on the wide backward kernel, fp32 on the streaming TF32
# kernels. At WIDE_DIMS in the forms of WIDE_POS_FORMS at WIDE_CASE (ragged;
# the two segments of FORMS_POS cut off a multiple of 64), K5 online and
# bounded, K6 and K7 under the plain forward's lse: bf16 against the plain
# versions at the wide phase's bounds (out 2e-2, lse 1e-3 over the rows that
# see a key, each gradient 2e-2 of its largest), fp32 against the plain
# versions in fp64 within WIDE_FP64_TOL of each largest; the outputs
# allocated from a pool poisoned with NaNs, rows that see no key blank. Then
# the main path at full width: SD3-medium's joint attention (hidden 1536,
# 154 + 4096 tokens, batch 2) cut into heads of WIDE_JOINT_DIMS, through
# joint_flash_attention forward and backward(), bf16 and fp32, online and
# bounded, held to the plain joint attention (attention over the
# concatenated streams) and timed by kernel beside one
# scaled_dot_product_attention (TF32 off) and the bound; and the ring over a
# 4-shard mesh of the card at WIDE_RING_SHAPE (the parallel group's ring at
# heads of 512) against the one-device joint attention and the plain
# version, its hop kernels at (2, 3, 1063, 1063, 512) timed.
WIDE_POS_FORMS = {  # name -> (q offsets, k offsets, keywords)
    "none": ((0, 0), (0, 0), {}),
    "causal": ((0, 0), (0, 0), dict(causal=True)),
    "valid_len": ((0, 0), (0, 0), dict(valid_len=450)),
    "two segments": (FORMS_POS["q_off"], FORMS_POS["k_off"],
                     dict(causal=True, valid_len=FORMS_POS["valid_len"],
                          seg_q=FORMS_POS["seg_q"],
                          seg_k=FORMS_POS["seg_k"])),
}
WIDE_JOINT_DIMS = (384, 512)
WIDE_RING_SHAPE = (2, 3, 4252, 512)
WIDE_POS_FAMS = dict(bf16=("K1 flash fwd", "K3/K4 flash bwd wide",
                           "K3/K4 flash bwd wide"),
                     fp32=(F32_FWD, "K3/K4 fp32 flash bwd stream",
                           "K3/K4 fp32 flash bwd stream"))
WIDE_POS_DESIGN = (
    "every head dim 257 - 512 in every position form: bf16 K5 on K1's d512 "
    "kernel at the padded widths 384 and 512 (its ANY form: pos_pair per "
    "(64, 64) tile in every role, the per-logit mask on partly visible "
    "tiles, the bounded softmax a launch flag keeping the max at 0; key "
    "splits merged by lse, a split without a visible key weighing 0), K6 / "
    "K7 on the wide backward kernel under the caller's global lse and "
    "delta (64 rows a cluster pair splitting the head dim, pos_pair with "
    "the query and key tiles whichever axis the rows are, masked "
    "probabilities selected to 0; dk and dv in one pair); fp32 on the "
    "streaming TF32 kernels (the forward's kWideAny / kWideBounded at 384 "
    "and 512 with key splits, the streaming backward's pair in its ANY form "
    "reading the offsets, segments and valid_len)")


def wide_pos_check(fa, rnd, dtype, d, form):
    """K5 (online and bounded), K6 and K7 at head dim ``d`` in one form of
    WIDE_POS_FORMS at WIDE_CASE against the plain versions (fp64 ones for
    fp32 inputs), the outputs drawn from a NaN-poisoned pool; each launch
    counted on its route and at ``d``. Returns the errors by kernel (bf16:
    out and lse absolute, gradients of their largest; fp32: each of its
    largest) and whether the check held."""
    import torch

    bf16 = dtype == torch.bfloat16
    b, h, lq, lk = WIDE_CASE
    q_off, k_off, kw = WIDE_POS_FORMS[form]
    off = lambda a: torch.tensor(a, dtype=torch.int32, device="cuda")
    qo, ko = off(q_off), off(k_off)
    q, g = (rnd(b, h, lq, d).to(dtype) for _ in range(2))
    k, v = (rnd(b, h, lk, d).to(dtype) for _ in range(2))
    ins = [q, k, v] if bf16 else [x.double() for x in (q, k, v)]
    ref, ref_lse = fa.flash_attention_pos_plain(*ins, qo, ko, **kw)
    seen = ref_lse > -1e29
    lse32 = ref_lse.float().contiguous()
    delta = (g.double() * ref.double()).sum(-1)
    gw = g if bf16 else g.double()
    want = fa.flash_bwd_pos_plain(*ins, gw, lse32 if bf16 else ref_lse,
                                  delta.float() if bf16 else delta, qo, ko,
                                  **kw)
    fns = (fa.flash_attention_pos_cuda, fa.flash_bwd_pos_dq_cuda,
           fa.flash_bwd_pos_dkv_cuda)
    routes = [fa.k5_route(dtype, d), fa.k6_route(dtype, d),
              fa.k7_route(dtype, d)]
    before = [(fn.routes[r], fn.head_dims[d]) for fn, r in zip(fns, routes)]
    errs, blank = {}, True
    for stability in ("online", "bounded"):
        _poison(b, lq, h, d)
        out, lse = fa.flash_attention_pos_cuda(q, k, v, qo, ko,
                                               stability=stability, **kw)
        torch.cuda.synchronize()
        blank = blank and bool((lse[~seen] <= -1e29).all()) and not bool(
            out[~seen].any()) and bool(torch.isfinite(out).all())
        if bf16:
            errs["K5 " + stability] = max(
                (out.double() - ref.double())[seen].abs().max().item(),
                (lse.double() - ref_lse.double())[seen].abs().max().item())
            errs["K5 " + stability + " lse"] = (
                lse.double() - ref_lse.double())[seen].abs().max().item()
        else:
            errs["K5 " + stability] = max(
                _rel_err(out[seen], ref[seen]),
                _rel_err(lse[seen], ref_lse[seen]))
    _poison(b, lk, h, 2 * d)
    got = (fa.flash_bwd_pos_dq_cuda(q, k, v, g, lse32, delta.float(), qo,
                                    ko, **kw),
           *fa.flash_bwd_pos_dkv_cuda(q, k, v, g, lse32, delta.float(), qo,
                                      ko, **kw))
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    rel = [_rel_err(a, w) if finite else float("inf")
           for a, w in zip(got, want)]
    errs["K6"], errs["K7"] = rel[0], max(rel[1:])
    counted = [(fn.routes[r], fn.head_dims[d]) for fn, r in
               zip(fns, routes)] == [(n + m, c + m) for (n, c), m in
                                     zip(before, (2, 1, 1))]
    if bf16:
        ok = (errs["K5 online"] <= 2e-2 and errs["K5 bounded"] <= 2e-2
              and errs["K5 online lse"] <= 1e-3
              and errs["K5 bounded lse"] <= 1e-3
              and errs["K6"] <= 2e-2 and errs["K7"] <= 2e-2)
    else:
        ok = max(errs.values()) <= WIDE_FP64_TOL
    n_blank = int((~seen).sum())
    ok = ok and blank and counted
    return errs, ok, f"{'/'.join(routes)}, {n_blank} rows blank", blank, \
        counted


def _joint_inputs(rnd, dtype, d):
    """SD3-medium's joint attention cut into heads of ``d``: the six
    streams (B, H, L, d) and the cotangents of both outputs."""
    b, h = 2, SD3_HIDDEN // d
    xs = [rnd(b, h, n, d).to(dtype) for n in (154,) * 3 + (4096,) * 3]
    gs = [rnd(b, h, n, d).to(dtype) for n in (154, 4096)]
    return xs, gs


def _joint_pass(fa, xs, gs, stability):
    """One joint attention forward and backward() through autograd: the
    outputs and the six gradients."""
    import torch

    leaves = [x.detach().requires_grad_() for x in xs]
    oc, ox = fa.joint_flash_attention(*leaves, stability=stability)
    torch.autograd.backward((oc, ox), gs)
    return (oc.detach(), ox.detach()), [x.grad for x in leaves]


def phase_kernels_wide_pos(card, tail):
    """K5, K6 and K7 above head dim 256: every form of WIDE_POS_FORMS at
    WIDE_DIMS in both dtypes against the plain versions; SD3-medium's joint
    attention at heads of WIDE_JOINT_DIMS forward and backward in both
    dtypes and softmaxes (the launches counted from 0, one path a dtype)
    against the plain joint attention, then timed by kernel; the ring at
    WIDE_RING_SHAPE over 4 shards of the card (its own path). Returns
    (largest error by kernel, the records by kernel, the three paths'
    launches)."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.parallel.ring_attention import (
        ring_attention)

    gen = torch.Generator(device="cuda").manual_seed(2800)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    errs = dict(K5=0.0, K6=0.0, K7=0.0)
    records = dict(K5=[], K6=[], K7=[])
    n_cases = 0
    for dtype in (bf16, fp32):
        dt = "bf16" if dtype == bf16 else "fp32"
        for d in WIDE_DIMS:
            for form in WIDE_POS_FORMS:
                e, ok, said, blank, counted = wide_pos_check(fa, rnd, dtype,
                                                            d, form)
                what = (f"{dt} d={d} (width {fa._wide_width(d)}) "
                        f"{WIDE_CASE} {form}")
                print(f"wide pos: {what} ({said}): " + ", ".join(
                    f"{k} {x:.2e}" for k, x in e.items())
                    + f"; blank rows blank {blank}, counted {counted}",
                    flush=True)
                check(ok, f"K5/K6/K7 at {what} off their plain versions: "
                      f"{e}, blank {blank}, counted {counted}")
                for k, x in e.items():
                    kern = k.split()[0]
                    errs[kern] = max(errs[kern], x)
                n_cases += 1
    print(f"wide pos: {n_cases} cases held (K5 online and bounded, K6, K7; "
          f"bf16 against the plain versions, fp32 against fp64); largest "
          f"errors {errs}", flush=True)

    z = torch.zeros(2, dtype=torch.int32, device="cuda")
    runs = []
    for dtype in (bf16, fp32):
        dt = "bf16" if dtype == bf16 else "fp32"
        inputs = {d: _joint_inputs(rnd, dtype, d) for d in WIDE_JOINT_DIMS}
        # the path: the joint attention forward and backward at both widths
        # and softmaxes, the launches counted from 0
        reset_counts()
        got = {(d, st): _joint_pass(fa, *inputs[d], st)
               for d in WIDE_JOINT_DIMS for st in ("online", "bounded")}
        torch.cuda.synchronize()
        counts = read_counts()
        runs.append(counts)
        n = 4 * len(got)
        want_route = dict(K5="d512", K6="wide", K7="wide") if dtype == bf16 \
            else dict(K5="fp32", K6="fp32", K7="fp32")
        half = {d: n // 2 for d in WIDE_JOINT_DIMS}
        ok_counts = all(
            counts[k] == n and getattr(counts, k.lower() + "_routes") == {
                r: n} and getattr(counts, k.lower() + "_head_dims") == half
            for k, r in want_route.items()) and not any(
            counts[k] for k in ("K1", "K3", "K4"))
        print(f"wide pos: {dt} joint attention path, heads of "
              f"{WIDE_JOINT_DIMS} online and bounded, forward + backward: "
              f"launches {dict(counts)}, K5 {counts.k5_routes} "
              f"{counts.k5_head_dims}, K6 {counts.k6_routes}, K7 "
              f"{counts.k7_routes}", flush=True)
        check(ok_counts, f"{dt} wide joint attention launches: "
              f"{dict(counts)} {counts.k5_routes} {counts.k6_routes} "
              f"{counts.k7_routes} {counts.k5_head_dims}")
        for d in WIDE_JOINT_DIMS:
            xs, gs = inputs[d]
            b, h = xs[0].shape[:2]
            cat = [torch.cat([c, x], 2) for c, x in zip(xs[:3], xs[3:])]
            gcat = torch.cat(gs, 2)
            want_o, want_l = fa.flash_attention_plain(*cat)
            want_g = fa.flash_attention_bwd_plain(*cat, want_o, want_l, gcat)
            jc = joint_calls(fa, xs[:3], xs[3:], dict(c=gs[0], x=gs[1]), z)
            # the merged lse of the query streams (K5 online over their two
            # key streams, merged as the joint attention merges them)
            merged_l = torch.cat([jc["stats"][sq][0] for sq in ("c", "x")], 2)
            full = {}
            for st in ("online", "bounded"):
                outs, grads = got[(d, st)]
                e = full_width_errors(
                    (torch.cat(outs, 2), merged_l), (want_o, want_l),
                    [torch.cat([grads[i], grads[i + 3]], 2)
                     for i in range(3)], want_g)
                full[f"K5 {st} out"] = e["out"]
                if st == "online":
                    full["K5 merged lse"] = e["lse"]
                full["K6"] = max(full.get("K6", 0.0), e["dq"])
                full["K7"] = max(full.get("K7", 0.0), e["dk"], e["dv"])
            del want_o, want_l, want_g, merged_l
            # each stream pair's out and lse, both softmaxes, against the
            # plain K5; the plain calls' first run warms their timing below
            want_f = jc["plain_fwd"]()
            for st in ("online", "bounded"):
                for got_p, want_p in zip(jc["fwd"](st)(), want_f):
                    e = full_width_errors(got_p, want_p, (), ())
                    for part in ("out", "lse"):
                        key = f"K5 {st} pair {part}"
                        full[key] = max(full.get(key, 0.0), e[part])
            del want_f
            # bf16: the merged out (4250 keys, |out| ~ 0.02) within 4e-3,
            # each pair's out (154 keys give |out| ~ 0.1) within 2e-2, lse
            # within 1e-3, the gradients within 2e-2 of their largest
            tol = ({k_: 1e-3 if k_.endswith("lse") else 4e-3
                    if k_.endswith(" out") and "pair" not in k_ else 2e-2
                    for k_ in full} if dtype == bf16
                   else {k_: FP32_TOL for k_ in full})
            print(f"wide pos: {dt} SD3 joint attention, {h} heads of {d}, "
                  f"forward and backward() against the plain joint "
                  f"attention and each stream pair against the plain K5 "
                  f"({'merged out 4e-3, pair out 2e-2, lse 1e-3 absolute, gradients 2e-2 of their largest' if dtype == bf16 else f'fp32, TF32 off: out and lse within {FP32_TOL} absolute, gradients of their largest'}): "
                  + ", ".join(f"{k_} {x:.3e}" for k_, x in full.items()),
                  flush=True)
            check(all(full[k_] <= tol[k_] for k_ in full),
                  f"{dt} wide joint attention at heads of {d} off the plain "
                  f"joint attention: {full}")
            for k_, x in full.items():
                kern = k_.split()[0]
                errs[kern] = max(errs[kern], x)

            # each kernel over the four stream pairs, timed
            fwd, dq, dkv = jc["fwd"], jc["dq"], jc["dkv"]
            lib_f, lib_b = joint_library_ms(cat, gcat)
            pf = cuda_ms(jc["plain_fwd"], 1, 0)
            pb = cuda_ms(jc["plain_bwd"], 1, 0)
            torch.cuda.empty_cache()
            n_tok = 154 + 4096

            def bnd(n_p, n_q, n_k, n_s):
                if dtype == bf16:
                    return dict(zip(("bound_ms", "bound_by"), attn_bound(
                        b, h, n_tok, n_tok, d, n_p, n_q, n_k, n_s)),
                        bound_basis="bf16 at 989 TFLOP/s")
                return tf32_bound(b, h, n_tok, n_tok, d, 1.0, n_p, n_q, n_k,
                                  n_s)

            parts = []
            for kern, label, run, plain, lib, work, fam in (
                    ("K5", "online", fwd("online"), pf, lib_f, (2, 2, 2, 1),
                     WIDE_POS_FAMS[dt][0]),
                    ("K5", "bounded", fwd("bounded"), pf, lib_f,
                     (2, 2, 2, 1), WIDE_POS_FAMS[dt][0]),
                    ("K6", "", dq, pb, lib_b, (3, 3, 2, 2),
                     WIDE_POS_FAMS[dt][1]),
                    ("K7", "", dkv, pb, lib_b, (4, 2, 4, 2),
                     WIDE_POS_FAMS[dt][2])):
                bb = bnd(*work)
                n_it = 3 if dtype == fp32 else 5
                t = dict(ms=cuda_ms(run, n_it, 1), plain_ms=plain,
                         library_ms=lib, bound_ms=bb["bound_ms"],
                         bound_by=bb["bound_by"])
                dev = device_families(run, fam)
                t["device_ms"] = dev.get(fam)
                rec = dict(dtype=dt, shape=[b, h, n_tok, d],
                           width=fa._wide_width(d),
                           pairs="four stream pairs, 154 + 4096 tokens",
                           stability=label or None,
                           route=want_route[kern],
                           bound_basis=bb["bound_basis"],
                           launches_per_call=4, **t)
                rec["bound_share"] = t["bound_ms"] / t["ms"]
                records[kern].append(rec)
                parts.append(
                    f"{kern}{' ' + label if label else ''} "
                    f"({want_route[kern]}): "
                    + tail(**{k_: x for k_, x in t.items()
                              if k_ != "device_ms"})
                    + f", device {fmt_ms(t['device_ms'])}")
            print(f"wide pos: timed {dt} SD3 joint attention, {h} heads of "
                  f"{d} (B, H, Lc + Lx, D)=({b},{h},154+4096,{d}), four "
                  f"launches each over the stream pairs (the plain and "
                  f"library backward compute dq, dk, dv together; the "
                  f"library attends over the 4250 tokens concatenated): "
                  + "; ".join(parts), flush=True)
            del jc, fwd, dq, dkv, cat, gcat
            torch.cuda.empty_cache()
        del inputs, got
        gc.collect()
        torch.cuda.empty_cache()

    # the ring at heads of 512: a path of its own, then its hop kernels
    mesh = card_mesh()
    b, h, l, d = WIDE_RING_SHAPE
    V, lc = RING_VALID, RING_LC
    q, k, v, g = (rnd(b, h, l, d).to(bf16) for _ in range(4))
    g[:, :, V:] = 0          # the padded rows are sliced off: no gradient
    streams = lambda t: (t[:, :, :lc], t[:, :, lc:V])
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    reset_counts()
    out = ring_attention(*leaves, mesh, kv_valid_len=V)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    counts = read_counts()
    runs.append(counts)
    n2 = RING_N ** 2
    ok_counts = (counts["K5"] == counts["K6"] == counts["K7"] == n2
                 and counts.k5_routes == {"d512": n2}
                 and counts.k6_routes == {"wide": n2}
                 and counts.k7_routes == {"wide": n2}
                 and counts.k5_head_dims == {d: n2})
    check(ok_counts, f"the ring at d {d}: launches {dict(counts)} "
          f"{counts.k5_routes} {counts.k6_routes} {counts.k7_routes}")
    (qc, qx), (kc, kx), (vc, vx) = streams(q), streams(k), streams(v)
    jl = [t.detach().requires_grad_() for t in (qc, kc, vc, qx, kx, vx)]
    oc, ox = fa.joint_flash_attention(*jl)
    jg = torch.autograd.grad((oc, ox), jl, streams(g))
    joint = torch.cat([oc, ox], 2)
    joint_g = [torch.cat([jg[i], jg[i + 3]], 2) for i in range(3)]
    plain, plain_lse = fa.flash_attention_pos_plain(q, k, v, z, z,
                                                    valid_len=V)
    delta = (g.float() * plain.float()).sum(-1)
    plain_g = fa.flash_bwd_pos_plain(q, k, v, g, plain_lse, delta, z, z,
                                     valid_len=V)
    e_joint = (out[:, :, :V].float() - joint.float()).abs().max().item()
    e_plain = (out[:, :, :V].float() - plain[:, :, :V].float()).abs().max(
    ).item()
    check(e_joint <= 2e-2 and e_plain <= 2e-2,
          f"ring at d {d} forward off: joint {e_joint}, plain {e_plain}")
    check(all(float(t[:, :, V:].abs().max()) == 0.0 for t in grads[1:]),
          f"ring at d {d}: the padded keys got a gradient")
    mine = [t[:, :, :V] for t in grads]
    errs_joint = _grad_errors(f"ring at d {d} backward vs joint", mine,
                              joint_g)
    errs_plain = _grad_errors(f"ring at d {d} backward vs plain", mine,
                              [t[:, :, :V] for t in plain_g])
    errs["K5"] = max(errs["K5"], e_joint, e_plain)
    del jl, oc, ox, jg, joint, joint_g, plain, plain_g, leaves, grads
    gc.collect()
    ring_ms = cuda_ms(lambda: ring_attention(q, k, v, mesh, kv_valid_len=V),
                      3, 1)
    print(f"wide pos: ring attention (B,H,L,D)={WIDE_RING_SHAPE} bf16 over "
          f"{RING_N} shards of the card, kv_valid_len {V}: forward max|err| "
          f"against the joint attention {e_joint:.3e}, against plain "
          f"{e_plain:.3e} (atol 2e-2); backward against the joint attention "
          f"{errs_joint}, against plain {errs_plain}; launches forward + "
          f"backward {dict(counts)}, K5 {counts.k5_routes} K6 "
          f"{counts.k6_routes} K7 {counts.k7_routes}; forward "
          f"{ring_ms:.3f} ms a call [{card}]", flush=True)
    n_l = l // RING_N
    hop, errs_hop = hop_kernels(
        card, "the ring hop at d 512", q[:, :, :n_l], k[:, :, 3 * n_l:],
        v[:, :, 3 * n_l:], g[:, :, :n_l], (0, 0), (3 * n_l, 0), V,
        dict(launches_per_ring_call=n2), fams=WIDE_POS_FAMS["bf16"])
    print(f"wide pos: ring hop at d 512 errors: {errs_hop}", flush=True)
    for kern in ("K5", "K6", "K7"):
        records[kern].append(dict(hop[kern], dtype="bf16",
                                  route=fa.k5_route(bf16, d) if kern == "K5"
                                  else "wide", ring_fwd_ms=ring_ms))
    del out, q, k, v, g
    gc.collect()
    torch.cuda.empty_cache()
    return errs, records, runs


# The gradient through the SD1 VAE decoder at its operating point (latent
# 64^2 -> 512^2, batch 1; mid attention one head of 512 over 4096 tokens),
# random Flax-default weights from a seed, in fp32 (its default) and bf16:
# loss = <decoder(z), r> for a fixed random r, backward on the card. One K1,
# K3 and K4 at head dim 512 per pass. dz and the mid attention's parameter
# gradients are held to the same run with the flash CUDA entries swapped for
# their plain versions (here only: the main path has no switch), rel L2
# within VAE_GRAD_TOL of the dtype; a planted fault (dk and dv swapped) must
# be caught.
VAE_GRAD_LATENT = 64
VAE_GRAD_TOL = dict(fp32=1e-4, bf16=GRAD_REL_TOL)
VAE_GRAD_TIMED = 3


def phase_vae_grad(card):
    """SD1's VAEDecoder forward and backward at latent 64^2 in fp32 and in
    bf16 through K1, K3 and K4 at d = 512 (one launch each a pass, counted
    from 0), held to the plain flash versions and to a planted fault;
    backward ms by CUDA events. Returns the counts of the two passes (bf16,
    fp32), each a path of the kernels line."""
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.models.sd1 import (
        VAEDecoder)
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.sd1 import (
        _prepare, flax_default_init_)

    gen = torch.Generator(device="cuda").manual_seed(2701)
    with torch.device("meta"):
        module = VAEDecoder()
    base = flax_default_init_(module.to_empty(device="cuda"), gen)
    s = VAE_GRAD_LATENT
    z0 = torch.randn((1, s, s, 4), generator=gen, device="cuda")
    r = torch.randn((1, 8 * s, 8 * s, 3), generator=gen, device="cuda")
    mid = [n for n, _ in base.named_parameters() if n.startswith("mid_attn.")]
    runs = []
    for dt in ("bf16", "fp32"):
        import copy

        decoder = _prepare(copy.deepcopy(base), "cuda", dt)
        for p in decoder.parameters():
            p.requires_grad_(True)

        def grads():
            decoder.zero_grad(set_to_none=True)
            z = z0.clone().requires_grad_()
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            loss = (decoder(z).float() * r).sum()
            e[1].record()
            loss.backward()
            e[2].record()
            torch.cuda.synchronize()
            got = dict(z=z.grad.float())
            got.update((n, p.grad.float()) for n, p in
                       decoder.named_parameters() if n in mid)
            return loss.item(), got, e[0].elapsed_time(e[1]), \
                e[1].elapsed_time(e[2])

        grads()                                   # warm-up
        reset_counts()
        loss, got, fwd_ms, bwd_ms = grads()
        counts = read_counts()
        runs.append(counts)
        want_route = "fp32" if dt == "fp32" else None
        k1r = counts.k1_routes
        ok_counts = (counts["K1"] == counts["K3"] == counts["K4"] == 1
                     and counts.k1_head_dims == {512: 1}
                     and counts.k3_head_dims == {512: 1}
                     and counts.k4_head_dims == {512: 1}
                     and k1r == {want_route or "d512": 1}
                     and counts.k3_routes == {want_route or "wide": 1}
                     and counts.k4_routes == {want_route or "wide": 1})
        check(ok_counts, f"VAE grad {dt}: K1 / K3 / K4 launches at d = 512 "
              f"{dict(counts)} {k1r} {counts.k3_routes} {counts.k4_routes}"
              f" {counts.k1_head_dims}")
        times = [grads()[2:] for _ in range(VAE_GRAD_TIMED)]
        fwd_ms = sorted(t[0] for t in times)[VAE_GRAD_TIMED // 2]
        bwd_ms = sorted(t[1] for t in times)[VAE_GRAD_TIMED // 2]

        # the oracle: the same run with the flash CUDA entries swapped for
        # their plain versions
        saved = fa.flash_attention_cuda, fa.flash_attention_bwd_cuda

        def plain_fwd(q, k, v, scale=None, **masks):
            return fa.flash_attention_plain(q, k, v, scale, **masks)

        def plain_bwd(q, k, v, out, lse, g, scale=None, **masks):
            return fa.flash_attention_bwd_plain(q, k, v, out, lse, g, scale,
                                                **masks)

        fa.flash_attention_cuda = plain_fwd
        fa.flash_attention_bwd_cuda = plain_bwd
        try:
            ref_loss, ref, _, plain_bwd_ms = grads()
        finally:
            fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = saved
        tol = VAE_GRAD_TOL[dt]
        errs = {n: rel_l2(got[n], ref[n]) for n in ref}
        finite = all(bool(torch.isfinite(t).all()) for t in got.values())
        worst = max(errs, key=errs.get)
        print(f"VAE grad {dt}: SD1 VAEDecoder at latent {s}^2 -> "
              f"{8 * s}^2, loss {loss:.6e} (plain flash {ref_loss:.6e}); "
              f"K1 {dict(counts.k1_routes)} K3 {dict(counts.k3_routes)} K4 "
              f"{dict(counts.k4_routes)} at d {counts.k1_head_dims}, K2 "
              f"{counts['K2']}; forward {fwd_ms:.2f} ms, backward "
              f"{bwd_ms:.2f} ms (median of {VAE_GRAD_TIMED}; with the plain "
              f"flash versions {plain_bwd_ms:.2f} ms); rel L2 against the "
              f"plain versions: dz {errs['z']:.3e}, the mid attention's "
              f"{len(mid)} leaves worst {worst} {errs[worst]:.3e} (tol "
              f"{tol}) [{card}]", flush=True)
        check(finite and max(errs.values()) <= tol,
              f"VAE grad {dt}: off the plain versions: {errs}")

        # the control: dk and dv swapped at 512 must be caught
        bwd = fa.flash_attention_bwd_cuda

        def swap_dk_dv(q, k, v, out, lse, g, scale=None, **masks):
            dq, dk, dv = bwd(q, k, v, out, lse, g, scale, **masks)
            return dq, dv, dk

        fa.flash_attention_bwd_cuda = swap_dk_dv
        try:
            bad = grads()[1]
        finally:
            fa.flash_attention_bwd_cuda = bwd
        bad_errs = {n: rel_l2(bad[n], ref[n]) for n in ref}
        caught = max(bad_errs.values()) > tol
        worst_b = max(bad_errs, key=bad_errs.get)
        print(f"VAE grad {dt} control (dk/dv swapped at d = 512): worst "
              f"{worst_b} {bad_errs[worst_b]:.3e}: "
              f"{'caught' if caught else 'MISSED'}", flush=True)
        check(caught, f"VAE grad {dt}: missed the planted dk/dv swap")
        runs[-1].ms = dict(forward=fwd_ms, backward=bwd_ms,
                           backward_plain_flash=plain_bwd_ms)
        del decoder, got, ref, bad
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    return runs


def write_width_yaml(root, channel):
    """A tiny-SD YAML of TinySDConfig() changed only by ``channel`` (and
    its checkpoints under ``root``), as ``cli/tiny_sd.py --config`` reads
    it (``TinySDConfig.from_yaml``, PyYAML)."""
    import yaml

    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        TinySDConfig)

    raw = TinySDConfig(channel=channel,
                       model_dir=os.path.join(root, f"ckpt{channel}")).to_dict()
    path = os.path.join(root, f"tiny_sd_{channel}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def width_launch_check(what, counts, per_step, steps):
    """K1, K3 and K4 launched ``steps`` x the per-step count at each head
    dim of ``per_step`` and on the sm90 kernels (bf16)."""
    want = {d: n * steps for d, n in per_step.items()}
    check(counts.k1_head_dims == want,
          f"{what}: K1 by head dim {counts.k1_head_dims}, not {want}")
    for k in ("K3", "K4"):
        got = getattr(counts, k.lower() + "_head_dims")
        check(got == (want if counts[k] else {}),
              f"{what}: {k} by head dim {got}, not {want}")
    for k in ("K1", "K3", "K4"):
        routes = getattr(counts, k.lower() + "_routes")
        check(routes == ({"sm90": counts[k]} if counts[k] else {}),
              f"{what}: {k} did not take the sm90 kernels: {routes}")


def phase_tiny_sd_widths(card):
    """``DDPMTrainer`` at TinySDConfig() changed only by ``channel``, loaded
    from a YAML written here, for each of TINY_SD_WIDTHS (64^2, batch 32,
    bf16): train steps timed with their peak memory and the launches by
    head dim, one more under the profiler (device time by family); one
    step's loss and gradients against the same step through
    plain attention; a CFG sampling run of WIDTH_SAMPLE_T steps; two fp32
    steps against plain attention; at the first width one epoch of
    ``cli/tiny_sd.py train --config ... --synthetic``. Returns the paths'
    launch counts and, by width, the fp32 run's (launches, fp32
    launches)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from from_ddpm_to_stable_diffusion_tpu_torch.cli import tiny_sd as cli
    from from_ddpm_to_stable_diffusion_tpu_torch.io.data import (
        DataLoader, SyntheticImageDataset)
    from from_ddpm_to_stable_diffusion_tpu_torch.ops.schedules import (
        ddpm_tables)
    from from_ddpm_to_stable_diffusion_tpu_torch.pipelines.ddpm_trainer import (
        DDPMTrainer)
    from from_ddpm_to_stable_diffusion_tpu_torch.samplers.ddpm import ddpm_loss
    from from_ddpm_to_stable_diffusion_tpu_torch.utils.config import (
        TinySDConfig)

    root = tempfile.mkdtemp(prefix="tiny_sd_widths_")
    runs, fp32_runs = {}, {}
    try:
        for channel, per_step in TINY_SD_WIDTHS.items():
            path = write_width_yaml(root, channel)
            cfg = TinySDConfig.from_yaml(path)
            check(dataclasses.replace(cfg, model_dir="") == TinySDConfig(
                channel=channel, model_dir=""),
                f"the channel {channel} YAML read back as {cfg}")
            warm, timed = WIDTH_TRAIN_STEPS
            batch = cfg.batch_size
            while True:
                try:
                    loader = DataLoader(SyntheticImageDataset(
                        batch * (warm + timed), cfg.img_size, cfg.img_channel,
                        cfg.num_class, seed=cfg.seed), batch, seed=cfg.seed)
                    batches = list(loader)
                    trainer = DDPMTrainer(dataclasses.replace(
                        cfg, batch_size=batch), device="cuda")
                    state = trainer.create_state(len(loader))
                    reset_counts()
                    for images, labels in batches[:warm]:
                        state, loss = trainer.train_step(state, images,
                                                         labels)
                    torch.cuda.synchronize()
                    break
                except torch.cuda.OutOfMemoryError:
                    trainer = state = None
                    gc.collect()
                    torch.cuda.empty_cache()
                    check(batch > 1, f"channel {channel}: out of memory at "
                          f"batch 1")
                    print(f"tiny-SD channel {channel}: batch {batch} does "
                          f"not fit; halved", flush=True)
                    batch //= 2
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            losses = []
            start.record()
            for images, labels in batches[warm:]:
                state, loss = trainer.train_step(state, images, labels)
                losses.append(loss)
            end.record()
            torch.cuda.synchronize()
            step_ms = start.elapsed_time(end) / timed
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            counts = read_counts()
            losses = torch.stack(losses).float().cpu()
            # one more step under the profiler: device time by family
            state, busy = profile_steps(trainer, state, batches[-1:], card)
            print(f"tiny-SD channel {channel} (YAML {os.path.basename(path)}"
                  f"): {trainer.num_params(state)} params, batch {batch} at "
                  f"{cfg.img_size}^2, bf16: {step_ms:.2f} ms/step over "
                  f"{timed} steps (CUDA events), "
                  f"{1e3 * batch / step_ms:.1f} img/s, peak {peak:.2f} GiB, "
                  f"device idle share {1.0 - busy / step_ms:.3f} (1 - busy "
                  f"/ unprofiled step); losses "
                  f"{[round(x, 5) for x in losses.tolist()]}; K1 "
                  f"by head dim {counts.k1_head_dims}, K3 "
                  f"{counts.k3_head_dims}, K4 {counts.k4_head_dims} over "
                  f"{warm + timed} steps [{card}]", flush=True)
            check(bool(torch.isfinite(losses).all()),
                  f"channel {channel}: non-finite loss {losses}")
            width_launch_check(f"tiny-SD channel {channel} training",
                               counts, per_step, warm + timed)
            counts.step_ms, counts.peak_gib, counts.batch = (step_ms, peak,
                                                             batch)
            counts.busy_ms = busy
            runs[f"tiny_sd_w{channel}"] = counts

            # One step's loss and gradients, kernels against plain attention,
            # on the card, same weights, batch and draws (dropout off).
            model = state.model
            model.eval()
            rng = np.random.default_rng(channel)
            n, s = 8, cfg.img_size
            x0 = torch.from_numpy(rng.uniform(-1, 1, (n, s, s, 3)).astype(
                np.float32)).cuda()
            labels = torch.from_numpy(rng.integers(0, 4, n)).cuda()
            t = torch.from_numpy(rng.integers(0, cfg.T, n))
            noise = rng.standard_normal((n, s, s, 3)).astype(np.float32)
            tables = ddpm_tables(cfg.beta_1, cfg.beta_T, cfg.T)

            def loss_and_grads():
                model.zero_grad(set_to_none=True)
                loss = ddpm_loss(model, tables, x0, labels, cfg.T, t=t,
                                 noise=noise).sum() / (n * n)
                loss.backward()
                return loss.item(), torch.cat([
                    p.grad.float().flatten() for p in model.parameters()
                    if p.grad is not None])

            reset_counts()
            l_k, g_k = loss_and_grads()
            grad_counts = read_counts()
            with plain_attention_only():
                l_p, g_p = loss_and_grads()
            loss_rel = abs(l_k - l_p) / abs(l_p)
            grad_rel = rel_l2(g_k, g_p)
            print(f"tiny-SD channel {channel} gradient check (batch {n}, "
                  f"dropout off, bf16): loss {l_k:.6f} with the kernels, "
                  f"{l_p:.6f} through plain attention (rel {loss_rel:.3e}); "
                  f"gradient rel L2 {grad_rel:.3e} (tol {GRAD_REL_TOL}); K1 "
                  f"/ K3 / K4 {grad_counts['K1']} / {grad_counts['K3']} / "
                  f"{grad_counts['K4']} [{card}]", flush=True)
            check(loss_rel <= GRAD_REL_TOL and grad_rel <= GRAD_REL_TOL
                  and grad_counts["K3"] == sum(per_step.values()),
                  f"channel {channel}: kernels off plain attention: loss "
                  f"{loss_rel}, gradient {grad_rel}")
            del g_k, g_p
            model.zero_grad(set_to_none=True)

            # CFG sampling, one batch-8 forward a step
            sampler = DDPMTrainer(dataclasses.replace(
                cfg, T=WIDTH_SAMPLE_T), device="cuda")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images = sampler.sample(state, [1, 2, 3, 1])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            print(f"tiny-SD channel {channel} sampling: 4 images, "
                  f"T={WIDTH_SAMPLE_T}, CFG w={cfg.w}: {secs:.3f} s, "
                  f"{1e3 * secs / WIDTH_SAMPLE_T:.2f} ms/step, K1 by head "
                  f"dim {counts.k1_head_dims} [{card}]", flush=True)
            check(tuple(images.shape) == (4, s, s, 3) and bool(
                torch.isfinite(images).all()) and images.abs().max() <= 1,
                f"channel {channel}: samples {tuple(images.shape)} not "
                f"finite in [-1, 1]")
            width_launch_check(f"tiny-SD channel {channel} sampling",
                               counts, per_step, WIDTH_SAMPLE_T)
            runs[f"tiny_sd_w{channel}_sampling"] = counts
            del trainer, state, model, sampler, images
            gc.collect()
            torch.cuda.empty_cache()

            # two fp32 steps (the fp32 kernels at these head dims; the
            # second, warm, timed) against the same steps through plain
            # attention, at each width
            def build_fp32():
                c32 = dataclasses.replace(cfg, dtype="fp32")
                data = list(DataLoader(SyntheticImageDataset(
                    2 * c32.batch_size, c32.img_size, c32.img_channel,
                    c32.num_class, seed=c32.seed), c32.batch_size,
                    seed=c32.seed))
                tr = DDPMTrainer(c32, device="cuda")
                return (tr, tr.create_state(1),
                        lambda st, i: tr.train_step(st, *data[i]))

            fp32_run = fp32_train_pair(
                card, f"fp32 tiny-SD at channel {channel} (YAML), batch "
                f"{cfg.batch_size} at {cfg.img_size}^2", build_fp32, 2,
                dict(K1=6, K3=6, K4=6))
            fp32_counts = fp32_run[0]
            check(fp32_counts.k1_head_dims == {d: 2 * n for d, n in
                                               per_step.items()},
                  f"fp32 channel {channel}: K1 by head dim "
                  f"{fp32_counts.k1_head_dims}")
            print(f"fp32 tiny-SD channel {channel}: routes K1 "
                  f"{fp32_counts.k1_routes} K3 {fp32_counts.k3_routes} K4 "
                  f"{fp32_counts.k4_routes}; {fp32_counts.step_ms:.2f} ms "
                  f"the warm step [{card}]", flush=True)
            # every K3 / K4 launch of the fp32 steps on the TF32 kernels,
            # the wide head dims (160, 192) on the two-block ones
            for k in ("K3", "K4"):
                routes = getattr(fp32_counts, k.lower() + "_routes")
                check(routes == {"fp32": 12},
                      f"fp32 channel {channel}: {k} routes {routes}")
            fp32_runs[channel] = fp32_run
            if channel != min(TINY_SD_WIDTHS):
                continue

            # one epoch of the CLI from the YAML (8 batches of synthetic
            # images), in this process so that its launches are counted
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["train", "--config", path, "--synthetic",
                           "--epochs", "1"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            print(f"cli/tiny_sd.py train --config {os.path.basename(path)} "
                  f"--synthetic --epochs 1: exit {rc}, {secs:.2f} s (8 steps "
                  f"of batch {cfg.batch_size}, checkpoint written), K1 by "
                  f"head dim {counts.k1_head_dims} [{card}]", flush=True)
            check(rc == 0 and os.path.isdir(cfg.model_dir),
                  f"the tiny-SD CLI at channel {channel}: exit {rc}, no "
                  f"checkpoint under {cfg.model_dir}")
            width_launch_check(f"cli/tiny_sd.py at channel {channel}",
                               counts, per_step, 8)
            runs[f"tiny_sd_w{channel}_cli"] = counts
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs, fp32_runs


def main():
    marks = [("start", time.perf_counter())]

    def mark(group):
        """Seconds per group of phases, printed at the end: where the
        script's time limit goes."""
        marks.append((group, time.perf_counter()))

    card = phase_device()
    check_sass = phase_build()
    mark("build")
    kernels, tail = phase_kernels(card)
    check_sass()
    k1_launch_path(card, "after the kernel phase")
    kernels["K2 launch path us"] = dict(zip(
        ("wrapper", "c_entry", "kernel"),
        k2_launch_path(card, "after the kernel phase")))
    kernels_fp32 = phase_kernels_fp32(card, tail)
    mark("kernels")
    head_dim_errs, head_dim_timed = phase_kernels_head_dims(card, tail)
    for k, err in head_dim_errs.items():
        kernels[k]["err"] = max(kernels[k]["err"], err)
    every_form = phase_kernels_forms(card, tail)
    wide_errs, wide_timed = phase_kernels_wide_heads(card, tail)
    wide_pos_errs, wide_pos_timed, wide_pos_runs = phase_kernels_wide_pos(
        card, tail)
    for k, err in (*wide_errs.items(), *wide_pos_errs.items()):
        kernels[k]["err"] = max(kernels[k]["err"], err)
    mark("head_dims")
    vae_runs = phase_vae_grad(card)
    mark("vae_grad")
    kernels_ring = phase_kernels_ring(card)
    mark("parallel")
    import torch

    paths = ("sd1", "sd1_slice", "vae_grad_bf16", "vae_grad_fp32",
             "joint_wide_bf16", "joint_wide_fp32", "ring_d512", "sd1_tp",
             "sd1_trajectory", "serving", "sd1_cli", "sd1_768",
             "sd1_checkpoint", "sd1_int8",
             "sd3", "t5", "sd3_ring", "sd3_ulysses", "mmdit_pp",
             "mmdit_pp_1f1b", "sd3_tp", "sd3_tp_sp", "sd3_img2img",
             "sd3_tiled",
             "sd3_text", "sd3_checkpoint", "sd3_int8", "sd3_offload",
             "training", "sampling", "train_accum", "train_resume",
             "latent_training", "latent_sampling", "tiny_sd_w96",
             "tiny_sd_w96_sampling", "tiny_sd_w96_cli", "tiny_sd_w320",
             "tiny_sd_w320_sampling", "ddpm_fsdp",
             "mmdit_training", "mmdit_ring_training", "mmdit_tp_fsdp",
             "mmdit_tp_sp", "mmdit_tp_sp_ulysses", "mmdit_sampling",
             "mmdit_lora", "mmdit_moe_forward",
             "mmdit_moe_training", "vlm_training", "vlm_decoding", "vlm_checkpoint",
             "video_training", "video_sampling", "vae_vqvae", "vae_vanilla",
             "vit_training", "clip_forward", "clip_training", "fid",
             "dp_trainers",
             "sd1_fp32", "sd1_768_fp32", "sd3_fp32", "t5_fp32",
             "tiny_sd_w96_fp32", "tiny_sd_w320_fp32", "vlm_fp32",
             "tiny_sd_fp32", "mmdit_fp32", "mmdit_fp32_latent64",
             "clip_fp32", "checks")
    sd1_launches, sd1_models, sd1_image = phase_sd1(card)
    runs = [sd1_launches, phase_sd1_slice(card, sd1_models), *vae_runs,
            *wide_pos_runs]
    mark("sd1")
    kernels_tp = phase_kernels_tp(card)
    kernels_tp_sp = phase_kernels_tp_sp(card)
    runs.append(phase_tp_sd1(card, sd1_models))
    mark("tp_fsdp")
    runs.append(phase_trajectory(card, sd1_models, sd1_image))
    gc.collect()
    torch.cuda.empty_cache()
    mark("trajectory")
    runs += [phase_serving(card, sd1_models), phase_sd1_cli(card)]
    mark("serving")
    runs += [phase_sd1_768(card, sd1_models, SD1_768_STEPS, "bf16")[0],
             phase_checkpoint_sd1(card, sd1_models, sd1_image),
             phase_sd1_int8(card, sd1_models, sd1_image)]
    del sd1_models
    fp32_runs = phase_sd1_fp32(card)
    gc.collect()
    torch.cuda.empty_cache()
    mark("sd1_768_checkpoint_int8_fp32")
    sd3_runs, sd3_source = phase_sd3(card)
    runs += sd3_runs
    mark("sd3")
    runs += phase_parallel_sd3(card, sd3_source)
    mark("parallel")
    tp_sd3, sd3_ref = phase_tp_sd3(card, sd3_source)
    runs += [tp_sd3, phase_tp_sp_sd3(card, sd3_source, sd3_ref)]
    phase_tp_int8(card, sd3_source)
    mark("tp_fsdp")
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
    mark("sd3")
    trainer, state, train_launches, tiny_step = phase_training(card)
    runs.append(train_launches)
    phase_grad_check(card)
    runs.append(phase_sampling(card, trainer, state))
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    runs.append(phase_train_accum(card, tiny_step))
    runs.append(phase_train_resume(card))
    runs += phase_latent_training(card, tiny_step)
    gc.collect()
    torch.cuda.empty_cache()   # the serving bundles are gone: room to train
    mark("tiny_sd")
    width_runs, width_fp32 = phase_tiny_sd_widths(card)
    runs += list(width_runs.values())
    fp32_runs += [width_fp32[w] for w in sorted(width_fp32)]
    mark("tiny_sd_widths")
    runs.append(phase_ddpm_fsdp(card))
    mark("tp_fsdp")
    trainer, state, train_launches, mmdit_step = phase_mmdit_training(card)
    runs.append(train_launches)
    mark("mmdit")
    state, ring_launches = phase_mmdit_ring(card, trainer, state, mmdit_step)
    runs.append(ring_launches)
    mark("parallel")
    state, tp_launches = phase_tp_training(card, trainer, state, mmdit_step)
    runs.append(tp_launches)
    state, tp_sp_launches, tp_sp_ulysses = phase_tp_sp_training(
        card, trainer, state, mmdit_step)
    runs += [tp_sp_launches, tp_sp_ulysses]
    mark("tp_fsdp")
    phase_mmdit_grad_check(card)
    runs.append(phase_mmdit_sampling(card, trainer, state))
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    runs.append(phase_mmdit_lora(card, mmdit_step))
    gc.collect()
    torch.cuda.empty_cache()
    mark("mmdit")
    runs += phase_moe(card)
    mark("parallel")
    trainer, state, train_launches, _ = phase_vlm_training(card)
    runs.append(train_launches)
    phase_vlm_grad_check(card)
    runs.append(phase_vlm_decoding(card, trainer, state))
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    runs.append(phase_vlm_checkpoint(card))
    gc.collect()
    torch.cuda.empty_cache()
    mark("vlm")
    kernels_video = phase_kernels_video(card, tail)
    video_train, video_sample, _ = phase_video(card)
    runs += [video_train, video_sample]
    runs += phase_vae(card)[0]
    runs.append(phase_vit(card)[0])
    mark("zoo")
    fp32_runs += phase_train_fp32(card)
    mark("fp32_training")
    kernels_clip = phase_kernels_clip(card, tail)
    runs += [phase_clip_forward(card)[0], phase_clip_training(card)[0],
             phase_fid(card)[0]]
    fp32_runs.append(phase_clip_fp32(card))
    fp32_runs.append(phase_checks_cli(card))
    mark("clip_eval")
    gc.collect()
    torch.cuda.empty_cache()
    runs.append(phase_dp(card))
    mark("dp")
    phase_native(card)
    mark("native")
    seconds = {}     # a group may come back (parallel: four stretches)
    for (_, t0), (group, t1) in zip(marks, marks[1:]):
        seconds[group] = seconds.get(group, 0.0) + t1 - t0
    print("seconds by group of phases: " + json.dumps(
        {g: round(t, 1) for g, t in seconds.items()}), flush=True)
    runs += [counts for counts, _ in fp32_runs]
    check(len(runs) == len(paths), f"{len(runs)} path runs for "
          f"{len(paths)} path names")
    fp32_by_path = dict(zip(paths[-len(fp32_runs):],
                            (fp32 for _, fp32 in fp32_runs)))
    pkg = "from_ddpm_to_stable_diffusion_tpu_torch/csrc/"
    from from_ddpm_to_stable_diffusion_tpu_torch.ops import flash_attention as fa

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

    def head_dim_record(k):
        """K1's, K3's or K4's records at the head dims of
        HEAD_DIM_TIMED and its launches by head dim over the paths."""
        per_dim = {}
        for p, run in zip(paths, runs):
            for d, n in getattr(run, k.lower() + "_head_dims", {}).items():
                per_dim.setdefault(d, {})[p] = n
        rec = dict(
            timed=head_dim_timed[k],
            launches_by_head_dim={d: dict(launches=sum(v.values()),
                                          launches_by_path=v)
                                  for d, v in sorted(per_dim.items())})
        if k == "K1":   # fp32 above 160: the streaming TF32 forward
            rec["fp32_wide"] = dict(
                source=pkg + "fp32/flash_f32_fwd_wide.cuh",
                kernel="flash_fwd_f32_wide_kernel",
                widths=[192, 224, 256],
                fp64_err_by_head_dim=head_dim_timed["fp64_fwd"],
                instantiated_in=[pkg + f"fp32/flash_f32_fwd_w{w}.cu"
                                 for w in (192, 224, 256)])
            rec["any_form_timed"] = head_dim_timed["K1_any"]
        else:           # fp32 above 128: the two-block TF32 kernels
            rec["fp32_wide"] = dict(
                source=pkg + "fp32/flash_f32_bwd.cuh",
                kernel=("flash_bwd_dq_f32_wide_kernel" if k == "K3"
                        else "flash_bwd_dkv_f32_wide_kernel"),
                widths=[160, 192, 224, 256],
                fp64_err_by_head_dim=head_dim_timed["fp64"],
                instantiated_in=[pkg + f"fp32/flash_f32_bwd_w{w}.cu"
                                 for w in (160, 192, 224, 256)])
        return rec

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
                 "sd3_checkpoint", "sd3_int8", "sd3_offload", "sd3_tp",
                 "sd3_tp_sp", "mmdit_training", "mmdit_tp_fsdp",
                 "mmdit_tp_sp", "mmdit_tp_sp_ulysses", "mmdit_sampling",
                 "mmdit_lora",
                 "sd3_ring", "sd3_ulysses", "mmdit_pp", "mmdit_pp_1f1b",
                 "mmdit_ring_training", "mmdit_moe_forward",
                 "mmdit_moe_training"):
            for k in ("K5", "K6", "K7"):
                r = getattr(run, k.lower() + "_routes")
                check(r == ({"sm90": run[k]} if run[k] else {}),
                      f"{p}: {k}'s bf16 launches did not all take the sm90 "
                      f"kernel: {r}")
    # the bf16 training paths: every K3 / K4 launch on its sm90 kernel
    for p, run in zip(paths, runs):
        if p in ("training", "train_accum", "train_resume",
                 "latent_training", "ddpm_fsdp", "vlm_training",
                 "vlm_checkpoint", "video_training"):
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
              design=("bf16 at every head dim from 1 to 256 (padded widths "
                      "16 - 256) in every mask form: one block of 3 "
                      "warpgroups per 128 queries, "
                      "a producer issuing TMA (Q once, K/V tiles of 128 keys "
                      "in a 2-stage mbarrier ring, the bias tile staged in "
                      "its own dtype by cp.async) and two consumers running "
                      "wgmma m64n128k16 for S = QK^T from shared memory, "
                      "the online softmax in registers, and wgmma in RS "
                      "form for O += PV with V MN-major; 128-byte swizzle "
                      "where DP is a multiple of 64, 32-byte otherwise; "
                      "64-key tiles above DP 160 (above 128 in a masked "
                      "form)"),
              head_dims=head_dim_record("K1"),
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
              wide_heads=dict(
                  source=pkg + "flash_attention.cu",
                  fp32_source=pkg + "fp32/flash_f32_fwd_wide.cuh",
                  widths=list(fa._WIDE_WIDTHS),
                  design=("every head dim 257 - 512 in every mask form: the "
                          "d512 kernel at the padded widths 384 and 512 "
                          "(columns past d read as TMA's zeros), causal / "
                          "bias / segment ids chosen per launch (ANY), the "
                          "bias read from global memory, key splits merged "
                          "by lse with weight 0 for a split a row sees no "
                          "key of; fp32 the streaming TF32 kernel at 384 "
                          "and 512 in its no-mask, causal and ANY forms"),
                  timed=wide_timed["K1"]),
              d160=dict(
                  design=("bf16 and fp32 at head dim 160 (SD1's UNet at "
                          "level 2 from 768^2): the sm90 kernel with 32-byte "
                          "swizzle atoms of 16 columns and O += PV as "
                          "m64n160k16 RS; in fp32 the TF32 kernel with one "
                          "consumer and 64-query blocks, PV in two halves of "
                          "80 columns"),
                  timed=kernels["d160"], **by_head_dim(160)),
              d8=dict(
                  design=("fp32 at head dim 8 (the checks sd1 UNet, "
                          "SD1UNet(model_channels=64) with 8 heads, at its "
                          "32^2 level): the TF32 kernel with a 32-byte "
                          "swizzle chunk of 8 columns, S = QK^T in one k-step "
                          "of 3 SS wgmmas m64n64k8 a 64-key tile, PV as 3 x 8 "
                          "RS wgmmas m64n8k8; bound by the exponentials"),
                  timed=[r for r in kernels_fp32["K1"]
                         if r.get("form") == "d8"], **by_head_dim(8)),
              timed_at="(B,H,Lq,Lk,D)=(2,8,4096,4096,40)",
              tp_shard=kernels_tp["K1"],
              library="F.scaled_dot_product_attention", forms=forms_of("K1"),
              every_form=every_form["K1"],
              video=kernels_video["K1"],
              clip=kernels_clip["K1"]),
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
              library="F.group_norm + F.silu", video=kernels_video["K2"]),
        entry("flash_attention_bwd_dq", "flash_attention_dq_sm90.cu",
              "flash_attention.py:682", "K3", plain_computes=together,
              library_computes=together,
              design=("bf16 at every head dim from 1 to 256 in every form: "
                      "one block of 3 warpgroups per 128 queries, a producer "
                      "issuing TMA (Q and dO once, K and V tiles of 64 keys "
                      "(32 above DP 192) in a 2-stage mbarrier ring, the "
                      "bias tile staged by "
                      "cp.async) and two consumers of 64 queries with their "
                      "lse and delta in registers computing S = QK^T and "
                      "dP = dOV^T (wgmma m64n64k16 SS), P and dS in "
                      "registers, dS the RS A operand of dQ += dS K with K "
                      "read MN-major from the same tile; dQ in registers "
                      "until the end"),
              head_dims=head_dim_record("K3"),
              sm90=by_route("sm90", "k3"),
              wide=dict(
                  source=pkg + "flash_attention_wide_bwd_sm90.cuh",
                  fp32_source=pkg + "fp32/flash_f32_bwd_stream.cuh",
                  widths=list(fa._WIDE_WIDTHS),
                  design=WIDE_BWD_DESIGN, timed=wide_timed["K3"],
                  vae_grad_ms=dict(bf16=vae_runs[0].ms, fp32=vae_runs[1].ms),
                  **by_route("wide", "k3")),
              timed_at="(B,H,Lq,Lk,D)=(32,1,4096,4096,128)",
              library="backward of F.scaled_dot_product_attention",
              forms=forms_of("K3"), every_form=every_form["K3"],
              video=kernels_video["K3"],
              clip=kernels_clip["K3"]),
        entry("flash_attention_bwd_dkv", "flash_attention_bwd_sm90.cu",
              "flash_attention.py:764", "K4", plain_computes=together,
              library_computes=together,
              design=("bf16 at every head dim from 1 to 256 in every form: "
                      "one block of 3 warpgroups per 128 keys, a producer "
                      "issuing TMA "
                      "(K and V once, Q and dO tiles of 64 queries in a "
                      "2-stage mbarrier ring, lse and delta stored beside "
                      "them, the bias tile staged by cp.async) and two "
                      "consumers of 64 keys computing S^T = KQ^T and dP^T = "
                      "VdO^T with the keys as wgmma's M (m64n64k16 SS), P^T "
                      "and dS^T in registers as the A operand of dV += "
                      "P^T dO and dK += dS^T Q (wgmma RS, dO and Q "
                      "MN-major); above DP 128 two blocks per key tile, "
                      "each with half of dK's and dV's columns, and query "
                      "tiles of 32"),
              head_dims=head_dim_record("K4"),
              sm90=by_route("sm90", "k4"),
              wide=dict(
                  source=pkg + "flash_attention_wide_bwd_sm90.cuh",
                  fp32_source=pkg + "fp32/flash_f32_bwd_stream.cuh",
                  widths=list(fa._WIDE_WIDTHS),
                  design=WIDE_BWD_DESIGN, timed=wide_timed["K4"],
                  vae_grad_ms=dict(bf16=vae_runs[0].ms, fp32=vae_runs[1].ms),
                  **by_route("wide", "k4")),
              timed_at="(B,H,Lq,Lk,D)=(32,1,4096,4096,128)",
              library="backward of F.scaled_dot_product_attention",
              forms=forms_of("K4"), every_form=every_form["K4"],
              video=kernels_video["K4"],
              clip=kernels_clip["K4"]),
        entry("flash_attention_fwd_pos", "flash_attention_sm90.cu",
              "flash_attention.py:1237", "K5",
              design=("bf16 at every head dim from 1 to 256 (K1's padded "
                      "widths), online and bounded: "
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
                      "visible; the bounded form fixes the max at 0; one Q "
                      "buffer where two do not fit beside the ring (DP 160, "
                      "240, 256)"),
              sm90=by_route("sm90", "k5"),
              wide_heads=dict(
                  source=pkg + "flash_attention.cu", fp32_source=pkg + "fp32/flash_f32_fwd_wide.cuh",
                  widths=list(fa._WIDE_WIDTHS), design=WIDE_POS_DESIGN,
                  timed=wide_pos_timed["K5"],
                  **by_route("d512", "k5")), shapes=kernels["K5 shapes"],
              every_form=every_form["K5"],
              ring=kernels_ring["K5"], ring_call=kernels_ring["call"],
              tp_shard=kernels_tp["K5"], tp_sp_hop=kernels_tp_sp["K5"],
              timed_at="(B,H,Lq,Lk,D)=(2,24,4096,4096,64) online",
              library="F.scaled_dot_product_attention"),
        entry("flash_attention_bwd_pos_dq", "flash_attention_dq_sm90.cu",
              "flash_attention.py:1446", "K6", plain_computes=together,
              library_computes=together,
              design=("bf16 at every head dim from 1 to 256 (K3's padded "
                      "widths): the position-mask form "
                      "of K3's kernel (one block of 3 warpgroups per 128 "
                      "queries, a producer issuing TMA for Q and dO once "
                      "and K and V tiles of 64 keys in a 2-stage ring; two "
                      "consumers of 64 queries with the caller's global "
                      "lse and delta in registers computing S and dP with "
                      "wgmma m64n64k16 SS, dS in registers as the RS A "
                      "operand of dQ += dS K with K MN-major); every role "
                      "skips the same pairs from their position bounds, "
                      "masked P selected to 0"),
              sm90=by_route("sm90", "k6"),
              wide_heads=dict(
                  source=pkg + "flash_attention_wide_bwd_sm90.cuh", fp32_source=pkg + "fp32/flash_f32_bwd_stream.cuh",
                  widths=list(fa._WIDE_WIDTHS), design=WIDE_POS_DESIGN,
                  timed=wide_pos_timed["K6"],
                  **by_route("wide", "k6")), shapes=kernels["K6"]["shapes"],
              every_form=every_form["K6"],
              ring=kernels_ring["K6"], tp_sp_hop=kernels_tp_sp["K6"],
              timed_at="(B,H,Lq,Lk,D)=(2,24,4096,4096,64), global lse",
              library="backward of F.scaled_dot_product_attention"),
        entry("flash_attention_bwd_pos_dkv", "flash_attention_bwd_sm90.cu",
              "flash_attention.py:1504", "K7", plain_computes=together,
              library_computes=together,
              design=("bf16 at every head dim from 1 to 256 (K4's padded "
                      "widths; above 128 on K4's one-block-a-64-key-tile "
                      "body): the position-mask form "
                      "of K4's kernel (one block of 3 warpgroups per 128 "
                      "keys, a producer issuing TMA for K and V once and Q "
                      "and dO tiles of 64 queries in a 2-stage ring, the "
                      "caller's global lse and delta stored beside them; "
                      "two consumers of 64 keys computing S^T and dP^T with "
                      "the keys as wgmma's M, P^T and dS^T in registers as "
                      "the RS A operand of dV += P^T dO and dK += dS^T Q); "
                      "every role skips the same pairs from their position "
                      "bounds, masked P selected to 0"),
              sm90=by_route("sm90", "k7"),
              wide_heads=dict(
                  source=pkg + "flash_attention_wide_bwd_sm90.cuh", fp32_source=pkg + "fp32/flash_f32_bwd_stream.cuh",
                  widths=list(fa._WIDE_WIDTHS), design=WIDE_POS_DESIGN,
                  timed=wide_pos_timed["K7"],
                  **by_route("wide", "k7")), shapes=kernels["K7"]["shapes"],
              every_form=every_form["K7"],
              ring=kernels_ring["K7"], tp_sp_hop=kernels_tp_sp["K7"],
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
    if sys.argv[1:2] == ["sd3_batch_levels"]:
        sd3_batch_levels(int(sys.argv[2]) if len(sys.argv) > 2 else 4)
    else:
        main()
