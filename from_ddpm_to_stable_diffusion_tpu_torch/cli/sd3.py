"""Stage-02 CLI: SD3 text→image generation and MMDiT training on the card
(port of ``cli/sd3.py``).

``generate`` keeps the 02_stable_diffusion-3/01_check.py operating point
(1024×1024, 50 steps, CFG 5, shift 3.0, seed 1). With --ckpt the model
groups load from safetensors (the MMDiT config sniffed from the file);
without, a scaled-down random-weight bundle runs a smoke test. Tokenizers:
--vocab/--merges for the CLIP pair, --spm for the T5 SentencePiece model;
without files the prompt becomes placeholder ids drawn from
``hash(prompt)``, which Python salts per process (``PYTHONHASHSEED``).
``train`` runs ``MMDiTTrainer`` on synthetic latents over a data mesh of
the --device, with LoRA, gradient accumulation and --moe-experts. ``generate --sp N --sp-impl ring|ulysses``
runs the MMDiT's joint attention sequence-parallel over a ``seq`` mesh of
the first N visible devices (N must not exceed them, as in the JAX CLI).
``generate --tp N`` serves tensor-parallel over a ``model`` mesh of the
first N visible devices; ``train --tp N`` trains over the JAX CLI's hybrid
{"data": n // N, "model": N} mesh of the n visible devices, and ``--fsdp``
stores the train state sharded over ``data``. On a host with too few
devices the mesh raises the JAX mesh-shape ``ValueError``. Images are
written by the port's stdlib PNG encoder; only --init-image reads one,
through Pillow.
"""

from __future__ import annotations

import argparse
import sys

from ..parallel.mesh import build_mesh, visible_devices


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sd3")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate")
    g.add_argument("--prompt", required=True)
    g.add_argument("--neg-prompt", default="")
    g.add_argument("--prompt-weighting", action="store_true",
                   help="honor the (text:w) attention syntax on the CLIP "
                        "streams (needs --vocab/--merges)")
    g.add_argument("--width", type=int, default=1024)
    g.add_argument("--height", type=int, default=1024)
    g.add_argument("--steps", type=int, default=50)
    g.add_argument("--sampler", choices=("euler", "heun"), default="euler",
                   help="heun: 2nd-order flow sampler (2 model calls/step)")
    g.add_argument("--cfg-scale", type=float, default=5.0)
    g.add_argument("--shift", type=float, default=3.0)
    g.add_argument("--seed", type=int, default=1)
    g.add_argument("--ckpt", default=None, help="sd3 .safetensors path")
    g.add_argument("--clip-l", default=None,
                   help="CLIP-L text encoder .safetensors")
    g.add_argument("--clip-g", default=None,
                   help="CLIP-G text encoder .safetensors")
    g.add_argument("--t5", default=None, help="T5-XXL .safetensors")
    g.add_argument("--vocab", default=None, help="CLIP vocab.json")
    g.add_argument("--merges", default=None, help="CLIP merges.txt")
    g.add_argument("--spm", default=None,
                   help="T5 SentencePiece model file (spiece.model)")
    g.add_argument("--int8", action="store_true",
                   help="W8A8 int8 MMDiT+T5 projections")
    g.add_argument("--offload-text-encoders", action="store_true",
                   help="free CLIP/T5 device memory after conditioning")
    g.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel serving over N devices (shards "
                        "MMDiT/CLIP/T5 kernels on the model mesh axis)")
    g.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel MMDiT joint attention over the "
                        "first N visible devices (ring K/V rotation or "
                        "Ulysses all-to-all); exclusive with --tp")
    g.add_argument("--sp-impl", choices=("ring", "ulysses"),
                   default="ring")
    g.add_argument("--init-image", default=None,
                   help="img2img: init image path (resized to "
                        "width×height, VAE-encoded, partially denoised)")
    g.add_argument("--strength", type=float, default=0.8,
                   help="img2img denoise strength in (0,1]")
    g.add_argument("--save-trajectory", action="store_true",
                   help="also save a grid of per-step latent RGB previews")
    g.add_argument("--out", default="sd3_out.png")
    g.add_argument("--device", default="cuda",
                   help="torch device of the model bundle")

    t = sub.add_parser(
        "train", help="rectified-flow-train an MMDiT on synthetic latent / "
        "conditioning data")
    t.add_argument("--depth", type=int, default=2)
    t.add_argument("--img-size", type=int, default=16,
                   help="LATENT spatial size")
    t.add_argument("--context-len", type=int, default=8)
    t.add_argument("--context-dim", type=int, default=64)
    t.add_argument("--adm", type=int, default=64)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--steps", type=int, default=20)
    t.add_argument("--dtype", choices=("fp32", "bf16"), default="bf16")
    t.add_argument("--fsdp", action="store_true",
                   help="store the train state ZeRO-sharded over data")
    t.add_argument("--tp", type=int, default=1,
                   help="hybrid data×model mesh (heads must divide)")
    t.add_argument("--lora-rank", type=int, default=None,
                   help="freeze the base, train rank-r adapters only")
    t.add_argument("--moe-experts", type=int, default=None,
                   help="sparse MMDiT: Switch-MoE block MLPs with E "
                        "experts")
    t.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches averaged per optimizer update")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", default="cuda",
                   help="torch device of the trainer")

    args = ap.parse_args(argv)
    if args.tp > 1 and getattr(args, "sp", 1) > 1:
        ap.error("--tp and --sp are mutually exclusive")

    if args.cmd == "train":
        return _train(args)

    import numpy as np
    import torch

    from ..ops.image import write_png
    from ..pipelines.sd3 import SD3Inferencer, SD3Models

    device = torch.device(args.device)
    mesh = seq_mesh = None
    if args.tp > 1:
        mesh = build_mesh({"model": args.tp},
                          visible_devices(device.type)[:args.tp])
    if args.sp > 1:
        seq_mesh = build_mesh({"seq": args.sp},
                              visible_devices(device.type)[:args.sp])
    if args.ckpt:
        print(f"[sd3] loading checkpoints: {args.ckpt}", file=sys.stderr)
        models = SD3Models.from_checkpoints(
            args.ckpt, clip_l_path=args.clip_l, clip_g_path=args.clip_g,
            t5_path=args.t5, device=device)
    else:
        print("[sd3] no --ckpt: scaled-down random weights (smoke-test "
              "mode)", file=sys.stderr)
        models = SD3Models.initialize(torch.Generator(device).manual_seed(0),
                                      device, depth=4,
                                      pos_embed_max_size=96, with_t5=False)
    if args.int8:
        print("[sd3] quantizing MMDiT/T5 projections to int8 (W8A8)",
              file=sys.stderr)
        models.quantize_int8()
    if seq_mesh is not None:
        models.mmdit.set_attention(args.sp_impl, seq_mesh)

    tokenizer = None
    if args.vocab and args.merges:
        from ..io.spm_tokenizer import SD3Tokenizer, T5XXLTokenizer
        from ..io.tokenizer import CLIPTokenizer

        clip_tok = CLIPTokenizer.from_files(args.vocab, args.merges)
        if args.spm:
            t5_tok = T5XXLTokenizer.from_file(args.spm)
        else:
            # no spiece.model: T5 sees only the empty-prompt tokens
            from ..io.spm_tokenizer import (CONTROL, UNKNOWN,
                                            SentencePieceUnigram)

            t5_tok = T5XXLTokenizer(SentencePieceUnigram(
                [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
                 ("<unk>", 0.0, UNKNOWN)]))
        tokenizer = SD3Tokenizer(clip_tok, t5_tok)

    inf = SD3Inferencer(models, shift=args.shift, tokenizer=tokenizer,
                        mesh=mesh)
    kwargs = dict(width=args.width, height=args.height, steps=args.steps,
                  cfg_scale=args.cfg_scale, seed=args.seed,
                  offload_text_encoders=args.offload_text_encoders,
                  keep_trajectory=args.save_trajectory,
                  sampler=args.sampler)
    if args.init_image:
        from PIL import Image

        raw = np.asarray(Image.open(args.init_image).convert("RGB").resize(
            (args.width, args.height)), np.float32)
        kwargs["init_image"] = (raw / 255.0 * 2.0 - 1.0)[None]
        kwargs["denoise_strength"] = args.strength

    if tokenizer is not None:
        out = inf.gen_image_text(args.prompt, args.neg_prompt,
                                 prompt_weighting=args.prompt_weighting,
                                 **kwargs)
    else:
        print("[sd3] no tokenizer files: placeholder token ids (smoke-test "
              "plumbing only)", file=sys.stderr)
        rng = np.random.default_rng(abs(hash(args.prompt)) % 2**32)
        clip_tokens = rng.integers(0, 49408, (1, 77)).astype(np.int32)
        neg_tokens = np.zeros((1, 77), np.int32)
        out = inf.gen_image(clip_tokens, neg_clip_tokens=neg_tokens,
                            **kwargs)

    if args.save_trajectory:
        from ..ops.image import image_grid

        img, previews = out
        traj_path = args.out.rsplit(".", 1)[0] + "_trajectory.png"
        write_png(traj_path, image_grid(previews, min(len(previews), 10)))
        print(f"wrote {traj_path}")
    else:
        img = out
    write_png(args.out, img[0])
    print(f"wrote {args.out}")
    return 0


def _train(args):
    import numpy as np
    import torch

    from ..models.mmdit import MMDiTConfig
    from ..pipelines.mmdit_trainer import MMDiTTrainer
    from ..utils.config import FlowTrainConfig

    # the trainer's data mesh, here over the one device (a data axis over
    # several cards runs as a process group, one rank a card); with --tp
    # the JAX CLI's hybrid mesh over the visible devices
    mesh = build_mesh(None, [args.device])
    if args.tp > 1:
        devices = visible_devices(torch.device(args.device).type)
        data = max(len(devices) // args.tp, 1)
        mesh = build_mesh({"data": data, "model": args.tp},
                          devices[:data * args.tp])
    mcfg = MMDiTConfig(patch_size=2, in_channels=16, depth=args.depth,
                       adm_in_channels=args.adm,
                       context_dim=args.context_dim,
                       pos_embed_max_size=max(args.img_size // 2, 8),
                       moe_experts=args.moe_experts)
    cfg = FlowTrainConfig(epoch=2, batch_size=args.batch_size,
                          img_size=args.img_size,
                          context_len=args.context_len, warmup_epochs=1,
                          dtype=args.dtype, seed=args.seed,
                          grad_accum=args.grad_accum)
    trainer = MMDiTTrainer(mcfg, cfg, device=args.device, mesh=mesh,
                           fsdp=args.fsdp, lora_rank=args.lora_rank)
    state = trainer.create_state(
        steps_per_epoch=max(args.steps // cfg.epoch, 1))
    kind = f"LoRA r={args.lora_rank} adapters" if args.lora_rank else "params"
    print(f"[sd3 train] MMDiT depth={args.depth} "
          f"({trainer.num_params(state):,} trainable {kind}) on "
          f"{trainer.device}; mesh={dict(trainer.mesh.shape)} "
          f"fsdp={args.fsdp}",
          file=sys.stderr)

    r = np.random.default_rng(args.seed)
    latents = r.normal(size=(args.batch_size, args.img_size, args.img_size,
                             16)).astype(np.float32)
    context = r.normal(size=(args.batch_size, args.context_len,
                             args.context_dim)).astype(np.float32)
    y = r.normal(size=(args.batch_size, args.adm)).astype(np.float32)
    losses = []
    for i in range(args.steps):
        state, loss = trainer.train_step(state, latents, context, y)
        losses.append(float(loss))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"[sd3 train] step {i}: loss {losses[-1]:.4f}",
                  file=sys.stderr)
    out = trainer.sample(state, context[:2], y[:2], steps=4)
    if not bool(out.isfinite().all()):
        raise RuntimeError("sampled latents are not finite")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} "
          f"steps; sampled latents {tuple(out.shape)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
