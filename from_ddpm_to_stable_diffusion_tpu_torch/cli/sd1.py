"""Stage-01 CLI: SD1 text→image / image→image generation on the card (port
of ``cli/sd1.py``), with the ``generate`` defaults (512×512, 50 steps, CFG
7.5, k_lms). Images are written by the port's stdlib PNG encoder; only
``--input-image`` reads an image, through Pillow. ``--tp N`` serves
tensor-parallel over a ``model`` mesh of the first N visible devices of
--device's kind (``parallel.build_mesh``, as the JAX CLI builds it over
``jax.devices()[:N]``: on a host with fewer it raises the mesh-shape
``ValueError``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sd1")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate")
    g.add_argument("--prompt", action="append", required=True,
                   help="repeatable; one image per prompt")
    g.add_argument("--uncond-prompt", action="append", default=None)
    g.add_argument("--input-image", action="append", default=None)
    g.add_argument("--strength", type=float, default=0.8)
    g.add_argument("--cfg-scale", type=float, default=7.5)
    g.add_argument("--no-cfg", action="store_true")
    g.add_argument("--height", type=int, default=512)
    g.add_argument("--width", type=int, default=512)
    g.add_argument("--sampler", default="k_lms",
                   choices=["k_lms", "k_euler", "k_euler_ancestral", "dpmpp_2m"])
    g.add_argument("--steps", type=int, default=50)
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--prompt-weighting", action="store_true",
                   help="enable (text:1.3) attention-weight syntax")
    g.add_argument("--ckpt-dir", default=None,
                   help="dir with ckpt/{clip,diffusion,encoder,decoder}.pt"
                        " + vocab.json/merges.txt (reference layout)")
    g.add_argument("--dtype", default="bf16")
    g.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel serving over N devices (shards "
                        "attention/GEGLU kernels on the model mesh axis)")
    g.add_argument("--out", default="sd1_{i}.png")
    g.add_argument("--device", default="cuda",
                   help="torch device of the model bundle")
    args = ap.parse_args(argv)

    import os

    import numpy as np
    import torch

    from ..ops.image import write_png
    from ..pipelines.sd1 import SD1Models, generate

    device = torch.device(args.device)
    mesh = None
    if args.tp > 1:
        from ..parallel import apply_tp, build_mesh, visible_devices

        mesh = build_mesh({"model": args.tp},
                          visible_devices(device.type)[:args.tp])
    tokenizer = None
    if args.ckpt_dir:
        from ..io.tokenizer import CLIPTokenizer

        models = SD1Models.from_checkpoint_dir(args.ckpt_dir,
                                               dtype=args.dtype,
                                               device=device)
        tokenizer = CLIPTokenizer.from_files(
            os.path.join(args.ckpt_dir, "vocab.json"),
            os.path.join(args.ckpt_dir, "merges.txt"))
    else:
        print("[sd1] no --ckpt-dir: random weights (smoke-test mode)")
        models = SD1Models.initialize(
            torch.Generator(device).manual_seed(0), device, args.dtype)

    if mesh is not None:
        for model in (models.clip, models.unet, models.encoder,
                      models.decoder):
            if model is not None:
                apply_tp(model, mesh)

    input_images = None
    if args.input_image:
        from PIL import Image

        input_images = [np.asarray(
            Image.open(p).convert("RGB").resize((args.width, args.height)))
            for p in args.input_image]

    images = generate(
        args.prompt, models, tokenizer=tokenizer,
        uncond_prompts=args.uncond_prompt, input_images=input_images,
        strength=args.strength, do_cfg=not args.no_cfg,
        cfg_scale=args.cfg_scale, height=args.height, width=args.width,
        sampler=args.sampler, n_inference_steps=args.steps, seed=args.seed,
        prompt_weighting=args.prompt_weighting)
    for i, img in enumerate(images):
        path = args.out.format(i=i)
        write_png(path, img)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
