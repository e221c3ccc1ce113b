"""Serving CLI: SD1 (or SD3) text→image behind the dynamic-batching HTTP
endpoint, on the card (port of ``cli/serve.py``).

    python -m from_ddpm_to_stable_diffusion_tpu_torch serve --ckpt-dir …/model_sd1
    curl -s localhost:8000/v1/generate -d '{"prompt":"a cat","seed":1}' > cat.png

One generator, resident on ``--device``, behind the bucketed
``DynamicBatcher`` (``serving/batcher.py``), so concurrent requests
coalesce into batches of 1, 2, 4 or 8. ``--tp N`` serves the bundle
tensor-parallel over a ``model`` mesh of the first N visible devices of
--device's kind, as the JAX CLI builds it (on a host with fewer it raises
the mesh-shape ``ValueError``); the batcher's worker thread runs it.
"""

from __future__ import annotations

import argparse
import contextlib
import os

def on_device(device):
    """A context that makes ``device`` the current CUDA device of the
    calling thread (a no-op for the CPU): the batcher's worker thread
    starts on the first card, and the kernels launch on the current one."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def sd1_generate_fn(gen):
    """The batcher's ``generate_fn`` over an ``SD1Generator``: (prompts,
    negative prompts, seeds) -> uint8 (B, H, W, 3), each sample from its
    own seed, run on the bundle's device."""
    def generate_fn(prompts, negative_prompts, seeds):
        with on_device(gen.device):
            return gen(list(prompts), uncond_prompts=list(negative_prompts),
                       per_sample_seeds=list(seeds))

    return generate_fn


def _build_sd1(args, mesh=None):
    """An ``SD1Generator`` at the flags' operating point behind the
    (prompts, negs, seeds) adapter."""
    import torch

    from ..pipelines.sd1 import SD1Generator, SD1Models

    device = torch.device(args.device)
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
        print("[serve] no --ckpt-dir: random weights (smoke-test mode)")
        models = SD1Models.initialize(
            torch.Generator(device).manual_seed(0), device, args.dtype)

    gen = SD1Generator(models, tokenizer=tokenizer, sampler=args.sampler,
                       n_inference_steps=args.steps,
                       cfg_scale=args.cfg_scale, height=args.height,
                       width=args.width, mesh=mesh)
    return sd1_generate_fn(gen)


def _build_sd3(args, mesh=None):
    """An ``SD3Inferencer`` behind the same adapter: one text encode and
    one batched CFG denoise per bucket call (``gen_images_text``)."""
    import numpy as np
    import torch

    from ..pipelines.sd3 import SD3Inferencer, SD3Models

    device = torch.device(args.device)
    if args.ckpt:
        models = SD3Models.from_checkpoints(
            args.ckpt, clip_l_path=args.clip_l, clip_g_path=args.clip_g,
            t5_path=args.t5, dtype=args.dtype, device=device)
    else:
        print("[serve] no --ckpt: scaled-down random weights "
              "(smoke-test mode)")
        models = SD3Models.initialize(torch.Generator(device).manual_seed(0),
                                      device, dtype=args.dtype, depth=4,
                                      with_t5=False)
    if args.int8:
        print("[serve] int8 serving path: quantizing MMDiT/T5 projections")
        models.quantize_int8()

    tokenizer = None
    if args.vocab and args.merges:
        from ..io.spm_tokenizer import SD3Tokenizer, T5XXLTokenizer
        from ..io.tokenizer import CLIPTokenizer

        clip_tok = CLIPTokenizer.from_files(args.vocab, args.merges)
        if args.spm:
            t5_tok = T5XXLTokenizer.from_file(args.spm)
        else:
            from ..io.spm_tokenizer import (CONTROL, UNKNOWN,
                                            SentencePieceUnigram)

            t5_tok = T5XXLTokenizer(SentencePieceUnigram(
                [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
                 ("<unk>", 0.0, UNKNOWN)]))
        tokenizer = SD3Tokenizer(clip_tok, t5_tok)

    inf = SD3Inferencer(models, shift=args.shift, tokenizer=tokenizer,
                        mesh=mesh)
    kw = dict(width=args.width, height=args.height, steps=args.steps,
              cfg_scale=args.cfg_scale, sampler=args.flow_sampler)

    if tokenizer is None:
        print("[serve] no --vocab/--merges: zero-token smoke conditioning")

        def generate_fn(prompts, negative_prompts, seeds):
            toks = np.zeros((len(prompts), 77), np.int32)
            with on_device(inf.device):
                return inf.gen_image(toks, per_sample_seeds=list(seeds),
                                     **kw)
    else:
        def generate_fn(prompts, negative_prompts, seeds):
            with on_device(inf.device):
                return inf.gen_images_text(list(prompts),
                                           list(negative_prompts),
                                           per_sample_seeds=list(seeds),
                                           **kw)

    return generate_fn


def main(argv=None):
    ap = argparse.ArgumentParser(prog="serve")
    ap.add_argument("--model", default="sd1", choices=["sd1", "sd3"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="sd1: reference model_sd1 layout; omit for "
                         "random-weight smoke mode")
    ap.add_argument("--ckpt", default=None,
                    help="sd3: .safetensors path (shape-sniffed config)")
    ap.add_argument("--clip-l", default=None, help="sd3 CLIP-L safetensors")
    ap.add_argument("--clip-g", default=None, help="sd3 CLIP-G safetensors")
    ap.add_argument("--t5", default=None, help="sd3 T5-XXL safetensors")
    ap.add_argument("--vocab", default=None, help="sd3 CLIP vocab.json")
    ap.add_argument("--merges", default=None, help="sd3 CLIP merges.txt")
    ap.add_argument("--spm", default=None, help="sd3 T5 spiece.model")
    ap.add_argument("--shift", type=float, default=3.0,
                    help="sd3 flow-sigma shift")
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--sampler", default="k_lms",
                    choices=["k_lms", "k_euler", "k_euler_ancestral",
                             "dpmpp_2m"], help="sd1 sampler")
    ap.add_argument("--flow-sampler", default="euler",
                    choices=["euler", "heun"],
                    help="sd3 flow sampler (heun: 2 model calls/step)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cfg-scale", type=float, default=7.5)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel serving over N devices")
    ap.add_argument("--int8", action="store_true",
                    help="sd3: W8A8 int8 MMDiT/T5 projections")
    ap.add_argument("--buckets", default="1,2,4,8",
                    help="batch-size ladder; each bucket is warmed once")
    ap.add_argument("--max-wait-ms", type=float, default=25.0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip running every bucket once before binding")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model bundle")
    args = ap.parse_args(argv)

    from ..serving import (DynamicBatcher, make_server,
                           serve_forever_in_thread)

    mesh = None
    if args.tp > 1:
        import torch

        from ..parallel import build_mesh, visible_devices

        mesh = build_mesh({"model": args.tp}, visible_devices(
            torch.device(args.device).type)[:args.tp])

    if args.model == "sd3":
        generate_fn = _build_sd3(args, mesh)
    else:
        generate_fn = _build_sd1(args, mesh)

    buckets = sorted({int(b) for b in args.buckets.split(",")})
    batcher = DynamicBatcher(generate_fn, buckets=buckets,
                             max_wait_ms=args.max_wait_ms,
                             max_queue=args.max_queue)
    if not args.no_warmup:
        import time

        t0 = time.perf_counter()
        print(f"[serve] warming up buckets {buckets}…")
        batcher.warmup()
        print(f"[serve] warmup done in {time.perf_counter() - t0:.1f}s")

    server = make_server(batcher, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} "
          f"(POST /v1/generate, GET /healthz, GET /metrics)")
    thread = serve_forever_in_thread(server)
    try:
        thread.join()
    except KeyboardInterrupt:
        print("[serve] shutting down")
        server.shutdown()
        batcher.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
