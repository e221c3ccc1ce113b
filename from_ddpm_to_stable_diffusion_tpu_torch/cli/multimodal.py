"""Stage-07⁺ CLI: train the TinyVLM on the card and chat with it (port of
``cli/multimodal.py``): image + prompt → generated caption text, or with
--qa image + question → answer.

    python -m from_ddpm_to_stable_diffusion_tpu_torch multimodal train \
        --epochs 30 --out vlm_demo.png --ckpt-dir /tmp/vlm
    python -m from_ddpm_to_stable_diffusion_tpu_torch multimodal chat \
        --ckpt-dir /tmp/vlm --image photo.png

The port's ``VLMTrainer`` takes the model's arguments, not a module, so
:func:`_build` returns those. The demo grid holds the held-out images and
the captions (or questions and answers) are printed beside it: the grid is
written by the port's stdlib PNG encoder, which draws no text. Only chat's
--image is read through Pillow.
"""

from __future__ import annotations

import argparse


def _build(args) -> dict:
    """The TinyVLM's arguments for ``VLMTrainer``."""
    from ..io.shapes_dataset import VLM_VOCAB

    return dict(vocab_size=len(VLM_VOCAB), dim=args.dim, depth=args.depth,
                max_text_len=10 if args.qa else 8, dtype=args.dtype,
                device=args.device)


def _restore(trainer, args):
    """The trainer's state at ``--img-size``, filled from the latest
    checkpoint under ``--ckpt-dir``."""
    from ..utils.checkpoint import CheckpointManager

    state = trainer.create_state(args.img_size)
    restored, _ = CheckpointManager(args.ckpt_dir).restore()
    if restored is None:
        raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
    state.load_state_dict(restored)
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(prog="multimodal")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("train", "chat", "eval"):
        g = sub.add_parser(name)
        g.add_argument("--img-size", type=int, default=64)
        g.add_argument("--dim", type=int, default=128)
        g.add_argument("--depth", type=int, default=4)
        g.add_argument("--dtype", default="bf16")
        g.add_argument("--ckpt-dir", default=None)
        g.add_argument("--qa", action="store_true",
                       help="image+question→answer mode (VQA dataset, "
                            "question-masked loss, --question at chat)")
        g.add_argument("--device", default="cuda",
                       help="torch device of the trainer")
        if name == "train":
            g.add_argument("--epochs", type=int, default=30)
            g.add_argument("--examples", type=int, default=1024)
            g.add_argument("--batch-size", type=int, default=64)
            g.add_argument("--lr", type=float, default=3e-4)
            g.add_argument("--out", default="vlm_demo.png",
                           help="demo grid: held-out test images")
        if name == "chat":
            g.add_argument("--image", required=True)
            g.add_argument("--question", default=None,
                           help='e.g. "what color ?" (requires --qa)')
        if name == "eval":
            g.add_argument("--out", default=None,
                           help="also write the demo grid here")
    args = ap.parse_args(argv)

    import numpy as np

    from ..io import CaptionedShapesDataset, DataLoader
    from ..io.shapes_dataset import VQA_ANSWER_START, VQAShapesDataset
    from ..pipelines.vlm_trainer import VLMTrainer

    model_args = _build(args)
    ds_cls = VQAShapesDataset if args.qa else CaptionedShapesDataset
    answer_start = VQA_ANSWER_START if args.qa else 0

    if args.cmd == "train":
        data = ds_cls(args.examples, args.img_size)
        loader = DataLoader(data, args.batch_size)
        steps = len(loader) * args.epochs
        trainer = VLMTrainer(**model_args, lr=args.lr,
                             warmup_steps=steps // 10, total_steps=steps,
                             answer_start=answer_start)
        state = trainer.fit(loader, epochs=args.epochs,
                            image_size=args.img_size,
                            checkpoint_dir=args.ckpt_dir)
        # held-out eval: a different seed than training data
        test = ds_cls(64, args.img_size, seed=999)
        _report(trainer, state, test, args.qa, args.out)
        return 0

    if not args.ckpt_dir:
        ap.error(f"{args.cmd} needs --ckpt-dir")
    trainer = VLMTrainer(**model_args)
    state = _restore(trainer, args)

    if args.cmd == "eval":
        test = ds_cls(64, args.img_size, seed=999)
        _report(trainer, state, test, args.qa, args.out)
        return 0

    # chat: arbitrary image file (+ question in --qa mode) → text
    from PIL import Image

    from ..models.tiny_vlm import greedy_decode

    img = Image.open(args.image).convert("RGB").resize(
        (args.img_size, args.img_size))
    x = (np.asarray(img, np.float32) / 127.5 - 1.0)[None]
    data = ds_cls(1, args.img_size)
    if args.qa:
        question = args.question or "describe it ."
        ids = greedy_decode(state.model, x, max_len=trainer.max_text_len,
                            prompt_ids=data.encode_question(question))
        print(data.decode_answer(ids.cpu().numpy()[0]))
    else:
        ids = greedy_decode(state.model, x, max_len=trainer.max_text_len)
        print(data.decode(ids.cpu().numpy()[0]))
    return 0


def _report(trainer, state, test, qa: bool, out_path) -> None:
    """Held-out exact-match accuracy, and the demo grid when ``out_path``."""
    if qa:
        acc = trainer.qa_accuracy(state, test, n=64)
        print(f"held-out ANSWER exact-match accuracy: {acc:.2%}")
    else:
        acc = trainer.caption_accuracy(state, test, n=64)
        print(f"held-out caption exact-match accuracy: {acc:.2%}")
    if out_path:
        (_qa_demo if qa else _demo_grid)(trainer, state, test, out_path)


def _demo_images(images, out_path, nrow: int) -> None:
    """The held-out images, [-1, 1] → uint8, as one PNG grid."""
    import numpy as np

    from ..ops.image import image_grid, write_png

    tiles = ((np.stack(images) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    write_png(out_path, image_grid(tiles, nrow))
    print(f"wrote {out_path}")


def _qa_demo(trainer, state, dataset, out_path, n: int = 12):
    """Held-out images, each asked ITS question: the grid, and 'Q: … A: …'
    per tile printed in the grid's order."""
    import numpy as np

    from ..io.shapes_dataset import VQA_ANSWER_START
    from ..models.tiny_vlm import greedy_decode

    imgs, toks = zip(*(dataset.load(i) for i in range(n)))
    prompts = np.stack(toks)[:, :VQA_ANSWER_START]
    got = greedy_decode(state.model, np.stack(imgs),
                        max_len=trainer.max_text_len, prompt_ids=prompts)
    _demo_images(imgs, out_path, 4)
    for p, g, w in zip(prompts, got.cpu().numpy(), toks):
        q = " ".join(dataset.vocab[i] for i in p[1:])
        print(f"Q: {q!r}  A: {dataset.decode_answer(g)!r}  want: "
              f"{dataset.decode_answer(w)!r}")


def _demo_grid(trainer, state, dataset, out_path, n: int = 9):
    """Held-out images: the grid, and each one's caption printed in the
    grid's order."""
    import numpy as np

    from ..models.tiny_vlm import greedy_decode

    imgs, want = zip(*(dataset.load(i) for i in range(n)))
    got = greedy_decode(state.model, np.stack(imgs),
                        max_len=trainer.max_text_len)
    _demo_images(imgs, out_path, 3)
    for g, w in zip(got.cpu().numpy(), want):
        print(f"got: {dataset.decode(g)!r}  want: {dataset.decode(w)!r}")


if __name__ == "__main__":
    raise SystemExit(main())
