"""Stage-08 CLI: train the video-diffusion UNet on the card and sample
class-conditional clips (port of ``cli/video.py``). The clips are written
as one PNG grid (rows: the motion classes right / down / diagonal;
columns: the frames) by the port's stdlib PNG encoder.

    python -m from_ddpm_to_stable_diffusion_tpu_torch video train \
        --epochs 40 --img-size 32 --frames 8 --out video_grid.png
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="video")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("train")
    g.add_argument("--epochs", type=int, default=40)
    g.add_argument("--clips", type=int, default=256)
    g.add_argument("--img-size", type=int, default=32)
    g.add_argument("--frames", type=int, default=8)
    g.add_argument("--batch-size", type=int, default=32)
    g.add_argument("--channel", type=int, default=64)
    g.add_argument("--T", type=int, default=400)
    g.add_argument("--dtype", default="bf16")
    g.add_argument("--ckpt-dir", default=None)
    g.add_argument("--out", default="video_grid.png",
                   help="sampled clips tiled as (class rows × frame cols)")
    g.add_argument("--device", default="cuda",
                   help="torch device of the trainer")
    args = ap.parse_args(argv)

    import numpy as np

    from ..io import DataLoader, SyntheticVideoDataset
    from ..models.tiny_video_unet import TinyVideoUNet
    from ..ops.image import write_png
    from ..pipelines.ddpm_trainer import DDPMTrainer
    from ..utils.config import TinySDConfig
    from ..utils.dtypes import POLICIES

    cfg = TinySDConfig(
        epoch=args.epochs, batch_size=args.batch_size,
        img_size=args.img_size, T=args.T, channel=args.channel,
        dropout=0.0, dtype=args.dtype, warmup_epochs=3, num_class=3,
        lr=2e-5, max_lr=2e-4)
    model = TinyVideoUNet(base_channels=args.channel, num_classes=3,
                          dtype=POLICIES[args.dtype].compute_dtype)
    trainer = DDPMTrainer(
        cfg, device=args.device, model=model,
        sample_shape=(args.frames, args.img_size, args.img_size, 3))
    data = DataLoader(
        SyntheticVideoDataset(args.clips, args.img_size,
                              frames=args.frames), args.batch_size)
    state = trainer.fit(data, epochs=args.epochs,
                        checkpoint_dir=args.ckpt_dir)

    clips = trainer.sample(state, labels=[1, 2, 3]).cpu().numpy()
    # rows: classes (right / down / diagonal motion), columns: frames
    n, t, s, _, c = clips.shape
    grid = clips.transpose(0, 2, 1, 3, 4).reshape(n * s, t * s, c)
    grid = ((grid + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    write_png(args.out, grid)
    print(f"wrote {args.out}  (rows: motion classes right/down/diag; "
          f"cols: {t} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
