"""Stage-06 CLI: train / sample the tiny class-conditional DDPM on the card
(port of ``cli/tiny_sd.py``). YAML configs are key-compatible with
00_assets/yml/tiny_sd_direct.yml (``TinySDConfig.from_yaml`` imports PyYAML
inside the call); the sample grid is written by the port's stdlib PNG
encoder.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tiny_sd")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="train the tiny DDPM")
    tr.add_argument("--config", required=True, help="YAML config path")
    tr.add_argument("--data-dir", default=None,
                    help="AFHQ-style image-folder root (class subdirs)")
    tr.add_argument("--synthetic", action="store_true",
                    help="use a synthetic dataset (no files needed)")
    tr.add_argument("--epochs", type=int, default=None)
    tr.add_argument("--device", default="cuda",
                    help="torch device of the trainer")

    sa = sub.add_parser("sample", help="CFG-sample a grid from a checkpoint")
    sa.add_argument("--config", required=True)
    sa.add_argument("--ckpt", required=True)
    sa.add_argument("--out", default="samples.png")
    sa.add_argument("--labels", default="1,2,3,1,2,3,1")
    sa.add_argument("--device", default="cuda",
                    help="torch device of the trainer")

    args = ap.parse_args(argv)

    import numpy as np

    from ..io import DataLoader, ImageFolderDataset, SyntheticImageDataset
    from ..pipelines.ddpm_trainer import DDPMTrainer
    from ..utils.config import TinySDConfig

    cfg = TinySDConfig.from_yaml(args.config)
    trainer = DDPMTrainer(cfg, device=args.device)

    if args.cmd == "train":
        data_dir = args.data_dir or cfg.data_dir
        if args.synthetic or not data_dir:
            ds = SyntheticImageDataset(n=8 * cfg.batch_size,
                                       img_size=cfg.img_size,
                                       num_classes=cfg.num_class)
        else:
            ds = ImageFolderDataset(data_dir, cfg.img_size,
                                    to_unit_range=True)
        loader = DataLoader(ds, cfg.batch_size, seed=cfg.seed)
        trainer.fit(loader, epochs=args.epochs,
                    checkpoint_dir=cfg.model_dir)
        return 0

    # sample
    from ..ops.image import image_grid, to_uint8, write_png
    from ..utils.checkpoint import CheckpointManager

    state = trainer.create_state(steps_per_epoch=1)
    restored, step = CheckpointManager(args.ckpt).restore()
    if restored is None:
        raise SystemExit(f"no checkpoint found under {args.ckpt}")
    state.load_state_dict(restored)
    labels = np.asarray([int(x) for x in args.labels.split(",")])
    samples = trainer.sample(state, labels)
    grid = image_grid(to_uint8(samples).cpu().numpy(), nrow=cfg.nrow)
    write_png(args.out, grid)
    print(f"wrote {args.out} (from epoch {step})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
