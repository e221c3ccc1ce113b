"""Stage-04 CLI: ViT classification training on the card (port of
``cli/vit.py``).

    python -m from_ddpm_to_stable_diffusion_tpu_torch vit train --synthetic
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vit")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    tr.add_argument("--data-dir", default=None, help="train split root")
    tr.add_argument("--val-dir", default=None, help="val split root")
    tr.add_argument("--synthetic", action="store_true")
    tr.add_argument("--img-size", type=int, default=128)
    tr.add_argument("--patch-size", type=int, default=32)
    tr.add_argument("--batch-size", type=int, default=256)
    tr.add_argument("--epochs", type=int, default=10)
    tr.add_argument("--model-dir", default="./checkpoints/vit")
    tr.add_argument("--device", default="cuda",
                    help="torch device of the trainer")
    args = ap.parse_args(argv)

    from ..io import DataLoader, ImageFolderDataset, SyntheticImageDataset
    from ..pipelines.vit_trainer import ViTTrainer
    from ..utils.config import ViTTrainConfig

    cfg = ViTTrainConfig(epoch=args.epochs, batch_size=args.batch_size,
                         img_size=args.img_size, patch_size=args.patch_size,
                         model_dir=args.model_dir)
    trainer = ViTTrainer(cfg, device=args.device)
    if args.synthetic or not args.data_dir:
        train_ds = SyntheticImageDataset(n=8 * cfg.batch_size,
                                         img_size=cfg.img_size,
                                         num_classes=cfg.num_class)
        val_ds = SyntheticImageDataset(n=2 * cfg.batch_size,
                                       img_size=cfg.img_size,
                                       num_classes=cfg.num_class, seed=1)
    else:
        train_ds = ImageFolderDataset(args.data_dir, cfg.img_size)
        val_ds = (ImageFolderDataset(args.val_dir, cfg.img_size)
                  if args.val_dir else train_ds)
    train_loader = DataLoader(train_ds, cfg.batch_size, seed=cfg.seed)
    val_loader = DataLoader(val_ds, cfg.batch_size, shuffle=False)
    trainer.fit(train_loader, val_loader, checkpoint_dir=cfg.model_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
