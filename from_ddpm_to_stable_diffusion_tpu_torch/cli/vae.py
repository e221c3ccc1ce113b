"""Stage-03 CLI: train the VanillaVAE or the VQ-VAE on the card (port of
``cli/vae.py``); ``--preview-dir`` receives a PNG of four images over their
reconstructions after each epoch, written by the port's stdlib encoder.

    python -m from_ddpm_to_stable_diffusion_tpu_torch vae train --synthetic
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vae")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    tr.add_argument("--model", choices=["vqvae", "vanilla"], default="vqvae")
    tr.add_argument("--data-dir", default=None)
    tr.add_argument("--synthetic", action="store_true")
    tr.add_argument("--img-size", type=int, default=512)
    tr.add_argument("--batch-size", type=int, default=7)
    tr.add_argument("--epochs", type=int, default=40)
    tr.add_argument("--embedding-dim", type=int, default=4)
    tr.add_argument("--num-embeddings", type=int, default=128)
    tr.add_argument("--model-dir", default="./checkpoints/vae")
    tr.add_argument("--preview-dir", default=None)
    tr.add_argument("--device", default="cuda",
                    help="torch device of the trainer")
    args = ap.parse_args(argv)

    import numpy as np

    from ..io import DataLoader, ImageFolderDataset, SyntheticImageDataset
    from ..pipelines.vae_trainer import VAETrainer
    from ..utils.config import VAETrainConfig

    cfg = VAETrainConfig(
        epoch=args.epochs, batch_size=args.batch_size, img_size=args.img_size,
        model=args.model, embedding_dim=args.embedding_dim,
        num_embeddings=args.num_embeddings, model_dir=args.model_dir)
    trainer = VAETrainer(cfg, device=args.device)
    if args.synthetic or not args.data_dir:
        ds = SyntheticImageDataset(n=8 * cfg.batch_size, img_size=cfg.img_size)
    else:
        ds = ImageFolderDataset(args.data_dir, cfg.img_size,
                                to_unit_range=True)
    loader = DataLoader(ds, cfg.batch_size, seed=cfg.seed)
    preview = None
    if args.preview_dir:
        preview = np.stack([ds.load(i)[0] for i in range(4)])
    trainer.fit(loader, checkpoint_dir=cfg.model_dir, preview_batch=preview,
                preview_dir=args.preview_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
