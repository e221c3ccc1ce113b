"""Per-stage shape checks, the reference's `01_check.py` UX as one CLI, on
the card (port of ``cli/checks.py``).

Runs zero-tensor forward passes through each stage's models (random
weights) and prints the shape trace, the JAX package's lines with the same
shapes (NHWC) and parameter counts; ``--device`` (default ``cuda``) says
where the models run. ``checks sd1`` runs its UNet in fp32 at a 32^2
latent: its five level-0 self-attentions (8 heads of 8 over 1024 tokens)
take the fp32 flash kernel at head dim 8 on the card.

  python -m from_ddpm_to_stable_diffusion_tpu_torch checks sd1|sd3|vae|vit|clip|tiny|all
  python -m from_ddpm_to_stable_diffusion_tpu_torch checks weights model.safetensors
"""

from __future__ import annotations

import argparse

import torch


def _shape(x) -> tuple:
    return tuple(x.shape)


def _num_params(module) -> int:
    return sum(p.numel() for p in module.parameters())


@torch.no_grad()
def check_tiny(device="cuda"):
    from ..models.tiny_unet import TinyUNet

    with torch.device(device):
        model = TinyUNet(base_channels=64, num_classes=3)
        x = torch.zeros((2, 64, 64, 3))
        t = torch.zeros((2,), dtype=torch.long)
        y = torch.ones((2,), dtype=torch.long)
    out = model.eval()(x, t, y)
    print(f"tiny UNet: in {_shape(x)} -> out {_shape(out)}  params "
          f"{_num_params(model):,}")
    assert out.shape == x.shape


def plot_schedule(out_path: str = "parameters.png",
                  beta_1: float = 0.0015, beta_T: float = 0.0195,
                  T: int = 1000):
    """√ᾱ_t / √(1−ᾱ_t) noise-schedule curves: the reference's
    visual_alpha() check (06_tiny_stable_diffusion/01_check.py:33-47).
    matplotlib is imported here only."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..ops.schedules import ddpm_tables

    tables = ddpm_tables(beta_1, beta_T, T)
    plt.figure(figsize=(12, 8))
    plt.plot(tables.sqrt_alphas_bar, label="sqrt_alphas_bar")
    plt.plot(tables.sqrt_one_minus_alphas_bar,
             label="sqrt_one_minus_alphas_bar", color="orange")
    plt.title("DDPM Parameters")
    plt.legend()
    plt.xlabel("Timesteps")
    plt.ylabel("Value")
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close()
    print(f"schedule plot -> {out_path}")
    return out_path


@torch.no_grad()
def check_sd1(device="cuda"):
    from ..models.sd1 import CLIPText, SD1UNet, VAEDecoder, VAEEncoder

    with torch.device(device):
        clip = CLIPText(num_layers=2)
        tokens = torch.zeros((1, 77), dtype=torch.long)
    print(f"CLIP text: {_shape(tokens)} -> {_shape(clip(tokens))}")

    with torch.device(device):
        unet = SD1UNet(model_channels=64)
        x = torch.zeros((1, 32, 32, 4))
        ctx = torch.zeros((1, 77, 768))
        t = torch.zeros((1, 320))
    print(f"UNet: {_shape(x)} -> {_shape(unet(x, ctx, t))}")

    with torch.device(device):
        enc, dec = VAEEncoder(), VAEDecoder()
        img = torch.zeros((1, 64, 64, 3))
        noise = torch.zeros((1, 8, 8, 4))
    z = enc(img, noise)
    print(f"VAE: {_shape(img)} -> {_shape(z)} -> {_shape(dec(z))}")


@torch.no_grad()
def check_sd3(device="cuda"):
    from ..models.mmdit import MMDiT, MMDiTConfig

    with torch.device(device):
        model = MMDiT(MMDiTConfig(depth=2, pos_embed_max_size=16))
        x = torch.zeros((2, 16, 16, 16))
        t = torch.tensor([500.0, 500.0])
        y = torch.zeros((2, 2048))
        ctx = torch.zeros((2, 154, 4096))
    out = model(x, t, y, ctx)
    print(f"MMDiT(depth=2): latent {_shape(x)}, ctx {_shape(ctx)}, "
          f"pooled {_shape(y)} -> {_shape(out)}")
    assert out.shape == x.shape


@torch.no_grad()
def check_vae(device="cuda"):
    from ..models.vae import VanillaVAE, VQVAE

    with torch.device(device):
        v = VanillaVAE(image_size=64, latent_dim=32,
                       hidden_dims=(16, 32, 64, 64, 64))
        x = torch.zeros((2, 64, 64, 3))
    recon, mu, log_var = v.eval()(x)
    print(f"VanillaVAE: {_shape(x)} -> recon {_shape(recon)}, mu "
          f"{_shape(mu)}")

    with torch.device(device):
        q = VQVAE(embedding_dim=4, num_embeddings=32,
                  hidden_dims=(16, 32, 64))
    recon, vq_loss, idx = q.eval()(x)
    print(f"VQVAE: {_shape(x)} -> recon {_shape(recon)}, codes "
          f"{_shape(idx)}")


@torch.no_grad()
def check_vit(device="cuda"):
    from ..models.vit import ViT

    with torch.device(device):
        m = ViT(image_size=128, patch_size=32, num_classes=3, dim=512,
                depth=6, heads=8, mlp_dim=1024)
        x = torch.zeros((2, 128, 128, 3))
    print(f"ViT: {_shape(x)} -> {_shape(m.eval()(x))}  params "
          f"{_num_params(m):,}")


@torch.no_grad()
def check_clip(device="cuda"):
    from ..models.clip import CLIP
    from ..models.siglip import SiglipVisionConfig, SiglipVisionModel

    with torch.device(device):
        m = CLIP(embed_dim=64, image_resolution=64, vision_layers=2,
                 vision_width=128, vision_patch_size=16, context_length=16,
                 vocab_size=128, transformer_width=64, transformer_heads=4,
                 transformer_layers=2)
        img = torch.zeros((2, 64, 64, 3))
        txt = torch.zeros((2, 16), dtype=torch.long)
    li, lt = m(img, txt)
    print(f"CLIP: image {_shape(img)} + text {_shape(txt)} -> logits "
          f"{_shape(li)}")

    with torch.device(device):
        sig = SiglipVisionModel(SiglipVisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, image_size=64, patch_size=16))
    print(f"SigLIP vision: {_shape(img)} -> {_shape(sig(img))}")


@torch.no_grad()
def check_clip_pretrained(ckpt: str, image_path: str, vocab_dir: str,
                          prompts=None, device="cuda"):
    """The reference's stage-05 check with real weights
    (05_clip/01_check.py:8-27): pretrained ViT-L/14 on an image, softmax
    probabilities over candidate captions (returned as a numpy array)."""
    import os

    from PIL import Image

    from ..io.tokenizer import CLIPTokenizer
    from ..io.weights_clip import import_openai_clip
    from ..models.clip import CLIP
    from ..ops.image import clip_preprocess
    from ..pipelines.sd1 import _from_state

    prompts = prompts or ["a cat", "a dog", "a wild animal"]
    state, cfg = import_openai_clip(ckpt)
    model = _from_state(lambda: CLIP(**cfg), state, device).eval()
    tokenizer = CLIPTokenizer.from_files(
        os.path.join(vocab_dir, "vocab.json"),
        os.path.join(vocab_dir, "merges.txt"))
    image = torch.from_numpy(clip_preprocess(
        Image.open(image_path), cfg["image_resolution"])).to(device)
    text = torch.as_tensor(tokenizer.encode_batch(prompts), dtype=torch.long)
    text = text[:, :cfg["context_length"]].to(device)
    logits, _ = model(image, text)
    probs = torch.softmax(logits, dim=-1)[0].cpu().numpy()
    for prompt, prob in zip(prompts, probs):
        print(f"  {prompt!r}: {float(prob):.4f}")
    return probs


@torch.no_grad()
def check_siglip_pretrained(ckpt: str, image_path: str, device="cuda"):
    """Pretrained SigLIP vision tower on an image: loads the HF-layout
    checkpoint through io.weights_clip.import_siglip_vision and prints the
    patch-feature summary (the reference's SigLIP is vision-only,
    model_siglip.py:235: no text head to score against)."""
    import numpy as np
    from PIL import Image

    from ..io.weights_clip import import_siglip_vision
    from ..models.siglip import SiglipVisionConfig, SiglipVisionModel
    from ..pipelines.sd1 import _from_state

    state, cfg = import_siglip_vision(ckpt)
    model = _from_state(lambda: SiglipVisionModel(SiglipVisionConfig(**cfg)),
                        state, device).eval()
    img = Image.open(image_path).convert("RGB").resize(
        (cfg["image_size"], cfg["image_size"]))
    x = torch.from_numpy(np.asarray(img, np.float32) / 127.5 - 1.0)[None]
    feats = model(x.to(device))
    print(f"  SigLIP({cfg['num_hidden_layers']}L/{cfg['hidden_size']}d, "
          f"patch {cfg['patch_size']}): {_shape(x)} -> {_shape(feats)}  "
          f"mean {float(feats.mean()):+.4f}  std "
          f"{float(feats.std(correction=0)):.4f}")
    return feats


def check_weights(path: str):
    """Dump tensor names / shapes / dtypes of a checkpoint file: the
    reference's check_tensor() (01_.../01_check.py:100-108). The dtype is
    the file's (the JAX reader widens a .pt file's tensors to float32)."""
    from ..io.weights import load_safetensors_dict, load_torch_state_dict

    state = (load_safetensors_dict(path) if path.endswith(".safetensors")
             else load_torch_state_dict(path))
    for k in sorted(state):
        v = state[k]
        print(f"{k}: {tuple(v.shape)} {str(v.dtype).removeprefix('torch.')}")
    print(f"{len(state)} tensors")


CHECKS = {"tiny": check_tiny, "sd1": check_sd1, "sd3": check_sd3,
          "vae": check_vae, "vit": check_vit, "clip": check_clip}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="checks")
    ap.add_argument("stage", choices=sorted(CHECKS) + ["all", "weights"])
    ap.add_argument("path", nargs="?", help="checkpoint path (weights mode)")
    ap.add_argument("--ckpt", help="pretrained OpenAI-CLIP checkpoint: "
                    "run the stage-05 real-weights check (clip stage only)")
    ap.add_argument("--siglip-ckpt",
                    help="pretrained HF SigLIP checkpoint (clip stage)")
    ap.add_argument("--image", help="image for the pretrained CLIP check")
    ap.add_argument("--vocab-dir", help="dir with vocab.json + merges.txt")
    ap.add_argument("--prompt", action="append",
                    help="candidate captions (repeatable)")
    ap.add_argument("--plot-schedule", metavar="OUT.png", nargs="?",
                    const="parameters.png",
                    help="tiny stage: plot the √ᾱ noise-schedule curves "
                    "(reference visual_alpha, 06_…/01_check.py:33)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the checks run on")
    args = ap.parse_args(argv)
    if args.stage == "tiny" and args.plot_schedule:
        plot_schedule(args.plot_schedule)
        return 0
    if args.stage == "weights":
        if not args.path:
            ap.error("weights mode needs a checkpoint path")
        check_weights(args.path)
        return 0
    if args.stage == "clip" and args.ckpt:
        if not (args.image and args.vocab_dir):
            ap.error("--ckpt needs --image and --vocab-dir")
        check_clip_pretrained(args.ckpt, args.image, args.vocab_dir,
                              args.prompt, device=args.device)
        return 0
    if args.stage == "clip" and args.siglip_ckpt:
        if not args.image:
            ap.error("--siglip-ckpt needs --image")
        check_siglip_pretrained(args.siglip_ckpt, args.image,
                                device=args.device)
        return 0
    stages = sorted(CHECKS) if args.stage == "all" else [args.stage]
    for s in stages:
        print(f"--- {s} ---")
        CHECKS[s](device=args.device)
    print("all checks passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
