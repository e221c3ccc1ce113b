"""Package entry point: ``python -m from_ddpm_to_stable_diffusion_tpu_torch
<stage> …`` dispatches to the per-stage CLIs (port of ``__main__.py``).

    python -m from_ddpm_to_stable_diffusion_tpu_torch sd1 generate --prompt "…"
    python -m from_ddpm_to_stable_diffusion_tpu_torch serve
    python -m from_ddpm_to_stable_diffusion_tpu_torch video train
    python -m from_ddpm_to_stable_diffusion_tpu_torch checks all
"""

from __future__ import annotations

import sys

STAGES = ("sd1", "sd3", "vae", "vit", "tiny_sd", "video", "multimodal",
          "demos", "checks", "serve")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in STAGES:
        print("usage: python -m from_ddpm_to_stable_diffusion_tpu_torch "
              f"{{{'|'.join(STAGES)}}} …")
        return 0 if argv and argv[0] in ("-h", "--help") else 2
    import importlib

    mod = importlib.import_module(f".cli.{argv[0]}", __package__)
    return mod.main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
