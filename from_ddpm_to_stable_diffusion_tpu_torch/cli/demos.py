"""Stage 07/08/09 capability adapters: multimodal chat, text->video, a remote
API (the port's own copy of ``cli/demos.py``, which imports no JAX).

The reference implements these as thin library calls
(07_multimodal/01_check.py: MiniCPM-V-2.6 via HF AutoModel;
08_video/01_check.py: CogVideoX-2b via diffusers; 09_api/01_replicate.py:
the Replicate HTTP API). They are capability targets, not code to port
(SURVEY.md §2.7); this module provides the same surfaces with gated
imports, so that a machine without the model weights, the packages or the
network fails with an actionable ``RuntimeError`` instead of a traceback.

  python -m from_ddpm_to_stable_diffusion_tpu_torch demos replicate --version V --input-json '{...}'
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import urllib.request


def multimodal_chat(image_path: str, question: str,
                    model_id: str = "openbmb/MiniCPM-V-2_6") -> str:
    """Image+question → answer via a HF multimodal model (stage 07)."""
    try:
        from transformers import AutoModel, AutoTokenizer
    except ImportError as e:
        raise RuntimeError("transformers is required for multimodal chat") from e
    from PIL import Image

    try:
        model = AutoModel.from_pretrained(model_id, trust_remote_code=True,
                                          attn_implementation="sdpa")
        tokenizer = AutoTokenizer.from_pretrained(model_id,
                                                  trust_remote_code=True)
    except Exception as e:  # no network / weights in this environment
        raise RuntimeError(
            f"could not load {model_id}; download the weights into the HF "
            f"cache first (offline environment?)") from e
    image = Image.open(image_path).convert("RGB")
    msgs = [{"role": "user", "content": [image, question]}]
    return model.chat(image=None, msgs=msgs, tokenizer=tokenizer)


def text_to_video(prompt: str, out_path: str = "output.mp4",
                  model_id: str = "THUDM/CogVideoX-2b",
                  num_frames: int = 49, steps: int = 50,
                  guidance_scale: float = 6.0, seed: int = 42) -> str:
    """Text→video via diffusers CogVideoX (stage 08)."""
    try:
        import torch
        from diffusers import CogVideoXPipeline
        from diffusers.utils import export_to_video
    except ImportError as e:
        raise RuntimeError("diffusers is required for text→video") from e
    try:
        pipe = CogVideoXPipeline.from_pretrained(model_id,
                                                 torch_dtype=torch.float16)
    except Exception as e:
        raise RuntimeError(
            f"could not load {model_id}; download the weights first") from e
    pipe.enable_model_cpu_offload()
    pipe.vae.enable_slicing()
    pipe.vae.enable_tiling()
    video = pipe(prompt=prompt, num_videos_per_prompt=1,
                 num_inference_steps=steps, num_frames=num_frames,
                 guidance_scale=guidance_scale,
                 generator=torch.Generator(device="cpu").manual_seed(seed),
                 ).frames[0]
    export_to_video(video, out_path, fps=8)
    return out_path


def replicate_run(model_version: str, inputs: dict,
                  api_token: str | None = None,
                  base_url: str = "https://api.replicate.com/v1") -> dict:
    """Minimal Replicate prediction call (stage 09) — stdlib HTTP only."""
    token = api_token or os.environ.get("REPLICATE_API_TOKEN")
    if not token:
        raise RuntimeError("set REPLICATE_API_TOKEN to call the Replicate API")
    req = urllib.request.Request(
        f"{base_url}/predictions",
        data=json.dumps({"version": model_version,
                         "input": inputs}).encode(),
        headers={"Authorization": f"Token {token}",
                 "Content-Type": "application/json"})
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def encode_image_base64(path: str) -> str:
    """data-URI helper matching the reference's init-image encoding."""
    with open(path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    return f"data:application/octet-stream;base64,{b64}"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="demos")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mm = sub.add_parser("multimodal")
    mm.add_argument("--image", required=True)
    mm.add_argument("--question", required=True)
    vid = sub.add_parser("video")
    vid.add_argument("--prompt", required=True)
    vid.add_argument("--out", default="output.mp4")
    rep = sub.add_parser("replicate")
    rep.add_argument("--version", required=True)
    rep.add_argument("--input-json", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "multimodal":
        print(multimodal_chat(args.image, args.question))
    elif args.cmd == "video":
        print(text_to_video(args.prompt, args.out))
    else:
        print(json.dumps(replicate_run(args.version,
                                       json.loads(args.input_json))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
