"""Edit-quality evaluation, the port's counterpart of scripts/evaluate.py:

    python -m motioneditor_tpu_torch.evaluate --source <dir-or-gif> \\
        [--recon <gif>] [--edit <gif>] [--prompt "a man is dancing"] \\
        [--clip_path checkpoints/clip-vit-large-patch14] \\
        [--lpips_path checkpoints/lpips] [--out metrics.json] [--device cuda|cpu]

Prints one JSON object of metrics:

  - recon_psnr / recon_ssim: the reconstruction against the source
  - edit_temporal_consistency: 1 - mean adjacent-frame L1 of the edit
  - edit_clip_score / edit_frame_clip_consistency: with ``--prompt`` and an
    openai clip-vit-large-patch14 checkpoint directory at ``--clip_path``
    (its weights file and tokenizer files, read with ``transformers``)
  - recon_lpips: with a directory at ``--lpips_path`` holding torchvision's
    ``alexnet.pth`` and the lpips package's ``alex.pth``

The metrics run on the GPU unless ``--device cpu`` asks for the CPU;
without a CUDA device and without that flag it raises. The CLIP and LPIPS
branches run only when their checkpoint directories exist.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
from typing import Dict, Optional, Sequence

import numpy as np
import torch

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


def load_video(path: str) -> np.ndarray:
    """A GIF / MP4 file or a directory of frames -> [F, H, W, 3] in [0, 1].
    A directory may be a flat frame directory or a case directory
    (``data/case-N`` with an ``images/`` subdirectory); entries that are not
    images are skipped."""
    import imageio
    from PIL import Image

    if osp.isdir(path):
        from glob import glob

        if osp.isdir(osp.join(path, "images")):
            path = osp.join(path, "images")
        frame_paths = [p for p in sorted(glob(osp.join(path, "*")))
                       if p.lower().endswith(_IMAGE_EXTS)]
        if not frame_paths:
            raise FileNotFoundError(f"no image frames ({'/'.join(_IMAGE_EXTS)}) in {path}")
        return np.stack([np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
                         for p in frame_paths])
    reader = imageio.get_reader(path)
    return np.stack([np.asarray(f, np.float32)[..., :3] / 255.0 for f in reader])


def match(a: np.ndarray, b: np.ndarray):
    """Two videos aligned for the pixel metrics: cut to the common frame
    count, and the larger resolution resized (bilinear, through PIL) to the
    smaller one's, so a full-size source is compared whole with a generation
    at the config's size."""
    from PIL import Image

    f = min(a.shape[0], b.shape[0])
    a, b = a[:f], b[:f]
    h, w = min(a.shape[1], b.shape[1]), min(a.shape[2], b.shape[2])

    def resize_to(x):
        if x.shape[1] == h and x.shape[2] == w:
            return x
        return np.stack([np.asarray(Image.fromarray((np.clip(fr, 0, 1) * 255).astype(np.uint8))
                                    .resize((w, h), Image.BILINEAR), np.float32) / 255.0
                         for fr in x])

    return resize_to(a), resize_to(b)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` (read with the safetensors package) or a torch
    checkpoint, on the CPU."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def find_weights(model_dir: str) -> str:
    for name in _WEIGHT_FILES:
        if osp.isfile(osp.join(model_dir, name)):
            return osp.join(model_dir, name)
    raise FileNotFoundError(f"no model weights ({', '.join(_WEIGHT_FILES)}) in {model_dir}")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    from motioneditor_tpu_torch.eval.metrics import psnr, ssim, temporal_consistency
    from motioneditor_tpu_torch.inference import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--source", type=str, required=True)
    p.add_argument("--recon", type=str, default=None)
    p.add_argument("--edit", type=str, default=None)
    p.add_argument("--prompt", type=str, default=None)
    p.add_argument("--clip_path", type=str, default="checkpoints/clip-vit-large-patch14")
    p.add_argument("--lpips_path", type=str, default="checkpoints/lpips")
    p.add_argument("--out", type=str, default=None, help="also write the metrics JSON here")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def on(x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, device=dev)

    source = load_video(args.source)
    out: Dict[str, float] = {}
    if args.recon:
        s, r = match(source, load_video(args.recon))
        out["recon_psnr"] = float(psnr(on(r), on(s)))
        out["recon_ssim"] = float(ssim(on(r), on(s)))
        if osp.isdir(args.lpips_path):
            from motioneditor_tpu_torch.eval.lpips import lpips, port_lpips_alexnet

            model = port_lpips_alexnet(
                load_state_dict(osp.join(args.lpips_path, "alexnet.pth")),
                load_state_dict(osp.join(args.lpips_path, "alex.pth"))).to(dev)
            with torch.no_grad():
                out["recon_lpips"] = float(lpips(model, on(r), on(s)))
    if args.edit:
        edit = on(load_video(args.edit))
        out["edit_temporal_consistency"] = float(temporal_consistency(edit))
        if args.prompt and osp.isdir(args.clip_path):
            from transformers import CLIPTokenizer

            from motioneditor_tpu_torch.eval.metrics import clip_score, frame_clip_consistency
            from motioneditor_tpu_torch.models.clip_image import port_clip_image
            from motioneditor_tpu_torch.models.clip_text import load_clip_text

            sd = load_state_dict(find_weights(args.clip_path))
            image_model, text_model = port_clip_image(sd).to(dev), load_clip_text(sd).to(dev)
            tokenizer = CLIPTokenizer.from_pretrained(args.clip_path)
            with torch.no_grad():
                out["edit_clip_score"] = float(
                    clip_score(edit, args.prompt, image_model, text_model, tokenizer))
                out["edit_frame_clip_consistency"] = float(
                    frame_clip_consistency(edit, image_model))

    text = json.dumps(out, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return out


if __name__ == "__main__":
    main()
