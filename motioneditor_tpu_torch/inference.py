"""Two-branch motion-editing inference, the port's entry point
(counterpart of scripts/inference.py):

    python -m motioneditor_tpu_torch.inference --config configs/smoke/eval.yaml \\
        [--device cuda|cpu]

The run is on the GPU unless ``--device cpu`` asks for the CPU; without a
CUDA device and without that flag it raises. Without weights at
``pretrained_model_path`` every model is randomly initialized from the
config's seed and prompts go through ``StubTokenizer`` (smoke-test mode).
Loading real checkpoints, stage-1 state and adapter weights is not ported
yet; a config that names them raises.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch

from motioneditor_tpu_torch.configs import RunConfig, load_config, save_config
from motioneditor_tpu_torch.models.clip_text import CLIPTextModel, StubTokenizer
from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
from motioneditor_tpu_torch.models.layers import init_params
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from motioneditor_tpu_torch.models.vae import AutoencoderKL
from motioneditor_tpu_torch.pipelines.editor import MotionEditorPipeline


def build_pipeline(cfg: RunConfig, device: torch.device) -> MotionEditorPipeline:
    """Random-init models from ``cfg.seed`` in ``cfg.compute_dtype``, on
    ``device``."""
    for path in (osp.join(cfg.pretrained_model_path, "unet"), cfg.resume_from_checkpoint,
                 cfg.adapter_weight_path):
        if path and osp.exists(path):
            raise NotImplementedError(f"loading weights ({path}) is not ported yet")
    print(f"WARNING: no pretrained weights at {cfg.pretrained_model_path}; "
          "using random init (smoke-test mode)")
    unet_config = UNetConfig(use_sc_attn=cfg.use_sc_attn, use_st_attn=cfg.use_st_attn,
                             st_attn_idx=cfg.st_attn_idx)
    gen = torch.Generator(device=device).manual_seed(cfg.seed or 0)
    with torch.device(device):
        models = dict(unet=UNet3DConditionModel(unet_config), vae=AutoencoderKL(),
                      text_encoder=CLIPTextModel(),
                      controlnet=ControlNetModel(controlnet_config(unet_config)))
    for m in models.values():
        init_params(m, gen)
        m.to(cfg.compute_dtype).eval()
    return MotionEditorPipeline(tokenizer=StubTokenizer(), unet_config=unet_config,
                                use_flash=cfg.use_flash_attention, **models)


def edit(pipe: MotionEditorPipeline, cfg: RunConfig, batch: Dict[str, object],
         generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
    """Encode the batch's frames (sampled from ``generator``, the VAE's mean
    without one), invert them (null-text inversion, or plain DDIM inversion
    when ``use_null_inv`` is off) and run the edit for each
    validation prompt. Returns {prompt: [2, F, H, W, 3] in [0, 1]}:
    [reconstruction, edit]."""
    vd = cfg.validation_data
    dev, dt = pipe.device, pipe.dtype
    video = torch.as_tensor(np.asarray(batch["pixel_values"]), device=dev).to(dt)[None]
    latents = pipe.encode_video(video, generator=generator)
    cond_name = cfg.input_data.condition[0]
    target_skel = torch.as_tensor(np.asarray(batch["target_conditions"][cond_name]),
                                  device=dev).to(dt)
    source_masks = torch.as_tensor(np.asarray(batch["source_masks"]), device=dev).float()
    prompt = batch["prompt"]
    if vd.use_null_inv:
        inv_latent, uncond_embeddings = pipe.null_text_inversion(
            latents, prompt, num_steps=vd.num_inv_steps, null_inner_steps=vd.null_inner_steps,
            null_base_lr=vd.null_base_lr, guidance_scale=vd.guidance_scale,
            early_stop_epsilon=vd.early_stop_epsilon)
    else:
        inv_latent = pipe.ddim_invert(latents, prompt="", num_inv_steps=vd.num_inv_steps,
                                      normal_infer=True)
        uncond_embeddings = None
    seed_latents = torch.cat([inv_latent, inv_latent], dim=0)
    out = {}
    for target in vd.prompts:
        sample = pipe([prompt, target], seed_latents, target_skel, source_masks=source_masks,
                      uncond_embeddings=uncond_embeddings,
                      num_inference_steps=vd.num_inference_steps,
                      guidance_scale=vd.guidance_scale,
                      controlnet_conditioning_scale=vd.controlnet_conditioning_scale)
        out[target] = sample.float().cpu().numpy()
    return out


def resolve_device(name: str) -> torch.device:
    """``cuda`` needs a CUDA device and raises without one; the CPU runs only
    when asked for by name."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name)


def main(config_path: str, device: str = "cuda") -> Dict[str, np.ndarray]:
    from motioneditor_tpu_torch.data.dataset import VideoDataset
    from motioneditor_tpu_torch.utils.video import save_videos_grid

    dev = resolve_device(device)
    cfg = load_config(config_path)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(osp.join(cfg.output_dir, "sample"), exist_ok=True)
    save_config(cfg, osp.join(cfg.output_dir, "config.yaml"))
    pipe = build_pipeline(cfg, dev)
    batch = VideoDataset(**vars(cfg.input_data))[0]
    gen = torch.Generator(device=dev).manual_seed(cfg.seed or 0)
    samples = edit(pipe, cfg, batch, gen)
    for target, sample in samples.items():
        save_videos_grid(sample[1:], f"{cfg.output_dir}/sample/{target}.gif", fps=cfg.fps)
        save_videos_grid(sample[:1], f"{cfg.output_dir}/sample/{target}-inv.gif", fps=cfg.fps)
        print(f"saved {cfg.output_dir}/sample/{target}.gif")
    return samples


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    main(args.config, args.device)
