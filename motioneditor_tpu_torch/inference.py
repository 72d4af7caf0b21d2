"""Two-branch motion-editing inference, the port's entry point
(counterpart of scripts/inference.py):

    python -m motioneditor_tpu_torch.inference --config configs/smoke/eval.yaml \\
        [--device cuda|cpu]

The run is on the GPU unless ``--device cpu`` asks for the CPU; without a
CUDA device and without that flag it raises. Without weights at
``pretrained_model_path`` every model is randomly initialized from the
config's seed and prompts go through ``StubTokenizer`` (smoke-test mode).
A diffusers SD-1.5 directory there (``unet/``, ``vae/``, ``text_encoder/``,
``tokenizer/``), a ControlNet directory at ``controlnet_path``, the
reference's ``.pth`` adapter and this package's training checkpoints load
through ``build_pipeline``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch

from motioneditor_tpu_torch.configs import RunConfig, load_config, save_config
from motioneditor_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextModel, StubTokenizer
from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
from motioneditor_tpu_torch.models.layers import init_params
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from motioneditor_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from motioneditor_tpu_torch.pipelines.editor import MotionEditorPipeline


def build_pipeline(cfg: RunConfig, device: torch.device, dtype: Optional[torch.dtype] = None,
                   need_controlnet: bool = True, unet_config: Optional[UNetConfig] = None,
                   vae_config: VAEConfig = VAEConfig(),
                   text_config: CLIPTextConfig = CLIPTextConfig(),
                   tokenizer=None) -> MotionEditorPipeline:
    """The pipeline's models on ``device`` in ``dtype`` (``cfg.compute_dtype``
    when None), at SD-1.5's widths unless the model configs say otherwise
    (scripts/inference.py:33-111):

    - with a diffusers SD-1.5 directory at ``pretrained_model_path`` (one
      with ``unet/``), its UNet (the temporal modules and the adapter from
      ``cfg.seed``), VAE and text encoder, the tokenizer from its
      ``tokenizer/`` (``load_clip_tokenizer``, which needs transformers)
      unless ``tokenizer`` is given, and the ControlNet from
      ``controlnet_path`` when that is a directory, else from ``cfg.seed``;
    - without one, every model from ``cfg.seed`` and ``StubTokenizer``
      unless ``tokenizer`` is given (smoke-test mode);

    then the stage-1 checkpoint (``resume_from_checkpoint``, a
    ``checkpoint-<N>/`` directory) and the adapter (``adapter_weight_path``:
    the reference's ``.pth`` or this package's
    ``controlnet_adapter_checkpoint-<N>/``) when the config names them.
    ``need_controlnet=False`` builds and reads no ControlNet."""
    from motioneditor_tpu_torch.models import weights as W
    from motioneditor_tpu_torch.models.clip_text import load_clip_tokenizer
    from motioneditor_tpu_torch.training.checkpoint import load_adapter, load_trainables

    unet_config = unet_config or UNetConfig(
        use_sc_attn=cfg.use_sc_attn, use_st_attn=cfg.use_st_attn, st_attn_idx=cfg.st_attn_idx)
    gen = torch.Generator(device=device).manual_seed(cfg.seed or 0)
    path = cfg.pretrained_model_path
    if osp.isdir(osp.join(path, "unet")):
        print(f"loading SD-1.5 weights from {path}")
        models = dict(unet=W.load_sd15_unet(path, unet_config, gen, device),
                      vae=W.load_sd15_vae(path, vae_config, device),
                      text_encoder=W.load_sd15_text_encoder(path, text_config, device),
                      controlnet=None)
        tokenizer = tokenizer or load_clip_tokenizer(path)
        if need_controlnet and osp.isdir(cfg.controlnet_path):
            models["controlnet"] = W.load_controlnet(
                cfg.controlnet_path, controlnet_config(unet_config), device)
        elif need_controlnet:
            with torch.device(device):
                models["controlnet"] = init_params(
                    ControlNetModel(controlnet_config(unet_config)), gen)
    else:
        print(f"WARNING: no pretrained weights at {path}; using random init (smoke-test mode)")
        with torch.device(device):
            models = dict(unet=UNet3DConditionModel(unet_config), vae=AutoencoderKL(vae_config),
                          text_encoder=CLIPTextModel(text_config),
                          controlnet=(ControlNetModel(controlnet_config(unet_config))
                                      if need_controlnet else None))
        for m in models.values():
            if m is not None:
                init_params(m, gen)
        tokenizer = tokenizer or StubTokenizer()
    for m in models.values():
        if m is not None:
            m.to(dtype or cfg.compute_dtype).eval()
    unet = models["unet"]
    if cfg.resume_from_checkpoint and osp.isdir(cfg.resume_from_checkpoint):
        load_trainables(cfg.resume_from_checkpoint, unet)
        print(f"restored stage-1 state from {cfg.resume_from_checkpoint}")
    if cfg.adapter_weight_path and cfg.adapter_weight_path.endswith(".pth"):
        W.load_adapter_checkpoint(cfg.adapter_weight_path, unet.controlnet_adapter)
        print(f"loaded adapter weights from {cfg.adapter_weight_path}")
    elif cfg.adapter_weight_path and osp.isdir(cfg.adapter_weight_path):
        load_adapter(cfg.adapter_weight_path, unet.controlnet_adapter)
        print(f"loaded adapter weights from {cfg.adapter_weight_path}")
    return MotionEditorPipeline(tokenizer=tokenizer, unet_config=unet_config,
                                vae_config=vae_config, text_config=text_config,
                                use_flash=cfg.use_flash_attention, **models)


def edit(pipe: MotionEditorPipeline, cfg: RunConfig, batch: Dict[str, object],
         generator: Optional[torch.Generator] = None) -> Dict[str, np.ndarray]:
    """Encode the batch's frames (sampled from ``generator``, the VAE's mean
    without one), invert them (null-text inversion, or plain DDIM inversion
    when ``use_null_inv`` is off) and run the edit for each
    validation prompt, under prompt-to-prompt control when ``use_p2p`` is
    on (``p2p_control``). Returns {prompt: [2, F, H, W, 3] in [0, 1]}:
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
        prompts = [prompt, target]
        controller, blend = p2p_control(vd, prompts, pipe.tokenizer)
        sample = pipe(prompts, seed_latents, target_skel, source_masks=source_masks,
                      uncond_embeddings=uncond_embeddings,
                      num_inference_steps=vd.num_inference_steps,
                      guidance_scale=vd.guidance_scale,
                      controlnet_conditioning_scale=vd.controlnet_conditioning_scale,
                      p2p_controller=controller, local_blend=blend)
        out[target] = sample.float().cpu().numpy()
    return out


def p2p_control(vd, prompts, tokenizer):
    """(controller, LocalBlend) of the config's p2p settings for the prompt
    pair [source, target], (None, None) when ``use_p2p`` is off: reweight
    with ``p2p_eq_words``, else replace or refine by word count, and a
    LocalBlend of ``p2p_blend_words`` when there are any
    (scripts/inference.py:166-191)."""
    from motioneditor_tpu_torch.control.p2p import make_controller, make_local_blend

    if not vd.use_p2p:
        return None, None
    controller = make_controller(
        prompts, tokenizer, vd.num_inference_steps,
        cross_replace_steps=vd.p2p_cross_replace_steps,
        self_replace_steps=vd.p2p_self_replace_steps,
        equalizer_words=list(vd.p2p_eq_words) or None,
        equalizer_values=list(vd.p2p_eq_values) or None)
    blend = None
    if vd.p2p_blend_words:
        blend = make_local_blend(prompts, [list(vd.p2p_blend_words)] * 2, tokenizer,
                                 threshold=vd.p2p_blend_threshold)
    print(f"p2p control: {controller.kind}" + (" + LocalBlend" if blend else ""))
    return controller, blend


def resolve_device(name) -> torch.device:
    """The device ``name`` (a string or a ``torch.device``): ``cuda`` needs a
    CUDA device and raises without one; the CPU runs only when asked for by
    name."""
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return device


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
