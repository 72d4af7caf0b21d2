"""Stage-1 appearance fine-tune, the port's entry point (counterpart of
scripts/train_bg.py):

    python -m motioneditor_tpu_torch.train_bg --config configs/smoke/train-bg.yaml \\
        [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` asks for the CPU. The models are
randomly initialized from the config's seed (``inference.build_pipeline``),
the clip's frames are encoded once, and ``max_train_steps`` steps of
``train_step_stage1`` follow, saving ``checkpoint-<N>/`` every
``checkpointing_steps``. Step ``i`` draws its noise and timesteps from a
generator seeded by (seed, i), so a run resumed at step N draws what an
uninterrupted run draws there.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time
from typing import Dict, List

import numpy as np
import torch

from motioneditor_tpu_torch.configs import RunConfig, load_config, save_config
from motioneditor_tpu_torch.inference import build_pipeline, resolve_device
from motioneditor_tpu_torch.models.clip_text import clip_text_apply, tokenize
from motioneditor_tpu_torch.pipelines.editor import MotionEditorPipeline
from motioneditor_tpu_torch.schedulers import DiffusionSchedule
from motioneditor_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    restore_train_state,
    save_train_state,
)
from motioneditor_tpu_torch.training.common import TrainState, make_optimizer, make_train_state
from motioneditor_tpu_torch.training.stage1 import TRAINABLE_MODULES, train_step_stage1


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of training step ``step``: a function of (seed, step)
    only, the property of ``jax.random.fold_in(key, step)``."""
    return torch.Generator(device=device).manual_seed((seed or 0) * 1_000_003 + step)


def setup_run(cfg: RunConfig, device: torch.device, need_controlnet: bool):
    """Write the config copy; return the fp32 models, the dataset and the
    frozen dtype (the compute dtype when it is not fp32)."""
    from motioneditor_tpu_torch.data.dataset import VideoDataset

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(cfg.output_dir, exist_ok=True)
    save_config(cfg, osp.join(cfg.output_dir, "config.yaml"))
    # fp32 models: the trainables stay fp32 masters, make_train_state casts the rest
    pipe = build_pipeline(cfg, device, dtype=torch.float32, need_controlnet=need_controlnet)
    ds = VideoDataset(**vars(cfg.input_data))
    frozen = cfg.compute_dtype if cfg.compute_dtype != torch.float32 else None
    return pipe, ds, frozen


def encode_clip(pipe: MotionEditorPipeline, cfg: RunConfig, batch, prompt: str):
    """(latents sampled from the VAE posterior, fp32 text embedding)."""
    dev = pipe.device
    video = torch.as_tensor(np.asarray(batch["pixel_values"]), device=dev)[None]
    gen = torch.Generator(device=dev).manual_seed(cfg.seed or 0)
    latents = pipe.encode_video(video, generator=gen)
    ids = tokenize(pipe.tokenizer, [prompt], pipe.text_config.max_position_embeddings)
    with torch.no_grad():
        enc = clip_text_apply(pipe.text_encoder, ids.to(dev), pipe.text_config)
    return latents, enc


def config_optimizer(cfg: RunConfig, stage1: bool):
    """The config's optimizer; as in the JAX scripts, ``scale_lr`` and
    ``use_8bit_adam`` apply to stage 1 only."""
    lr = cfg.learning_rate
    if stage1 and cfg.scale_lr:
        lr *= cfg.gradient_accumulation_steps * cfg.train_batch_size
    return make_optimizer(lr, cfg.adam_beta1, cfg.adam_beta2, cfg.adam_epsilon,
                          cfg.adam_weight_decay, cfg.max_grad_norm,
                          use_8bit=stage1 and cfg.use_8bit_adam)


def log_step(step: int, cfg: RunConfig, loss: torch.Tensor, t0: float) -> None:
    if step % 10 == 0 or step == 1:
        print(f"step {step}/{cfg.max_train_steps} loss={float(loss):.5f} "
              f"({(time.time() - t0) / step:.2f}s/step)")


def weights_changed(state: TrainState, initial: Dict[str, torch.Tensor]) -> bool:
    return any(not torch.equal(p, initial[n]) for n, p in state.trainable.items())


def main(config_path: str, device: str = "cuda") -> List[float]:
    dev = resolve_device(device)
    cfg = load_config(config_path)
    pipe, ds, frozen = setup_run(cfg, dev, need_controlnet=False)
    state = make_train_state(pipe.unet, TRAINABLE_MODULES, config_optimizer(cfg, stage1=True),
                             frozen_dtype=frozen)
    if cfg.resume_from_checkpoint:
        ck = ((cfg.resume_from_checkpoint, None) if cfg.resume_from_checkpoint != "latest"
              else latest_checkpoint(cfg.output_dir))
        if ck:
            state = restore_train_state(ck[0], state)
            print(f"resumed from {ck[0]} at step {state.step}")
    latents, enc = encode_clip(pipe, cfg, ds[0], ds.prompt)
    initial = {n: p.detach().clone() for n, p in state.trainable.items()}
    schedule = DiffusionSchedule()
    losses = []
    t0 = time.time()
    while state.step < cfg.max_train_steps:
        state, metrics = train_step_stage1(
            state, latents, enc, step_generator(cfg.seed, state.step, dev),
            unet_config=pipe.unet_config, schedule=schedule,
            use_flash=cfg.use_flash_attention, remat=cfg.gradient_checkpointing,
            compute_dtype=frozen, accum_steps=cfg.gradient_accumulation_steps)
        step = state.step
        losses.append(float(metrics["loss"]))
        log_step(step, cfg, metrics["loss"], t0)
        if step % cfg.checkpointing_steps == 0:
            print(f"saved state to {save_train_state(cfg.output_dir, step, state)}")
        if step % cfg.validation_steps == 0 or step == cfg.max_train_steps:
            # the weight-change probe (train_bg.py:371-384), also after the last step
            print("The weights of the model have changed after training"
                  if weights_changed(state, initial)
                  else "The weights of the model remain the same after training")
    print("done")
    return losses


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    main(args.config, args.device)
