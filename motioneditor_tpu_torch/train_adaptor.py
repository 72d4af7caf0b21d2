"""Stage-2 motion-adapter training, the port's entry point (counterpart of
scripts/train_adaptor.py):

    python -m motioneditor_tpu_torch.train_adaptor --config configs/smoke/train-motion.yaml \\
        [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` asks for the CPU. Loads the stage-1
checkpoint that ``one_stage_checkpoint`` names (when it exists), trains
only ``controlnet_adapter`` against the frozen ControlNet on the source
skeleton, and saves ``checkpoint-<N>/`` and
``controlnet_adapter_checkpoint-<N>/`` every ``checkpointing_steps``.
"""

from __future__ import annotations

import argparse
import os.path as osp
import time
from typing import List

import numpy as np
import torch

from motioneditor_tpu_torch.configs import load_config
from motioneditor_tpu_torch.inference import resolve_device
from motioneditor_tpu_torch.schedulers import DiffusionSchedule
from motioneditor_tpu_torch.train_bg import (
    config_optimizer,
    encode_clip,
    log_step,
    setup_run,
    step_generator,
)
from motioneditor_tpu_torch.training.checkpoint import (
    load_trainables,
    save_adapter,
    save_train_state,
)
from motioneditor_tpu_torch.training.common import make_train_state
from motioneditor_tpu_torch.training.stage2 import TRAINABLE_MODULES, train_step_stage2


def main(config_path: str, device: str = "cuda") -> List[float]:
    dev = resolve_device(device)
    cfg = load_config(config_path)
    pipe, ds, frozen = setup_run(cfg, dev, need_controlnet=True)
    # the stage-1 state first (train_adaptor.py:301-302)
    if cfg.one_stage_checkpoint and osp.isdir(cfg.one_stage_checkpoint):
        load_trainables(cfg.one_stage_checkpoint, pipe.unet)
        print(f"loaded stage-1 checkpoint {cfg.one_stage_checkpoint}")
    state = make_train_state(pipe.unet, TRAINABLE_MODULES, config_optimizer(cfg, stage1=False),
                             frozen_dtype=frozen)
    controlnet = pipe.controlnet.to(frozen) if frozen is not None else pipe.controlnet
    controlnet.requires_grad_(False)
    batch = ds[0]
    latents, enc = encode_clip(pipe, cfg, batch, ds.prompt)
    cond_name = cfg.input_data.condition[0]
    source_skel = torch.as_tensor(np.asarray(batch["source_conditions"][cond_name]),
                                  device=dev)[None]
    schedule = DiffusionSchedule()
    losses = []
    t0 = time.time()
    while state.step < cfg.max_train_steps:
        state, metrics = train_step_stage2(
            state, controlnet, latents, source_skel, enc,
            step_generator(cfg.seed, state.step, dev), unet_config=pipe.unet_config,
            controlnet_config=pipe.controlnet_config, schedule=schedule,
            use_flash=cfg.use_flash_attention, remat=cfg.gradient_checkpointing,
            compute_dtype=frozen)
        step = state.step
        losses.append(float(metrics["loss"]))
        log_step(step, cfg, metrics["loss"], t0)
        if step % cfg.checkpointing_steps == 0:
            path = save_train_state(cfg.output_dir, step, state)
            apath = save_adapter(cfg.output_dir, step, state.model.controlnet_adapter)
            print(f"saved state to {path}; adapter to {apath}")
    print("done")
    return losses


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    main(args.config, args.device)
