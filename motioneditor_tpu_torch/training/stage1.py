"""Stage-1 appearance fine-tune (port of motioneditor_tpu/training/stage1.py).

One-shot tune of the inflated UNet on the source video: everything frozen
but attn1.to_q / attn2.to_q / attn_temp (train_bg.py:100-104), the DDPM
epsilon (or velocity) regression loss (:328-343), AdamW with global-norm
clipping (:202-208, :347-352).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig, unet_apply
from motioneditor_tpu_torch.schedulers import DiffusionSchedule, ddpm_add_noise
from motioneditor_tpu_torch.training.common import (
    TrainState,
    diffusion_target,
    draw_noise,
    mse,
)

TRAINABLE_MODULES = ("attn1.to_q", "attn2.to_q", "attn_temp")


def stage1_loss(model: UNet3DConditionModel, unet_config: UNetConfig, latents: torch.Tensor,
                encoder_hidden_states: torch.Tensor, noise: torch.Tensor,
                timesteps: torch.Tensor, schedule: DiffusionSchedule = DiffusionSchedule(),
                prediction_type: str = "epsilon", use_flash: bool = True, remat: bool = True,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The denoising loss of one micro-batch (stage1.py:58-75): noise the
    latents at ``timesteps``, run the UNet in ``compute_dtype`` (the
    parameters' dtype when None), and take the fp32 mean squared error
    against the noise or the velocity."""
    noisy = ddpm_add_noise(schedule, latents, noise, timesteps)
    target = diffusion_target(schedule, latents, noise, timesteps, prediction_type)
    x_in, enc_in = noisy, encoder_hidden_states
    if compute_dtype is not None:
        x_in, enc_in = noisy.to(compute_dtype), enc_in.to(compute_dtype)
    pred = unet_apply(model, unet_config, x_in, timesteps, enc_in, use_flash=use_flash,
                      remat=remat)
    return mse(pred, target)


def train_step_stage1(
    state: TrainState,
    latents: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    generator: torch.Generator,
    unet_config: UNetConfig,
    schedule: DiffusionSchedule = DiffusionSchedule(),
    prediction_type: str = "epsilon",
    use_flash: bool = True,
    remat: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
    accum_steps: int = 1,
) -> Tuple[TrainState, dict]:
    """One optimizer step on ``state`` (updated in place and returned).
    latents: [B, F, h, w, 4] (VAE latents x 0.18215); encoder_hidden_states:
    [B, 77, 768]. Each of the ``accum_steps`` micro-batches draws its noise
    and timesteps from ``generator``; their losses and gradients are
    averaged (accelerator.accumulate, train_bg.py:312). Returns the mean
    loss as a 0-d tensor on the device (no host synchronization)."""
    state.optimizer.zero_grad()
    total = 0.0
    for _ in range(accum_steps):
        noise, t = draw_noise(latents, generator, schedule.num_train_timesteps)
        loss = stage1_loss(state.model, unet_config, latents, encoder_hidden_states, noise, t,
                           schedule, prediction_type, use_flash, remat, compute_dtype)
        (loss / accum_steps).backward()
        total = total + loss.detach()
    state.optimizer.step()
    state.step += 1
    return state, {"loss": total / accum_steps}
