"""Stage-2 adapter training (port of motioneditor_tpu/training/stage2.py).

Only ``controlnet_adapter`` trains (train_adaptor.py:170-173). Each step
runs the frozen ControlNet on the source skeleton over the noisy latents
without gradients (:347-371); its residuals go to the UNet's adapter
branch for a batch other than 4, where the adapter cross-attends to the
UNet's own down features (unet_2d_condition.py:482-485).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from motioneditor_tpu_torch.models.controlnet import (
    ControlNetModel,
    controlnet_apply,
    precompute_cond_embedding,
)
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig, unet_apply
from motioneditor_tpu_torch.schedulers import DiffusionSchedule, ddpm_add_noise
from motioneditor_tpu_torch.training.common import (
    TrainState,
    diffusion_target,
    draw_noise,
    mse,
)

TRAINABLE_MODULES = ("controlnet_adapter",)


def stage2_loss(model: UNet3DConditionModel, controlnet: ControlNetModel,
                unet_config: UNetConfig, controlnet_config: UNetConfig, latents: torch.Tensor,
                source_skeleton: torch.Tensor, encoder_hidden_states: torch.Tensor,
                noise: torch.Tensor, timesteps: torch.Tensor,
                schedule: DiffusionSchedule = DiffusionSchedule(),
                prediction_type: str = "epsilon", use_flash: bool = True, remat: bool = True,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The adapter's denoising loss (stage2.py:53-100). source_skeleton:
    [B, F, H, W, 3] in [0, 1]."""
    noisy = ddpm_add_noise(schedule, latents, noise, timesteps)
    target = diffusion_target(schedule, latents, noise, timesteps, prediction_type)
    x_in, enc_in, skel_in = noisy, encoder_hidden_states, source_skeleton
    if compute_dtype is not None:
        x_in, enc_in, skel_in = (a.to(compute_dtype) for a in (x_in, enc_in, skel_in))
    with torch.no_grad():
        down_res, mid_res = controlnet_apply(
            controlnet, controlnet_config, x_in, timesteps, enc_in,
            precompute_cond_embedding(controlnet, skel_in), conditioning_scale=1.0,
            use_flash=use_flash)
    pred = unet_apply(model, unet_config, x_in, timesteps, enc_in,
                      down_block_additional_residuals=down_res,
                      mid_block_additional_residual=mid_res, use_flash=use_flash, remat=remat)
    return mse(pred, target)


def train_step_stage2(
    state: TrainState,
    controlnet: ControlNetModel,
    latents: torch.Tensor,
    source_skeleton: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    generator: torch.Generator,
    unet_config: UNetConfig,
    controlnet_config: UNetConfig,
    schedule: DiffusionSchedule = DiffusionSchedule(),
    prediction_type: str = "epsilon",
    use_flash: bool = True,
    remat: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[TrainState, dict]:
    """One optimizer step of the adapter on ``state`` (updated in place and
    returned); the noise and timesteps come from ``generator``. Returns the
    loss as a 0-d tensor on the device."""
    state.optimizer.zero_grad()
    noise, t = draw_noise(latents, generator, schedule.num_train_timesteps)
    loss = stage2_loss(state.model, controlnet, unet_config, controlnet_config, latents,
                       source_skeleton, encoder_hidden_states, noise, t, schedule,
                       prediction_type, use_flash, remat, compute_dtype)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, {"loss": loss.detach()}
