"""Stage-2 adapter training (port of motioneditor_tpu/training/stage2.py).

Only ``controlnet_adapter`` trains (train_adaptor.py:170-173). Each step
runs the frozen ControlNet on the source skeleton over the noisy latents
without gradients (:347-371); its residuals go to the UNet's adapter
branch for a batch other than 4, where the adapter cross-attends to the
UNet's own down features (unet_2d_condition.py:482-485).

Frame-sharded (``shard_ctx``, parallel/mesh.py), as stage 1 is: each rank
holds its block of the latents', the skeleton's and the text's batch and
of the frames; the noise and timesteps are drawn at the global shape and
sliced, the frozen ControlNet is per frame and runs on the local frames,
the UNet and its adapter communicate over the frame group, each rank's
loss is its share of the global mean, and the adapter's gradients are
summed over the shard group (the frame x data ranks of one model rank)
before the optimizer step (JAX stage2.py:31-98); under a model group the
adapter's split attention projections keep their blocks' gradients, as
in stage 1.
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
    draw_noise_sharded,
    mse,
    sum_step_over_shards,
)
from motioneditor_tpu_torch.utils.profiling import span, spanned

TRAINABLE_MODULES = ("controlnet_adapter",)


def stage2_loss(model: UNet3DConditionModel, controlnet: ControlNetModel,
                unet_config: UNetConfig, controlnet_config: UNetConfig, latents: torch.Tensor,
                source_skeleton: torch.Tensor, encoder_hidden_states: torch.Tensor,
                noise: torch.Tensor, timesteps: torch.Tensor,
                schedule: DiffusionSchedule = DiffusionSchedule(),
                prediction_type: str = "epsilon", use_flash: bool = True, remat: bool = True,
                compute_dtype: Optional[torch.dtype] = None, shard_ctx=None) -> torch.Tensor:
    """The adapter's denoising loss (stage2.py:53-100). source_skeleton:
    [B, F, H, W, 3] in [0, 1]. ``shard_ctx``: every input is this rank's
    block, and the loss is this rank's share."""
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
                      mid_block_additional_residual=mid_res, use_flash=use_flash, remat=remat,
                      shard_ctx=shard_ctx)
    return mse(pred, target, shard_ctx)


@spanned("me.train_step")
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
    shard_ctx=None,
) -> Tuple[TrainState, dict]:
    """One optimizer step of the adapter on ``state`` (updated in place and
    returned); the noise and timesteps come from ``generator``. Returns the
    loss as a 0-d tensor on the device. ``shard_ctx``: latents,
    source_skeleton and encoder_hidden_states are this rank's blocks (see
    the module docstring); under a model group ``state.model`` and
    ``controlnet`` come split by parallel/tp.py ``shard_params_tp``, and every
    model rank passes the same blocks and generator state."""
    state.optimizer.zero_grad()
    with span("me.forward"):
        if shard_ctx is None:
            noise, t = draw_noise(latents, generator, schedule.num_train_timesteps)
        else:
            noise, t = draw_noise_sharded(latents, generator, schedule.num_train_timesteps,
                                          shard_ctx, draw_noise)
        loss = stage2_loss(state.model, controlnet, unet_config, controlnet_config, latents,
                           source_skeleton, encoder_hidden_states, noise, t, schedule,
                           prediction_type, use_flash, remat, compute_dtype, shard_ctx)
    with span("me.backward"):
        loss.backward()
    loss = loss.detach()
    if shard_ctx is not None:
        loss = sum_step_over_shards(loss, state.optimizer, shard_ctx)
    state.optimizer.step(shard_ctx)
    state.step += 1
    return state, {"loss": loss}
