"""Stage-1 appearance fine-tune (port of motioneditor_tpu/training/stage1.py).

One-shot tune of the inflated UNet on the source video: everything frozen
but attn1.to_q / attn2.to_q / attn_temp (train_bg.py:100-104), the DDPM
epsilon (or velocity) regression loss (:328-343), AdamW with global-norm
clipping (:202-208, :347-352).

Frame-sharded (``shard_ctx``, parallel/mesh.py): each rank holds its block
of the latents' batch and frames. The noise and timesteps are drawn at the
global shape from the shared generator and sliced, each rank's loss is its
share of the global mean, the reported loss is their sum over the shard
group (the frame x data ranks of one model rank), and the trainables'
gradients are summed over it before the global-norm clip, so every rank
takes the same optimizer step (JAX's GSPMD psum, stage1.py:31-75). Under a
model group (parallel/tp.py) the model ranks hold the same tokens: a split
trainable's gradient stays its block's, and the clip's norm and the 8-bit
moments' scales are reduced over the model group
(training/common.py, training/adam8bit.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

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

TRAINABLE_MODULES = ("attn1.to_q", "attn2.to_q", "attn_temp")


def stage1_loss(model: UNet3DConditionModel, unet_config: UNetConfig, latents: torch.Tensor,
                encoder_hidden_states: torch.Tensor, noise: torch.Tensor,
                timesteps: torch.Tensor, schedule: DiffusionSchedule = DiffusionSchedule(),
                prediction_type: str = "epsilon", use_flash: bool = True, remat: bool = True,
                compute_dtype: Optional[torch.dtype] = None, shard_ctx=None,
                added_cond_kwargs: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """The denoising loss of one micro-batch (stage1.py:58-75): noise the
    latents at ``timesteps``, run the UNet in ``compute_dtype`` (the
    parameters' dtype when None), and take the fp32 mean squared error
    against the noise or the velocity; with ``shard_ctx``, this rank's share
    of it from its local blocks. ``added_cond_kwargs``: a text_time
    configuration's pooled text and time ids (models/unet.py)."""
    noisy = ddpm_add_noise(schedule, latents, noise, timesteps)
    target = diffusion_target(schedule, latents, noise, timesteps, prediction_type)
    x_in, enc_in = noisy, encoder_hidden_states
    if compute_dtype is not None:
        x_in, enc_in = noisy.to(compute_dtype), enc_in.to(compute_dtype)
    pred = unet_apply(model, unet_config, x_in, timesteps, enc_in, use_flash=use_flash,
                      remat=remat, shard_ctx=shard_ctx, added_cond_kwargs=added_cond_kwargs)
    return mse(pred, target, shard_ctx)


@spanned("me.train_step")
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
    shard_ctx=None,
    added_cond_kwargs: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[TrainState, dict]:
    """One optimizer step on ``state`` (updated in place and returned).
    latents: [B, F, h, w, 4] (VAE latents x 0.18215); encoder_hidden_states:
    [B, 77, 768]. Each of the ``accum_steps`` micro-batches draws its noise
    and timesteps from ``generator``; their losses and gradients are
    averaged (accelerator.accumulate, train_bg.py:312). Returns the mean
    loss as a 0-d tensor on the device (no host synchronization).
    ``shard_ctx``: latents and encoder_hidden_states are this rank's blocks
    (see the module docstring); under a model group ``state.model`` comes
    split by parallel/tp.py ``shard_params_tp`` before ``make_train_state``,
    and every model rank passes the same blocks and generator state.
    ``added_cond_kwargs``: a text_time (SDXL) configuration's ``text_embeds``
    [B, D] and ``time_ids`` [B, 6], the same for every micro-batch."""
    state.optimizer.zero_grad()
    total = 0.0
    for _ in range(accum_steps):
        with span("me.forward"):
            if shard_ctx is None:
                noise, t = draw_noise(latents, generator, schedule.num_train_timesteps)
            else:
                noise, t = draw_noise_sharded(latents, generator, schedule.num_train_timesteps,
                                              shard_ctx, draw_noise)
            loss = stage1_loss(state.model, unet_config, latents, encoder_hidden_states, noise,
                               t, schedule, prediction_type, use_flash, remat, compute_dtype,
                               shard_ctx, added_cond_kwargs)
        with span("me.backward"):
            (loss / accum_steps).backward()
        total = total + loss.detach()
    if shard_ctx is not None:
        total = sum_step_over_shards(total, state.optimizer, shard_ctx)
    state.optimizer.step(shard_ctx)
    state.step += 1
    return state, {"loss": total / accum_steps}
