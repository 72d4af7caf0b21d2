"""The two-branch injected denoise loop (port of the body of
motioneditor_tpu/pipelines/editor.py:_jit_denoise_segment).

One step: batch the latents and text as 4 rows [recon_u, edit_u, recon_c,
edit_c]; run the ControlNet on the edit rows only; zero its mid residual on
the recon rows; run the video UNet with the adapter, fg/bg attention
injection and temporal K/V injection; apply CFG and the DDIM step. The JAX
``lax.scan`` over timesteps is a Python loop here. Prompt-to-prompt, local
blend and sharding are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from motioneditor_tpu_torch.control.injection import InjectionSpec
from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_apply
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig, unet_apply
from motioneditor_tpu_torch.schedulers import DiffusionSchedule, ddim_step


@torch.no_grad()
def denoise_segment(
    unet: UNet3DConditionModel,
    unet_config: UNetConfig,
    controlnet: ControlNetModel,
    controlnet_config: UNetConfig,
    schedule: DiffusionSchedule,
    num_steps: int,
    injection_spec: Optional[InjectionSpec],
    guidance_scale: float,
    controlnet_scale: float,
    latents: torch.Tensor,
    seg_ts: Sequence[int],
    cond: torch.Tensor,
    uncond: torch.Tensor,
    cond_embedding: torch.Tensor,
    masks: Optional[Dict[Tuple[int, int], torch.Tensor]],
    use_flash: bool = True,
) -> torch.Tensor:
    """Run the denoise steps ``seg_ts`` (descending timesteps of a
    ``num_steps`` schedule) from ``latents`` [2, F, h, w, 4] = [recon, edit].

    cond / uncond: [2, L, D] text embeddings (per-step null-text uncond
    embeddings come with the inversion slice). cond_embedding: the
    ControlNet conditioning embedding of both rows. Returns the latents
    after the last step."""
    lat = latents
    for t in seg_ts:
        t = int(t)
        latent_in = torch.cat([lat, lat], dim=0)
        text_in = torch.cat([uncond, cond], dim=0)
        edit_rows = [1, 3]  # ControlNet runs on the edit rows only
        down_res, mid_res = controlnet_apply(
            controlnet, controlnet_config, latent_in[edit_rows], t, text_in[edit_rows],
            cond_embedding, conditioning_scale=controlnet_scale, use_flash=use_flash)
        zero_mid = torch.zeros_like(mid_res[:1])
        mid4 = torch.cat([zero_mid, mid_res[:1], zero_mid, mid_res[1:2]], dim=0)
        eps = unet_apply(
            unet, unet_config, latent_in, t, text_in,
            injection=injection_spec, injection_masks=masks,
            down_block_additional_residuals=down_res,
            mid_block_additional_residual=mid4, use_flash=use_flash)
        eps_u, eps_c = eps.chunk(2, dim=0)
        eps_g = eps_u + guidance_scale * (eps_c - eps_u)
        lat = ddim_step(schedule, eps_g, t, lat, num_steps)
    return lat
