"""DDIM inversion, null-text optimization and the two-branch injected
denoise loop (port of motioneditor_tpu/pipelines/editor.py:
_jit_ddim_invert, _jit_null_optimization, _jit_denoise_segment, and the
chaining of MotionEditorPipeline.null_text_inversion).

Inversion runs the video UNet on the clip's latents, stepping the DDIM
schedule backwards. Null-text optimization then fits one uncond text
embedding per timestep so that the CFG denoise trajectory follows the
inversion trajectory: per timestep a fresh Adam on the embedding, through
a forward and backward of the whole UNet (the backward attention kernels
run here). The edit's denoise step batches the latents and text as 4 rows
[recon_u, edit_u, recon_c, edit_c]; runs the ControlNet on the edit rows
only; zeroes its mid residual on the recon rows; runs the video UNet with
the adapter, fg/bg attention injection and temporal K/V injection; applies
CFG and the DDIM step. The JAX ``lax.scan``/``while_loop`` loops are Python
loops here. Prompt-to-prompt, local blend and sharding are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from motioneditor_tpu_torch.control.injection import InjectionSpec
from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_apply
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig, unet_apply
from motioneditor_tpu_torch.schedulers import DiffusionSchedule, ddim_inverse_step, ddim_step

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@torch.no_grad()
def ddim_invert(
    unet: UNet3DConditionModel,
    unet_config: UNetConfig,
    schedule: DiffusionSchedule,
    latents: torch.Tensor,
    cond: torch.Tensor,
    num_steps: int,
    normal_infer: bool = True,
    use_flash: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain DDIM inversion of ``latents`` [B, F, h, w, 4] under the text
    embedding ``cond`` [1 or B, L, D], run in the latents' dtype;
    ``normal_infer`` turns the video attention variants off. Returns
    (x_T, all_latents [num_steps + 1, ...]) with all_latents[i] the latent
    after i inversion steps (x_0 first)."""
    ts = schedule.inference_timesteps(num_steps)
    cond_b = cond.to(latents.dtype).expand(latents.shape[0], *cond.shape[1:])
    lat = latents
    all_latents = [latents]
    for i in range(num_steps):
        t = int(ts[num_steps - i - 1])
        eps = unet_apply(unet, unet_config, lat, t, cond_b, normal_infer=normal_infer,
                         use_flash=use_flash)
        lat = ddim_inverse_step(schedule, eps, t, lat, num_steps)
        all_latents.append(lat)
    return lat, torch.stack(all_latents)


def _null_text_eps(unet, unet_config, lat, t: int, emb, compute_dtype: torch.dtype,
                   use_flash: bool) -> torch.Tensor:
    """The null-text UNet call: batch 1, motion_frame attention, no
    ControlNet or adapter; runs in ``compute_dtype``, returns fp32. The
    casts sit inside the graph, so a gradient reaches an fp32 ``emb``."""
    return unet_apply(unet, unet_config, lat.to(compute_dtype), t, emb.to(compute_dtype),
                      normal_infer=False, use_flash=use_flash).float()


def null_text_loss(unet, unet_config, schedule, num_steps: int, guidance_scale: float,
                   compute_dtype: torch.dtype, latent_cur, latent_prev, t: int, eps_cond,
                   uncond, use_flash: bool = True) -> torch.Tensor:
    """The null-text objective of one timestep: mean squared distance between
    the CFG DDIM step from ``latent_cur`` (uncond embedding ``uncond``,
    precomputed ``eps_cond``) and the inversion latent ``latent_prev``."""
    eps_u = _null_text_eps(unet, unet_config, latent_cur, t, uncond, compute_dtype, use_flash)
    eps = eps_u + guidance_scale * (eps_cond - eps_u)
    prev_rec = ddim_step(schedule, eps, t, latent_cur, num_steps)
    return ((prev_rec - latent_prev) ** 2).mean()


def null_optimization(
    unet: UNet3DConditionModel,
    unet_config: UNetConfig,
    schedule: DiffusionSchedule,
    all_latents: torch.Tensor,
    cond: torch.Tensor,
    uncond0: torch.Tensor,
    num_steps: int,
    inner_steps: int,
    base_lr: float,
    guidance_scale: float,
    compute_dtype: str = "float32",
    early_stop_epsilon: float = 1e-5,
    use_flash: bool = True,
) -> torch.Tensor:
    """Per-timestep Adam on the uncond embedding pinning the CFG trajectory
    to the inversion trajectory ``all_latents`` (from ``ddim_invert``).
    cond / uncond0: [1, L, D]. Returns the optimized embeddings
    [num_steps, 1, L, D] in fp32, one per denoise step.

    Outer step i (timestep ts[i], target all_latents[num_steps - 1 - i],
    start all_latents[-1]): lr = base_lr * (1 - i/100); a fresh Adam
    (0.9 / 0.999, eps 1e-8 after the square root); the inner loop runs
    ``while j < inner_steps and loss >= early_stop_epsilon + i * 2e-5``
    with ``loss`` the pre-update loss of the previous inner step (+inf at
    first), so one update always happens. eps_cond is computed once per
    timestep and reused by the loss and the latent advance: 2 plain UNet
    forwards plus ``inner_steps`` forward/backward pairs per timestep.

    ``compute_dtype`` is the UNet's parameter dtype, which it must match;
    the embedding, the Adam state, the DDIM step and the loss stay fp32.
    Freezes the UNet's parameters (requires_grad False): the gradient is
    taken with respect to the embedding only."""
    cdt = _DTYPES[compute_dtype]
    param_dtype = next(unet.parameters()).dtype
    if param_dtype != cdt:
        raise ValueError(f"compute_dtype {compute_dtype} != the UNet's {param_dtype}")
    unet.requires_grad_(False)
    ts = schedule.inference_timesteps(num_steps)
    all_latents = all_latents.float()
    uncond = uncond0.float()
    latent_cur = all_latents[-1]
    uncond_list = []
    for i in range(num_steps):
        t = int(ts[i])
        latent_prev = all_latents[num_steps - 1 - i]
        with torch.no_grad():
            eps_cond = _null_text_eps(unet, unet_config, latent_cur, t, cond, cdt, use_flash)
        # the schedules in fp32, as the reference computes them
        lr = float(np.float32(base_lr) * (np.float32(1.0) - np.float32(i) / np.float32(100.0)))
        thresh = float(np.float32(early_stop_epsilon) + np.float32(i) * np.float32(2e-5))
        m = torch.zeros_like(uncond)
        v = torch.zeros_like(uncond)
        j, loss = 0, torch.tensor(float("inf"))
        # `loss >= thresh` syncs with the device; it is read only when
        # another inner step may follow (never when inner_steps == 1)
        while j < inner_steps and bool(loss >= thresh):
            u = uncond.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = null_text_loss(unet, unet_config, schedule, num_steps, guidance_scale,
                                      cdt, latent_cur, latent_prev, t, eps_cond, u, use_flash)
                (g,) = torch.autograd.grad(loss, u)
            loss = loss.detach()
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            jf = np.float32(j + 1)
            mhat = m / float(np.float32(1.0) - np.float32(0.9) ** jf)
            vhat = v / float(np.float32(1.0) - np.float32(0.999) ** jf)
            uncond = uncond - lr * mhat / (vhat.sqrt() + 1e-8)
            j += 1
        with torch.no_grad():
            eps_u = _null_text_eps(unet, unet_config, latent_cur, t, uncond, cdt, use_flash)
            latent_cur = ddim_step(schedule, eps_u + guidance_scale * (eps_cond - eps_u), t,
                                   latent_cur, num_steps)
        uncond_list.append(uncond)
    return torch.stack(uncond_list)


def null_text_inversion(
    unet: UNet3DConditionModel,
    unet_config: UNetConfig,
    schedule: DiffusionSchedule,
    latents: torch.Tensor,
    cond: torch.Tensor,
    uncond0: torch.Tensor,
    num_steps: int = 50,
    inner_steps: int = 1,
    base_lr: float = 1e-2,
    guidance_scale: float = 7.5,
    null_normal_infer: bool = False,
    early_stop_epsilon: float = 1e-5,
    compute_dtype: str = "float32",
    use_flash: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDIM inversion under ``cond`` (``null_normal_infer`` applies to this
    pass only), then null-text optimization of ``uncond0`` along its
    trajectory. cond / uncond0: [1, L, D] text embeddings. Returns
    (x_T, uncond embeddings [num_steps, 1, L, D])."""
    x_t, all_latents = ddim_invert(unet, unet_config, schedule, latents, cond, num_steps,
                                   normal_infer=null_normal_infer, use_flash=use_flash)
    uncond_list = null_optimization(
        unet, unet_config, schedule, all_latents, cond, uncond0, num_steps, inner_steps,
        base_lr, guidance_scale, compute_dtype=compute_dtype,
        early_stop_epsilon=early_stop_epsilon, use_flash=use_flash)
    return x_t, uncond_list


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
    uncond: Optional[torch.Tensor],
    cond_embedding: torch.Tensor,
    masks: Optional[Dict[Tuple[int, int], torch.Tensor]],
    use_flash: bool = True,
    seg_uncond: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the denoise steps ``seg_ts`` (descending timesteps of a
    ``num_steps`` schedule) from ``latents`` [2, F, h, w, 4] = [recon, edit].

    cond / uncond: [2, L, D] text embeddings. seg_uncond: optional per-step
    uncond embeddings [len(seg_ts), 1, L, D] from null-text inversion; step
    idx then uses seg_uncond[idx] broadcast to cond's shape in place of
    ``uncond``. cond_embedding: the ControlNet conditioning embedding of
    both rows. Returns the latents after the last step."""
    lat = latents
    for idx, t in enumerate(seg_ts):
        t = int(t)
        u = uncond if seg_uncond is None else seg_uncond[idx].expand(cond.shape).to(cond.dtype)
        latent_in = torch.cat([lat, lat], dim=0)
        text_in = torch.cat([u, cond], dim=0)
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
