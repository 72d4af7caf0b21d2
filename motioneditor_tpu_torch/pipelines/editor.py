"""The MotionEditor pipeline: DDIM inversion, null-text optimization and
the two-branch injected denoise loop (port of
motioneditor_tpu/pipelines/editor.py: _jit_ddim_invert,
_jit_null_optimization, _jit_denoise_segment and MotionEditorPipeline).

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
loops here. ``MotionEditorPipeline`` chains these phases from prompts and
frames to frames, with the VAE and the CLIP text encoder. Prompt-to-prompt
control (control/p2p.py) edits the attention probabilities of the
conditional edit row, and LocalBlend blends the latents after each DDIM
step from the running sum of the 16x16 cross-attention maps.

Every phase also runs frame sharded over a process group (``shard_ctx``,
parallel/mesh.FrameShardingCtx): the functions take this rank's frames and
return them; ``MotionEditorPipeline`` with a ``shard_ctx`` takes whole
clips on every rank, works on this rank's frames and gathers the results.
Every phase also runs under tensor parallelism (a model group of T > 1,
the UNet, its adapter and the ControlNet split by parallel/tp.py
``shard_params_tp``; the VAE and the text encoder stay whole, as JAX never
passes them to ``tp_param_shardings``): latents, masks, text embeddings
and the null-text embedding are replicated over the model group, and the
16x16 cross-attention maps that LocalBlend and the auto mask read are the
full width's (ops/attention.py ``head_mean``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from motioneditor_tpu_torch.control.injection import (
    InjectionSpec,
    prepare_injection_masks,
    segment_step_ranges,
)
from motioneditor_tpu_torch.models.clip_text import (
    CLIPTextConfig,
    CLIPTextModel,
    clip_text_apply,
    tokenize,
)
from motioneditor_tpu_torch.models.controlnet import (
    ControlNetModel,
    controlnet_apply,
    controlnet_config,
    precompute_cond_embedding,
)
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig, unet_apply
from motioneditor_tpu_torch.models.vae import (
    AutoencoderKL,
    VAEConfig,
    vae_decode_video,
    vae_encode_video,
)
from motioneditor_tpu_torch.parallel.mesh import FrameShardingCtx, gather_video, shard_video
from motioneditor_tpu_torch.parallel.tp import broadcast_from_model
from motioneditor_tpu_torch.schedulers import DiffusionSchedule, ddim_inverse_step, ddim_step
from motioneditor_tpu_torch.training.common import mse
from motioneditor_tpu_torch.utils.profiling import span

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
    shard_ctx=None,
    added_cond_kwargs: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain DDIM inversion of ``latents`` [B, F, h, w, 4] under the text
    embedding ``cond`` [1 or B, L, D], run in the latents' dtype;
    ``normal_infer`` turns the video attention variants off;
    ``added_cond_kwargs``: a text_time configuration's pooled text and time
    ids (models/unet.py ``time_embedding``). Returns
    (x_T, all_latents [num_steps + 1, ...]) with all_latents[i] the latent
    after i inversion steps (x_0 first). ``shard_ctx``: ``latents`` holds
    this rank's frames, and so do both results; the UNet communicates over
    the frame group (and, split by ``shard_params_tp``, the model group),
    the inverse DDIM step is per element."""
    ts = schedule.inference_timesteps(num_steps)
    cond_b = cond.to(latents.dtype).expand(latents.shape[0], *cond.shape[1:])
    lat = latents
    all_latents = [latents]
    for i in range(num_steps):
        with span("me.invert_step"):
            t = int(ts[num_steps - i - 1])
            eps = unet_apply(unet, unet_config, lat, t, cond_b, normal_infer=normal_infer,
                             use_flash=use_flash, shard_ctx=shard_ctx,
                             added_cond_kwargs=added_cond_kwargs)
            lat = ddim_inverse_step(schedule, eps, t, lat, num_steps)
            all_latents.append(lat)
    return lat, torch.stack(all_latents)


def _null_text_eps(unet, unet_config, lat, t: int, emb, compute_dtype: torch.dtype,
                   use_flash: bool, shard_ctx=None) -> torch.Tensor:
    """The null-text UNet call: batch 1, motion_frame attention, no
    ControlNet or adapter; runs in ``compute_dtype``, returns fp32. The
    casts sit inside the graph, so a gradient reaches an fp32 ``emb``."""
    return unet_apply(unet, unet_config, lat.to(compute_dtype), t, emb.to(compute_dtype),
                      normal_infer=False, use_flash=use_flash, shard_ctx=shard_ctx).float()


def null_text_loss(unet, unet_config, schedule, num_steps: int, guidance_scale: float,
                   compute_dtype: torch.dtype, latent_cur, latent_prev, t: int, eps_cond,
                   uncond, use_flash: bool = True, shard_ctx=None) -> torch.Tensor:
    """The null-text objective of one timestep: mean squared distance between
    the CFG DDIM step from ``latent_cur`` (uncond embedding ``uncond``,
    precomputed ``eps_cond``) and the inversion latent ``latent_prev``; with
    ``shard_ctx``, this rank's share of it (the local sum over the global
    element count), so the frame group's shares sum to it."""
    eps_u = _null_text_eps(unet, unet_config, latent_cur, t, uncond, compute_dtype, use_flash,
                           shard_ctx)
    eps = eps_u + guidance_scale * (eps_cond - eps_u)
    prev_rec = ddim_step(schedule, eps, t, latent_cur, num_steps)
    return mse(prev_rec, latent_prev, shard_ctx)


def _sum_over_frames(loss: torch.Tensor, grad: torch.Tensor, shard_ctx):
    """The frame group's sums of a loss share and its gradient, in one
    all-reduce, then model rank 0's sums on every model rank (the model
    group holds the same frames and embedding): every rank gets the same
    bits, so every rank takes the same early-stop decision and the same
    Adam update."""
    buf = torch.cat([loss.reshape(1), grad.reshape(-1)])
    if shard_ctx.fp > 1:
        dist.all_reduce(buf, group=shard_ctx.frame_group)
    broadcast_from_model(buf, shard_ctx)
    return buf[0], buf[1:].view_as(grad)


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
    shard_ctx=None,
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
    taken with respect to the embedding only.

    ``shard_ctx`` (a layout of data 1): ``all_latents`` holds this rank's
    frames. Each rank's loss is its share of the global mean; the shares
    and the embedding's gradients are summed over the frame group before
    the early-stop test and the Adam update, so the embeddings that come
    out are the same bits on every rank. Under a model group the
    embedding's gradient arrives summed over it (the key / value inputs
    pass Megatron's f, parallel/tp.py ``copy_to_model``), and model rank
    0's loss and gradient are broadcast over it."""
    if shard_ctx is not None and shard_ctx.dp > 1:
        raise ValueError("null-text optimization shards frames only, not the data axis")
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
            eps_cond = _null_text_eps(unet, unet_config, latent_cur, t, cond, cdt, use_flash,
                                      shard_ctx)
        # the schedules in fp32, as the reference computes them
        lr = float(np.float32(base_lr) * (np.float32(1.0) - np.float32(i) / np.float32(100.0)))
        thresh = float(np.float32(early_stop_epsilon) + np.float32(i) * np.float32(2e-5))
        m = torch.zeros_like(uncond)
        v = torch.zeros_like(uncond)
        j, loss = 0, torch.tensor(float("inf"))
        # `loss >= thresh` syncs with the device; it is read only when
        # another inner step may follow (never when inner_steps == 1).
        # Sharded, ``loss`` is the world's, the same on every rank: a rank
        # that left the loop alone would hang the others' collectives
        while j < inner_steps and bool(loss >= thresh):
            u = uncond.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = null_text_loss(unet, unet_config, schedule, num_steps, guidance_scale,
                                      cdt, latent_cur, latent_prev, t, eps_cond, u, use_flash,
                                      shard_ctx)
                (g,) = torch.autograd.grad(loss, u)
            loss = loss.detach()
            if shard_ctx is not None:
                loss, g = _sum_over_frames(loss, g, shard_ctx)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            jf = np.float32(j + 1)
            mhat = m / float(np.float32(1.0) - np.float32(0.9) ** jf)
            vhat = v / float(np.float32(1.0) - np.float32(0.999) ** jf)
            uncond = uncond - lr * mhat / (vhat.sqrt() + 1e-8)
            j += 1
        with torch.no_grad():
            eps_u = _null_text_eps(unet, unet_config, latent_cur, t, uncond, cdt, use_flash,
                                   shard_ctx)
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
    shard_ctx=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDIM inversion under ``cond`` (``null_normal_infer`` applies to this
    pass only), then null-text optimization of ``uncond0`` along its
    trajectory. cond / uncond0: [1, L, D] text embeddings. Returns
    (x_T, uncond embeddings [num_steps, 1, L, D]). ``shard_ctx``: both
    phases run frame sharded; ``latents`` and x_T hold this rank's frames."""
    x_t, all_latents = ddim_invert(unet, unet_config, schedule, latents, cond, num_steps,
                                   normal_infer=null_normal_infer, use_flash=use_flash,
                                   shard_ctx=shard_ctx)
    uncond_list = null_optimization(
        unet, unet_config, schedule, all_latents, cond, uncond0, num_steps, inner_steps,
        base_lr, guidance_scale, compute_dtype=compute_dtype,
        early_stop_epsilon=early_stop_epsilon, use_flash=use_flash, shard_ctx=shard_ctx)
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
    shard_ctx=None,
    p2p_controller=None,
    local_blend=None,
    seg_lo: int = 0,
    maps_sum: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the denoise steps ``seg_ts`` (descending timesteps of a
    ``num_steps`` schedule) from ``latents`` [2, F, h, w, 4] = [recon, edit].

    cond / uncond: [2, L, D] text embeddings. seg_uncond: optional per-step
    uncond embeddings [len(seg_ts), 1, L, D] from null-text inversion; step
    idx then uses seg_uncond[idx] broadcast to cond's shape in place of
    ``uncond``. cond_embedding: the ControlNet conditioning embedding of
    both rows. Returns the latents after the last step.

    ``shard_ctx`` (parallel/mesh.FrameShardingCtx): the frame-sharded
    segment (JAX ``_jit_denoise_segment`` with its shard_ctx): the latents,
    ``cond_embedding`` and ``masks`` hold this rank's frames (the branch
    axis stays whole: ``shard_video(..., branch_axis=True)``), and so do
    the returned latents. The ControlNet is per frame and runs on them
    unchanged; the UNet communicates over the frame group. Split over a
    model group (parallel/tp.py), every model rank holds the same latents,
    text and masks, and the split attention modules of the UNet, the
    adapter and the ControlNet reduce their outputs over it.

    ``p2p_controller`` (control/p2p.P2PController) edits the attention
    probabilities of step ``seg_lo + idx`` of the schedule, ``seg_lo`` being
    the segment's first step. ``local_blend`` (control/p2p.LocalBlend) needs
    ``maps_sum``, the running sum over steps of the 16x16 cross-attention
    maps [n_sites, 4 F, 256, L] fp32 (``_count_16x16_sites``), the carry
    of JAX ``_jit_denoise_segment``: each step adds its maps to it in place
    after the UNet, and the blend reads its conditional rows after the
    DDIM step. Both are frame local, and the editor acts on each rank's
    heads under a model group."""
    if local_blend is not None and maps_sum is None:
        raise ValueError("LocalBlend needs the running map sum maps_sum")
    f = latents.shape[1]
    lat = latents
    for idx, t in enumerate(seg_ts):
        with span("me.denoise_step"):
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
            step_maps = [] if local_blend is not None else None
            editor = None if p2p_controller is None else p2p_controller.prob_editor(seg_lo + idx)
            eps = unet_apply(
                unet, unet_config, latent_in, t, text_in,
                injection=injection_spec, injection_masks=masks,
                down_block_additional_residuals=down_res,
                mid_block_additional_residual=mid4, use_flash=use_flash, shard_ctx=shard_ctx,
                prob_editor=editor, cross_maps_out=step_maps)
            if local_blend is not None:
                maps_sum += torch.stack(step_maps)
            eps_u, eps_c = eps.chunk(2, dim=0)
            eps_g = eps_u + guidance_scale * (eps_c - eps_u)
            lat = ddim_step(schedule, eps_g, t, lat, num_steps)
            if local_blend is not None:
                # the conditional rows [recon_c, edit_c]: the map store sees only
                # the conditional half
                lat = local_blend(lat, list(maps_sum[:, 2 * f:]))
    return lat


def _count_16x16_sites(h0: int, w0: int) -> int:
    """The transformer blocks whose token count is 256 (the 16x16
    cross-attention map sites) for latents (h0, w0): at SD-1.5's 64x64
    latents, the two of down block 2 and the three of up block 1, the maps
    LocalBlend reads (JAX editor.py:415-431)."""
    n = 0
    for i in range(3):  # down blocks 0-2, 2 attention sites each
        if (h0 >> i) * (w0 >> i) == 256:
            n += 2
    if (h0 >> 3) * (w0 >> 3) == 256:  # mid block
        n += 1
    for r in (2, 1, 0):  # up blocks 1-3, 3 attention sites each
        if (h0 >> r) * (w0 >> r) == 256:
            n += 3
    return n


@dataclasses.dataclass
class MotionEditorPipeline:
    """The models, their configs and the tokenizer. The UNet's parameter
    dtype is the compute dtype of every phase (null-text keeps its embedding,
    Adam state and DDIM math in fp32); text embeddings are cast to it.

    ``shard_ctx`` (a layout of data 1, parallel/mesh.FrameShardingCtx):
    every entry takes whole clips on every rank and returns whole results,
    as JAX's global arrays; inside, each phase works on this rank's frames
    and the results are gathered at its end (JAX editor.py:68-71). With a
    model group the UNet (with its adapter) and the ControlNet must come
    split by parallel/tp.py ``shard_params_tp``; the VAE and the text
    encoder stay whole."""

    unet: UNet3DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    controlnet: ControlNetModel
    tokenizer: object
    unet_config: UNetConfig = UNetConfig()
    controlnet_config: Optional[UNetConfig] = None
    vae_config: VAEConfig = VAEConfig()
    text_config: CLIPTextConfig = CLIPTextConfig()
    schedule: DiffusionSchedule = DiffusionSchedule()
    use_flash: bool = True
    shard_ctx: Optional[FrameShardingCtx] = None

    def __post_init__(self):
        if self.controlnet_config is None:
            self.controlnet_config = controlnet_config(self.unet_config)
        if self.shard_ctx is not None and self.shard_ctx.dp > 1:
            raise ValueError("the pipeline shards frames only: its layout needs data = 1, "
                             f"got {self.shard_ctx.dp}")

    def _frames(self, x: torch.Tensor, frame_dim: int = 1) -> torch.Tensor:
        """This rank's frames of a whole clip (the clip itself unsharded);
        raises ValueError when the frames do not split over the layout."""
        if self.shard_ctx is None:
            return x
        return shard_video(x, self.shard_ctx, branch_axis=True, frame_dim=frame_dim)

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole clip from every rank's frames [B, Fl, ...]."""
        return x if self.shard_ctx is None else gather_video(x, self.shard_ctx, branch_axis=True)

    @property
    def dtype(self) -> torch.dtype:
        return next(self.unet.parameters()).dtype

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    # -- encoders -------------------------------------------------------------

    @torch.no_grad()
    def encode_prompt(self, prompts: Sequence[str]) -> torch.Tensor:
        """[len(prompts), 77, 768] text embeddings in the UNet's dtype.
        Sharded, frame rank 0's embeddings go to every rank (and model rank
        0's over the model group): the ranks must condition on the same
        text, and a tokenizer need not give every process the same ids
        (``StubTokenizer``'s are salted per process)."""
        ids = tokenize(self.tokenizer, prompts, self.text_config.max_position_embeddings)
        emb = clip_text_apply(self.text_encoder, ids.to(self.device), self.text_config)
        emb = emb.to(self.dtype).contiguous()
        if self.shard_ctx is not None:
            if self.shard_ctx.fp > 1:
                dist.broadcast(emb, self.shard_ctx.frame_ranks[0],
                               group=self.shard_ctx.frame_group)
            broadcast_from_model(emb, self.shard_ctx)
        return emb

    @torch.no_grad()
    def encode_video(self, video: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, F, H, W, 3] in [-1, 1] -> latents [B, F, h, w, 4] (x0.18215),
        sampled from ``generator`` (the mean without one; sharded, the noise
        of the whole clip is drawn and this rank's frames taken)."""
        return self._whole(vae_encode_video(self.vae, self._frames(video), generator=generator,
                                            config=self.vae_config, shard_ctx=self.shard_ctx))

    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        img = vae_decode_video(self.vae, latents, config=self.vae_config)
        return torch.clamp(img / 2 + 0.5, 0.0, 1.0)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [B, F, h, w, 4] -> video [B, F, H, W, 3] in [0, 1]."""
        return self._whole(self._decode(self._frames(latents)))

    # -- inversion ------------------------------------------------------------

    def ddim_invert(self, latents: torch.Tensor, prompt: str = "", num_inv_steps: int = 50,
                    normal_infer: bool = True) -> torch.Tensor:
        """Plain DDIM inversion under ``prompt``; ``normal_infer`` turns the
        video attention variants off. Returns x_T."""
        final, _ = ddim_invert(
            self.unet, self.unet_config, self.schedule, self._frames(latents),
            self.encode_prompt([prompt]), num_inv_steps, normal_infer=normal_infer,
            use_flash=self.use_flash, shard_ctx=self.shard_ctx)
        return self._whole(final)

    def null_text_inversion(self, latents: torch.Tensor, prompt: str, num_steps: int = 50,
                            null_inner_steps: int = 1, null_base_lr: float = 1e-2,
                            guidance_scale: float = 7.5, null_normal_infer: bool = False,
                            early_stop_epsilon: float = 1e-5):
        """Returns (x_T, uncond embeddings [num_steps, 1, 77, 768] in fp32)."""
        compute = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[self.dtype]
        x_t, uncond = null_text_inversion(
            self.unet, self.unet_config, self.schedule, self._frames(latents),
            self.encode_prompt([prompt]), self.encode_prompt([""]), num_steps=num_steps,
            inner_steps=null_inner_steps, base_lr=null_base_lr, guidance_scale=guidance_scale,
            null_normal_infer=null_normal_infer, early_stop_epsilon=early_stop_epsilon,
            compute_dtype=compute, use_flash=self.use_flash, shard_ctx=self.shard_ctx)
        return self._whole(x_t), uncond

    # -- two-branch edit --------------------------------------------------------

    @torch.no_grad()
    def __call__(
        self,
        prompts: Sequence[str],
        latents: torch.Tensor,
        target_skeleton: torch.Tensor,
        source_masks: Optional[torch.Tensor] = None,
        uncond_embeddings: Optional[torch.Tensor] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        controlnet_conditioning_scale: float = 1.0,
        start_step: int = 4,
        start_layer: int = 10,
        p2p_controller=None,
        local_blend=None,
        decode: bool = True,
    ) -> torch.Tensor:
        """The two-branch edit. prompts: [source prompt, target prompt];
        latents: [2, F, h, w, 4], the inverted seed for both branches;
        target_skeleton: [F, H, W, 3] in [0, 1], the ControlNet's
        conditioning; source_masks: [F, H, W] protagonist masks for the fg/bg
        injection (None: target rows read the source K/V wholesale);
        uncond_embeddings: optional per-step null-text embeddings
        [num_inference_steps, 1, 77, 768]. Steps [0, start_step) run vanilla,
        the rest inject from transformer block ``start_layer`` on.
        p2p_controller: optional control.p2p.P2PController, prompt-to-prompt
        editing of the conditional edit row's attention probabilities;
        local_blend: optional control.p2p.LocalBlend, applied after every
        DDIM step from the running sum of the 16x16 cross-attention maps
        (JAX editor.py:245-290). Returns [2, F, H, W, 3] in [0, 1]
        ([reconstruction, edit]), or the latents when ``decode`` is False."""
        if len(prompts) != 2 or latents.shape[0] != 2:
            raise ValueError("the edit takes [source, target] prompts and 2 latent rows")
        if uncond_embeddings is not None and len(uncond_embeddings) < num_inference_steps:
            raise ValueError(f"{len(uncond_embeddings)} uncond embeddings for "
                             f"{num_inference_steps} steps")
        n_sites = _count_16x16_sites(*latents.shape[2:4])
        if local_blend is not None and n_sites == 0:
            raise ValueError("LocalBlend requires a 16x16 attention resolution; latent shape "
                             f"{tuple(latents.shape[2:4])} never reaches 256 tokens")
        # sharded, every per-frame input is cut to this rank's frames
        lat = self._frames(latents)
        f = lat.shape[1]
        cond = self.encode_prompt(list(prompts))  # [2, 77, 768]
        uncond = None
        if uncond_embeddings is None:
            uncond = self.encode_prompt([""]).expand(cond.shape)
        masks = None
        if source_masks is not None:
            h, w = lat.shape[2:4]
            masks = prepare_injection_masks(
                self._frames(source_masks, frame_dim=0), f,
                tuple((h >> i, w >> i) for i in range(4)))
        ts = self.schedule.inference_timesteps(num_inference_steps)
        spec = InjectionSpec.from_start_layer(start_layer)
        # both CFG rows see the target skeleton; its embedding is step-invariant
        skeleton = self._frames(target_skeleton, frame_dim=0).to(self.dtype)
        cond_embedding = precompute_cond_embedding(self.controlnet,
                                                   skeleton[None].expand(2, *skeleton.shape))
        maps_sum = None
        if local_blend is not None:
            maps_sum = torch.zeros((n_sites, 4 * f, 256, cond.shape[-2]), dtype=torch.float32,
                                   device=self.device)
        for lo, hi, injected in segment_step_ranges(num_inference_steps, start_step=start_step):
            lat = denoise_segment(
                self.unet, self.unet_config, self.controlnet, self.controlnet_config,
                self.schedule, num_inference_steps, spec if injected else None, guidance_scale,
                controlnet_conditioning_scale, lat, ts[lo:hi], cond, uncond, cond_embedding,
                masks, use_flash=self.use_flash,
                seg_uncond=None if uncond_embeddings is None else uncond_embeddings[lo:hi],
                shard_ctx=self.shard_ctx, p2p_controller=p2p_controller,
                local_blend=local_blend, seg_lo=lo, maps_sum=maps_sum)
        return self._whole(self._decode(lat) if decode else lat)
