"""The two-branch edit's denoise loop in mask mode: ``denoise_segment`` as
``MotionEditorPipeline.__call__`` calls it, one step of the 50-step DDIM
schedule per call, cycling the schedule (steps before ``start_step``
vanilla, the rest injected from block ``start_layer``), with per-step
uncond embeddings as null-text leaves them.

The check runs the reference over a sample of the window's steps, each
from the latents the step started from (the program's own state after the
first step: the reference follows the program step by step), and compares
each step's update of both branches.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import data
from benchmark.phases.common import (
    SALT_INPUTS,
    PhaseBase,
    build,
    masks_by_tokens,
    meta_reference,
    reference,
    unet_config,
    update_error,
)
from benchmark.reference import sd15_video as R


class Phase(PhaseBase):
    kind = "infer"

    def __init__(self, ctx):
        from motioneditor_tpu_torch.control.injection import (
            InjectionSpec,
            prepare_injection_masks,
        )
        from motioneditor_tpu_torch.models.controlnet import (
            controlnet_config,
            precompute_cond_embedding,
        )
        from motioneditor_tpu_torch.schedulers import DiffusionSchedule

        super().__init__(ctx)
        t = self.traffic
        self.steps, self.start_step = t["steps"], t["start_step"]
        self.unet_cfg = unet_config(ctx.model)
        self.cn_cfg = controlnet_config(self.unet_cfg)
        self.unet = build(ctx, "unet", self.dtype)
        self.cn = build(ctx, "controlnet", self.dtype)
        self.x = self.inputs(ctx.device)
        self.schedule = DiffusionSchedule(**{k: self.sched[k] for k in (
            "num_train_timesteps", "beta_start", "beta_end", "steps_offset")})
        self.ts = self.schedule.inference_timesteps(self.steps)  # drives the program
        self.ref_ts = R.timesteps(self.sched, self.steps)  # the reference's own table
        self.spec = InjectionSpec.from_start_layer(t["start_layer"])
        f, latent = t["frames"], t["resolution"] // 8
        with torch.no_grad():
            # what __call__ derives once per edit (editor.py:546-556)
            self.masks = prepare_injection_masks(
                self.x["masks"], f, tuple((latent >> i, latent >> i) for i in range(4)))
            skeleton = self.x["skeleton"].to(self.dtype)
            self.cond_emb = precompute_cond_embedding(self.cn,
                                                      skeleton[None].expand(2, *skeleton.shape))
        for i in (0, self.start_step):  # warm up a vanilla and an injected step
            self._step(i, self.x["x_t"])
        self.pos, self.lat, self.trail = 0, self.x["x_t"], []

    def inputs(self, device) -> dict:
        """x_T of both branches, the [source, target] text, one uncond
        embedding per step, the target skeletons and the protagonist masks,
        from the seed."""
        t = self.traffic
        f, px = t["frames"], t["resolution"]
        g = self.gen(SALT_INPUTS)
        x = torch.randn((1, f, px // 8, px // 8, 4), generator=g, device=device)
        return {
            "x_t": torch.cat([x, x]).to(self.dtype),
            "cond": torch.randn((2, *self.text), generator=g,
                                device=device).to(self.dtype),
            "uncond": torch.randn((self.steps, 1, *self.text), generator=g,
                                  device=device),
            "skeleton": torch.rand((f, px, px, 3), generator=g, device=device),
            "masks": data.blob_masks(g, f, px, t["mask_share"], device),
        }

    def _step(self, i: int, lat: torch.Tensor) -> torch.Tensor:
        from motioneditor_tpu_torch.pipelines.editor import denoise_segment

        t = self.traffic
        with record_function("bench.denoise_segment"):
            return denoise_segment(
                self.unet, self.unet_cfg, self.cn, self.cn_cfg, self.schedule, self.steps,
                self.spec if i >= self.start_step else None, t["guidance_scale"],
                t["controlnet_scale"], lat, self.ts[i:i + 1], self.x["cond"], None,
                self.cond_emb, self.masks, seg_uncond=self.x["uncond"][i:i + 1])

    def _advance(self, record: bool):
        i = self.pos
        out = self._step(i, self.lat)
        if record:
            self.trail.append((i, self.lat, out))
        self.pos = (i + 1) % self.steps
        self.lat = out if self.pos else self.x["x_t"]  # a new edit after the last step
        return 1, "injected" if i >= self.start_step else "vanilla"

    def run_chunk(self):
        return self._advance(True)

    def trace_chunk(self):
        return self._advance(False)

    def free_program(self) -> None:
        del self.unet, self.cn, self.cond_emb, self.masks

    # -- the check -----------------------------------------------------------------

    def _sample(self):
        """The window's first step, its first injected step, and ``drawn``
        more drawn from the seed."""
        c = self.traffic["check"]
        first_injected = [k for k, (i, _, _) in enumerate(self.trail) if i == self.start_step]
        fixed = sorted({0, *first_injected[:1]})
        rest = [k for k in range(len(self.trail)) if k not in fixed]
        rng = np.random.default_rng(data.sub_seed(self.ctx.seed, 50))
        drawn = rng.choice(rest, size=min(c["drawn"], len(rest)), replace=False).tolist()
        return sorted(fixed + drawn)

    def _reference_step(self, ref, cn, cond_emb, masks, i: int, start: torch.Tensor):
        t = self.traffic
        x = self.x
        with torch.no_grad():
            return R.edit_step(
                ref, cn, self.acp, self.sched, start.float(), self.ref_ts[i], x["cond"].float(),
                x["uncond"][i].expand(x["cond"].shape), cond_emb, masks,
                t["start_layer"] if i >= self.start_step else None, t["guidance_scale"],
                t["controlnet_scale"], self.steps)

    def _references(self):
        ref, cn = reference(self.ctx, "unet"), reference(self.ctx, "controlnet")
        with torch.no_grad():
            ce = cn.cond_embedding(self.x["skeleton"])
        latent = self.traffic["resolution"] // 8
        return ref, cn, ce[None].expand(2, *ce.shape), masks_by_tokens(self.x["masks"], latent)

    def _numbers(self, precision=None):
        """update_err over the sampled steps, from the starts the program
        had: of the program's outputs, or with ``precision`` of the
        reference at that precision in the program's place."""
        R.strict_fp32()
        ref, cn, ce, masks = self._references()
        if precision is not None:
            low = (R.Reference(ref.p, ref.cfg, precision), R.Reference(cn.p, cn.cfg, precision))
            with torch.no_grad():
                ce_low = low[1].cond_embedding(self.x["skeleton"])
            ce_low = ce_low[None].expand(2, *ce_low.shape)
        errs = []
        for k in self._sample():
            i, start, got = self.trail[k]
            if precision is not None:
                got = low[0].st(self._reference_step(low[0], low[1], ce_low, masks, i, start))
            errs.append(update_error(got, self._reference_step(ref, cn, ce, masks, i, start),
                                     start, self.dtype))
        return [("update_err", max(errs))]

    def check(self):
        return self._numbers()

    def control(self, precision: str = "fp8"):
        return self._numbers(precision)

    # -- work ------------------------------------------------------------------------

    def count_step(self, kind: str, sites: list) -> None:
        t, m = self.traffic, self.ctx.model
        f, latent = t["frames"], t["resolution"] // 8
        ref = meta_reference(m, "unet", sites)
        cn = meta_reference(m, "controlnet", sites)
        meta = {"device": "meta"}
        lat = torch.empty((2, f, latent, latent, 4), **meta)
        text = torch.empty((2, *self.text), **meta)
        ce = torch.empty((2, f, latent, latent, m["block_out_channels"][0]), **meta)
        masks = {(latent >> i) ** 2: torch.empty((f, (latent >> i) ** 2), **meta)
                 for i in range(4)}
        with torch.no_grad():
            R.edit_step(ref, cn, self.acp, self.sched, lat, self.ref_ts[self.start_step], text,
                        text, ce, masks, t["start_layer"] if kind == "injected" else None,
                        t["guidance_scale"], t["controlnet_scale"], self.steps)
