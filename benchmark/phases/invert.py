"""DDIM inversion as the case-1 edit runs it: ``ddim_invert`` over the whole
50-step schedule, batch 1, under the cond embedding, attn1 in normal mode
(``normal_infer``); no ControlNet, adapter, injection or CFG rows. Each call
inverts the same clip.

The check runs the reference over a sample of the window's steps, each
from the latents the step started from (after the first step, the
program's own trajectory: the reference follows it step by step), and
compares each step's update.
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
    meta_reference,
    reference,
    unet_config,
    update_error,
)
from benchmark.reference import sd15_video as R


class Phase(PhaseBase):
    kind = "infer"

    def __init__(self, ctx):
        from motioneditor_tpu_torch.schedulers import DiffusionSchedule

        super().__init__(ctx)
        t = self.traffic
        self.steps = t["steps"]
        self.mode = "normal" if t["normal_infer"] else ctx.model["attn1"]
        self.unet_cfg = unet_config(ctx.model)
        self.unet = build(ctx, "unet", self.dtype)
        self.x = self.inputs(ctx.device)
        self.schedule = DiffusionSchedule(**{k: self.sched[k] for k in (
            "num_train_timesteps", "beta_start", "beta_end", "steps_offset")})
        self.ref_ts = R.timesteps(self.sched, self.steps)  # the reference's own table
        self._invert(t["trace_steps"])  # warm-up: the same shapes at a shorter schedule
        self.trails = []

    def inputs(self, device) -> dict:
        """The clip's latents (0.18215 x a normal draw) and the prompt's
        embedding, from the seed."""
        t = self.traffic
        f, latent = t["frames"], t["resolution"] // 8
        g = self.gen(SALT_INPUTS)
        return {
            "x0": (0.18215 * torch.randn((1, f, latent, latent, 4), generator=g,
                                        device=device)).to(self.dtype),
            "cond": torch.randn((1, *self.text), generator=g,
                                device=device).to(self.dtype),
        }

    def _invert(self, steps: int):
        from motioneditor_tpu_torch.pipelines.editor import ddim_invert

        with record_function("bench.ddim_invert"):
            return ddim_invert(self.unet, self.unet_cfg, self.schedule, self.x["x0"],
                               self.x["cond"], steps, normal_infer=self.traffic["normal_infer"])

    def run_chunk(self):
        _, all_latents = self._invert(self.steps)
        self.trails.append(all_latents)
        return self.steps, "invert"

    def trace_chunk(self):
        steps = self.traffic["trace_steps"]
        self._invert(steps)
        return steps, "invert"

    def free_program(self) -> None:
        del self.unet

    # -- the check -----------------------------------------------------------------

    def _sample(self):
        """(call, step) pairs: the first call's first step, then from the
        seed a step of the schedule's later half (where a step's update
        reads the model's precision most) and ``drawn`` - 1 more, of any call."""
        pairs = [(c, i) for c in range(len(self.trails)) for i in range(self.steps)]
        rng = np.random.default_rng(data.sub_seed(self.ctx.seed, 51))
        late = [j for j, (_, i) in enumerate(pairs) if i >= self.steps // 2]
        first = int(rng.choice(late))
        rest = [j for j in range(1, len(pairs)) if j != first]
        more = rng.choice(rest, size=min(self.traffic["check"]["drawn"] - 1, len(rest)),
                          replace=False).tolist()
        return [pairs[j] for j in [0] + sorted([first] + more)]

    def _reference_step(self, ref, i: int, start: torch.Tensor) -> torch.Tensor:
        t = self.ref_ts[self.steps - i - 1]
        with torch.no_grad():
            eps = ref.unet(start.float(), t, self.x["cond"].float(), self.mode)
            return R.ddim_inverse_step(self.acp, self.sched, eps, t, start.float(), self.steps)

    def _numbers(self, precision=None):
        """update_err over the sampled steps, from the starts the program
        had: of the program's outputs, or with ``precision`` of the
        reference at that precision in the program's place."""
        R.strict_fp32()
        ref = reference(self.ctx, "unet")
        low = None if precision is None else R.Reference(ref.p, ref.cfg, precision)
        errs = []
        for c, i in self._sample():
            lat = self.trails[c]
            got = lat[i + 1] if low is None else low.st(self._reference_step(low, i, lat[i]))
            errs.append(update_error(got, self._reference_step(ref, i, lat[i]), lat[i],
                                     self.dtype))
        return [("update_err", max(errs))]

    def check(self):
        return self._numbers()

    def control(self, precision: str = "fp8"):
        return self._numbers(precision)

    # -- work ------------------------------------------------------------------------

    def count_step(self, kind: str, sites: list) -> None:
        t = self.traffic
        latent = t["resolution"] // 8
        ref = meta_reference(self.ctx.model, "unet", sites)
        lat = torch.empty((1, t["frames"], latent, latent, 4), device="meta")
        text = torch.empty((1, *self.text), device="meta")
        with torch.no_grad():
            ref.unet(lat, self.ref_ts[0], text, self.mode)
