"""Stage-2 training: ``train_step_stage2`` in the loop that
``train_adaptor.main`` runs, each step's loss read back once the next step
is dispatched, noise and timestep from (seed, step). The motion adapter
trains (``STAGE2_MODULES``, the program's ``training/stage2.py``
``TRAINABLE_MODULES``), whatever the configuration lists for stage 1; the
optimizer is the configuration's, which is train-motion.yaml's. The frozen
ControlNet runs under no-grad on a skeleton clip drawn from the seed, and
its residuals go to the adapter, which takes them against the UNet's own
down features (batch 1).

The check is ``stage1.py``'s over the adapter's leaves, against the
reference with the adapter applied to every batch row
(``AdaptedReference``).
"""

from __future__ import annotations

import torch

from benchmark.phases.common import SALT_INPUTS, build, meta_reference, reference, unet_config
from benchmark.phases.stage1 import trainable
from benchmark.phases.train_common import TrainPhase
from benchmark.reference import sd15_video as R

STAGE2_MODULES = ("controlnet_adapter",)


class AdaptedReference(R.Reference):
    """The reference's UNet with the ControlNet's residuals ``control`` =
    (12 down, mid) of the same batch rows: each down residual through the
    adapter's block against the UNet's feature it is added to, the mid
    residual added after the mid block. The ControlNet itself (``video``
    False) takes none."""

    control = None

    def _down(self, h, temb, text, mode, video, *rest):
        h, skips, layer = super()._down(h, temb, text, mode, video, *rest)
        if self.control is not None and video:
            skips = [s + self._checkpointed(lambda r, f, i=i: self.adapter_block(i, r, f), r, s)
                     for i, (r, s) in enumerate(zip(self.control[0], skips))]
        return h, skips, layer

    def _mid(self, h, temb, text, mode, video, *rest):
        h = super()._mid(h, temb, text, mode, video, *rest)
        return h + self.control[1] if self.control is not None and video else h


def stage2_loss(ref: AdaptedReference, cn: R.Reference, acp, latents, text, skeleton, noise,
                t: torch.Tensor):
    """The adapter's epsilon-prediction loss: the ControlNet (no gradient) on
    the noised latents and the skeleton's embedding, its residuals into the
    UNet's adapter, the prediction against the noise, mean squared."""
    a = acp.to(latents.device)[t].reshape(-1, 1, 1, 1, 1)
    noisy = a.sqrt() * latents + (1 - a).sqrt() * noise
    with torch.no_grad():
        control = cn.controlnet(noisy, t, text, cn.cond_embedding(skeleton), 1.0)
    ref.control = control
    try:
        pred = ref.unet(noisy, t, text, "motion_frame")
    finally:
        ref.control = None
    return ((pred - noise) ** 2).mean()


class Phase(TrainPhase):
    modules = STAGE2_MODULES

    def __init__(self, ctx):
        from motioneditor_tpu_torch.models.controlnet import controlnet_config

        self.unet_cfg = unet_config(ctx.model)
        self.cn_cfg = controlnet_config(self.unet_cfg)
        super().__init__(ctx)

    def build_model(self):
        self.cn = build(self.ctx, "controlnet", self.dtype).requires_grad_(False)
        return build(self.ctx, "unet", self.dtype)

    def make_state(self, model, optimizer):
        from motioneditor_tpu_torch.training.common import make_train_state
        from motioneditor_tpu_torch.training.stage2 import TRAINABLE_MODULES

        return make_train_state(model, TRAINABLE_MODULES, optimizer, frozen_dtype=self.dtype)

    def inputs(self, device) -> dict:
        """The clip's latents (0.18215 x a normal draw, fp32), the prompt's
        embedding and the source skeleton clip in [0, 1], from the seed."""
        t = self.traffic
        f, px, b = t["frames"], t["resolution"], t["batch"]
        g = self.gen(SALT_INPUTS)
        return {
            "latents": 0.18215 * torch.randn((b, f, px // 8, px // 8, 4), generator=g,
                                             device=device),
            "text": torch.randn((b, *self.text), generator=g, device=device),
            "skeleton": torch.rand((b, f, px, px, 3), generator=g, device=device),
        }

    def program_step(self, generator) -> torch.Tensor:
        from motioneditor_tpu_torch.training.stage2 import train_step_stage2

        x = self.x
        self.state, out = train_step_stage2(
            self.state, self.cn, x["latents"], x["skeleton"], x["text"], generator,
            self.unet_cfg, self.cn_cfg, self.schedule, prediction_type="epsilon",
            use_flash=True, remat=self.ctx.cell.config["gradient_checkpointing"],
            compute_dtype=self.dtype)
        return out["loss"]

    def free_program(self) -> None:
        super().free_program()
        del self.cn

    def reference_model(self, precision: str):
        unet = reference(self.ctx, "unet", precision)
        self.ref_cn = reference(self.ctx, "controlnet", precision)
        return AdaptedReference(unet.p, unet.cfg, precision)

    def reference_loss(self, ref, noise, t):
        x = self.x
        return stage2_loss(ref, self.ref_cn, self.acp, x["latents"], x["text"],
                           x["skeleton"], noise, t)

    # -- work ------------------------------------------------------------------------

    def count_step(self, kind: str, sites: list) -> None:
        """The ControlNet's forward, the UNet's forward and backward without
        recompute; weight gradients only for the adapter."""
        t, m = self.traffic, self.ctx.model
        f, px, b = t["frames"], t["resolution"], t["batch"]
        unet = meta_reference(m, "unet", sites, trainable=lambda n: trainable(n, self.modules))
        ref = AdaptedReference(unet.p, m, sites=sites)
        ref.remat = False
        cn = meta_reference(m, "controlnet", sites)
        meta = {"device": "meta"}
        lat = torch.empty((b, f, px // 8, px // 8, 4), **meta)
        text = torch.empty((b, *self.text), **meta)
        skeleton = torch.empty((b, f, px, px, 3), **meta)
        tt = torch.zeros((b,), dtype=torch.long, **meta)
        stage2_loss(ref, cn, self.acp.to("meta"), lat, text, skeleton, lat, tt).backward()
