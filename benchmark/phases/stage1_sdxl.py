"""Stage-1 training of SDXL's video UNet: ``train_step_stage1`` in the loop
that ``train_bg.main`` runs, as ``stage1.py`` drives SD-1.5's (each loss
read back once the next step is dispatched, noise and timestep from (seed,
step)), with the text_time conditioning of the clip: its pooled text
embedding and time ids. The check is ``stage1.py``'s: the first gradient
and the changes after set-up's steps, then a few window steps replayed from
the program's own state, against ``reference/sdxl_video.py``.

The phase builds the program's SDXL ``UNetConfig`` before anything else,
so that a program without one fails at once.
"""

from __future__ import annotations

import torch

from benchmark import data
from benchmark.phases import stage1
from benchmark.phases.common import DTYPES, SALT_INPUTS, SALT_UNET
from benchmark.phases.train_common import TrainPhase
from benchmark.reference import sdxl_video as X


def unet_config(model: dict):
    """The program's UNetConfig of the configuration's ``model`` group."""
    from motioneditor_tpu_torch.models.unet import UNetConfig

    return UNetConfig(
        in_channels=model["in_channels"], out_channels=model["out_channels"],
        block_out_channels=tuple(model["block_out_channels"]),
        layers_per_block=model["layers_per_block"],
        cross_attention_dim=model["cross_attention_dim"],
        norm_num_groups=model["norm_num_groups"], norm_eps=model["norm_eps"],
        transformer_norm_eps=model["transformer_norm_eps"],
        use_sc_attn=model["attn1"] == "motion_frame", use_st_attn=False, video=True,
        down_block_types=tuple(model["down_block_types"]),
        transformer_layers_per_block=tuple(model["transformer_layers_per_block"]),
        num_attention_heads=tuple(X.level_heads(model)),
        use_linear_projection=model["use_linear_projection"],
        addition_embed_type=model["addition_embed_type"],
        addition_time_embed_dim=model["addition_time_embed_dim"],
        projection_class_embeddings_input_dim=model["projection_class_embeddings_input_dim"])


def build(ctx, dtype: torch.dtype):
    """The program's SDXL video UNet (no adapter) in ``dtype`` on the device,
    filled from the seed."""
    from motioneditor_tpu_torch.models.unet import UNet3DConditionModel

    cfg = unet_config(ctx.model)
    with torch.device("meta"):
        model = UNet3DConditionModel(cfg, include_adapter=False)
    model = model.to(dtype).to_empty(device=ctx.device).eval()
    data.load_into(model, X.unet_shapes(ctx.model), ctx.seed, SALT_UNET, ctx.cell.config["init"])
    return model


def reference(ctx, precision: str = "fp32") -> X.Reference:
    """The reference's twin of ``build``: the same values in float32."""
    params = data.reference_params(X.unet_shapes(ctx.model), ctx.seed, SALT_UNET, ctx.device,
                                   DTYPES[ctx.cell.config["dtype"]], ctx.cell.config["init"])
    return X.Reference(params, ctx.model, precision=precision)


class Phase(TrainPhase):
    modules = ()

    def __init__(self, ctx):
        self.unet_cfg = unet_config(ctx.model)  # first: a program without it fails here
        self.modules = ctx.cell.config["trainable_modules"]
        super().__init__(ctx)

    def build_model(self):
        return build(self.ctx, self.dtype)

    def make_state(self, model, optimizer):
        from motioneditor_tpu_torch.training.common import make_train_state

        return make_train_state(model, self.modules, optimizer, frozen_dtype=self.dtype)

    def inputs(self, device) -> dict:
        """The clip's latents (``latent_scale`` x a normal draw, fp32), the
        prompt's embedding and pooled embedding, from the seed, and the
        configuration's time ids."""
        t, cfg = self.traffic, self.ctx.cell.config
        latent, b = t["resolution"] // 8, t["batch"]
        g = self.gen(SALT_INPUTS)
        return {
            "latents": cfg["latent_scale"] * torch.randn((b, t["frames"], latent, latent, 4),
                                                         generator=g, device=device),
            "text": torch.randn((b, *self.text), generator=g, device=device),
            "added": {
                "text_embeds": torch.randn((b, cfg["text_embeds_dim"]), generator=g,
                                           device=device),
                "time_ids": torch.tensor(cfg["time_ids"], dtype=torch.float32,
                                         device=device).expand(b, X.TIME_IDS),
            },
        }

    def program_step(self, generator) -> torch.Tensor:
        from motioneditor_tpu_torch.training.stage1 import train_step_stage1

        self.state, out = train_step_stage1(
            self.state, self.x["latents"], self.x["text"], generator, self.unet_cfg,
            self.schedule, prediction_type="epsilon", use_flash=True,
            remat=self.ctx.cell.config["gradient_checkpointing"], compute_dtype=self.dtype,
            added_cond_kwargs=self.x["added"])
        return out["loss"]

    def reference_model(self, precision: str) -> X.Reference:
        return reference(self.ctx, precision)

    def reference_loss(self, ref, noise, t):
        x = self.x
        return X.stage1_loss(ref, self.acp, x["latents"], x["text"], x["added"], noise, t)

    # -- work ------------------------------------------------------------------------

    def count_step(self, kind: str, sites: list) -> None:
        """The forward and the backward without recompute; weight gradients
        only for the trainables."""
        t, m = self.traffic, self.ctx.model
        latent, b = t["resolution"] // 8, t["batch"]
        shapes = X.unet_shapes(m)
        params = {n: torch.empty(s, device="meta",
                                 requires_grad=stage1.trainable(n, self.modules))
                  for n, s in shapes.items()}
        ref = X.Reference(params, m, sites=sites)
        ref.remat = False
        meta = {"device": "meta"}
        lat = torch.empty((b, t["frames"], latent, latent, 4), **meta)
        text = torch.empty((b, *self.text), **meta)
        added = {"text_embeds": torch.empty((b, self.ctx.cell.config["text_embeds_dim"]), **meta),
                 "time_ids": torch.empty((b, X.TIME_IDS), **meta)}
        tt = torch.zeros((b,), dtype=torch.long, **meta)
        X.stage1_loss(ref, self.acp.to("meta"), lat, text, added, lat, tt).backward()
