"""What the phase modules share: the program's models built at the
configuration's widths and filled from the seed, the reference's twins of
them, the model work of one step counted on the meta device, and the
comparison of one step's update with the reference's.

A phase module (``benchmark/phases/<name>.py``) defines ``Phase(ctx)``,
which builds the program's objects and warms up the cell's shapes, and:

  kind            "infer" or "train": which step metric the cell reports
  forward_passes  how often a step runs each attention site's forward (2
                  where checkpointing recomputes it in the backward)
  run_chunk()     drives the program's entry once; (steps completed, step kind)
  trace_chunk()   the same work for the traced window
  reset_counts(), launch_counts()   the program's kernel launch counts
  free_program()  drops the program's state after the window
  check()         [(name, number)] against the reference, after free_program
  control(p)      the same numbers with the reference at precision ``p``
                  ("fp8": the control) in the program's place
  work(kind)      {"flops", "sites"} of one step of that kind, by the reference
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark import data
from benchmark.reference import sd15_video as R

SALT_UNET, SALT_CONTROLNET, SALT_INPUTS, SALT_STEPS = 1, 2, 10, 100
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def unet_config(model: dict, video: bool = True):
    from motioneditor_tpu_torch.models.unet import UNetConfig

    return UNetConfig(
        in_channels=model["in_channels"], out_channels=model["out_channels"],
        block_out_channels=tuple(model["block_out_channels"]),
        layers_per_block=model["layers_per_block"],
        cross_attention_dim=model["cross_attention_dim"],
        attention_heads=model["attention_heads"], norm_num_groups=model["norm_num_groups"],
        norm_eps=model["norm_eps"], transformer_norm_eps=model["transformer_norm_eps"],
        use_sc_attn=model["attn1"] == "motion_frame", use_st_attn=False, video=video)


def build(ctx, which: str, dtype: torch.dtype):
    """The program's UNet (with its adapter) or ControlNet at the
    configuration's widths, in ``dtype`` on the device, filled from the seed."""
    from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
    from motioneditor_tpu_torch.models.unet import UNet3DConditionModel

    cfg = unet_config(ctx.model)
    with torch.device("meta"):
        if which == "unet":
            model = UNet3DConditionModel(cfg)
        else:
            model = ControlNetModel(controlnet_config(cfg))
    model = model.to(dtype).to_empty(device=ctx.device).eval()
    shapes, salt = shapes_salt(ctx.model, which)
    data.load_into(model, shapes, ctx.seed, salt, ctx.cell.config["init"])
    return model


def shapes_salt(model: dict, which: str):
    if which == "unet":
        return R.unet_shapes(model), SALT_UNET
    return R.controlnet_shapes(model), SALT_CONTROLNET


def reference(ctx, which: str, precision: str = "fp32", device=None) -> R.Reference:
    """The reference's twin of ``build(ctx, which, ...)``: the same values in float32."""
    shapes, salt = shapes_salt(ctx.model, which)
    dtype = DTYPES[ctx.cell.config["dtype"]]
    params = data.reference_params(shapes, ctx.seed, salt, device or ctx.device, dtype,
                                   ctx.cell.config["init"])
    return R.Reference(params, ctx.model, precision=precision)


def meta_reference(model: dict, which: str, sites: list, trainable=None) -> R.Reference:
    """A reference on the meta device for counting work; no recompute.
    ``trainable(name)``: the parameters that require a gradient."""
    shapes, _ = shapes_salt(model, which)
    params = {n: torch.empty(s, device="meta", requires_grad=bool(trainable and trainable(n)))
              for n, s in shapes.items()}
    ref = R.Reference(params, model, sites=sites)
    ref.remat = False
    return ref


def count_work(fn) -> Dict[str, object]:
    """The flops of ``fn()`` by FlopCounterMode, and the attention sites it
    reports to the list it is given."""
    from torch.utils.flop_counter import FlopCounterMode

    sites: list = []
    with FlopCounterMode(display=False) as counter:
        fn(sites)
    return {"flops": float(counter.get_total_flops()), "sites": sites}


def update_error(got: torch.Tensor, want: torch.Tensor, start: torch.Tensor,
                 dtype: torch.dtype) -> float:
    """A step's update against the reference's, beyond what storing the
    reference's own answer in the state's ``dtype`` costs: the worst row's
    sqrt(||got - want||^2 - ||round(want) - want||^2) / ||want - start||
    (0 where the rounding alone reads more), row by row (the recon and edit
    branches, or the batch). Late in a schedule the state grows and its
    update shrinks, until rounding the state reads near the whole update:
    that part is no fault of the step, and the rest adds to it in quadrature."""
    got, want, start = got.float(), want.float(), start.float()
    floor = want.to(dtype).float() - want
    errs = [((got[r] - want[r]).norm() ** 2 - floor[r].norm() ** 2).clamp(min=0).sqrt()
            / (want[r] - start[r]).norm() for r in range(want.shape[0])]
    return float(max(errs))


def masks_by_tokens(masks: torch.Tensor, latent: int) -> Dict[int, torch.Tensor]:
    """The reference's injection masks: [F, H, W] nearest-resized to each of
    the UNet's four latent resolutions, keyed by token count, as [F, N]."""
    f = masks.shape[0]
    out = {}
    for i in range(4):
        s = latent >> i
        out[s * s] = R.resize_nearest(masks, (s, s)).reshape(f, s * s)
    return out


class PhaseBase:
    """Defaults of a phase module; see the module docstring."""

    kind = "infer"
    forward_passes = 1

    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.cell.traffic
        self.dtype = DTYPES[ctx.cell.config["dtype"]]
        self.sched = ctx.cell.config["schedule"]
        self.acp = R.alphas_cumprod(self.sched)
        self.text = (R.TEXT_LEN, ctx.model["cross_attention_dim"])  # a prompt's embedding
        self._work: Dict[str, dict] = {}
        self._check_knobs(ctx.cell.config["fused_norm_knobs"])

    @staticmethod
    def _check_knobs(knobs: dict) -> None:
        """The program's fused-norm switches (environment variables) must be
        as the configuration states."""
        from motioneditor_tpu_torch.ops import fused_norm, gn_stats

        got = {"MOTIONEDITOR_FUSED_GN": gn_stats.enabled(),
               "MOTIONEDITOR_FUSED_LN": fused_norm.enabled()}
        if got != knobs:
            raise ValueError(f"the fused-norm knobs are {got}; the configuration runs {knobs}")

    def trace_chunk(self) -> Tuple[int, str]:
        return self.run_chunk()

    def reset_counts(self) -> None:
        from motioneditor_tpu_torch import _build

        _build.reset_launch_counts()

    def launch_counts(self) -> dict:
        from motioneditor_tpu_torch import _build

        return dict(_build.launch_counts)

    def work(self, kind: str) -> dict:
        if kind not in self._work:
            self._work[kind] = count_work(lambda sites: self.count_step(kind, sites))
        return self._work[kind]

    def gen(self, *salt: int) -> torch.Generator:
        return data.generator(self.ctx.device, self.ctx.seed, *salt)
