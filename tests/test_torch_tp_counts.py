"""The kernel launches and model-group all-reduces per step and rank that
chip_sharded.py and chip_smoke.py's phase 11u assert for their
tensor-parallel layouts, derived on the CPU as
tests/test_torch_sharding_phases_counts.py derives the frame-sharded
ones: SD-1.5 at full width in bf16 on the meta device (shapes, no data), 8
frames of 64x64 latents, a one-rank process group whose collectives are
identities, every attention wrapper's CUDA dispatch down to a stand-in
kernel library that launches nothing.

The UNet with its adapter and the ControlNet are split for a model group
of T = 2 and 4 (this process standing for model rank 0): on a (1, 1, T)
layout the segment and inversion take the unsharded routes, on (1, F, T)
the frame-sharded ones (the one-rank frame group stands for every frame
rank: the launches per rank do not depend on the frame split, but for the
pooled GroupNorms, which a one-rank frame group runs through the kernel). Both
launch what the full width launches (chip_smoke.tp_expected), every K1,
K2, K12 and K13 launch on the tensor-core body at the head-local width,
and all-reduce over the model group once per split attention module
called (chip_smoke.TP_ALL_REDUCES_PER_STEP).

The other paths likewise, one step each: null-text (one inner step; one
broadcast of model rank 0's loss and gradient), the auto-mask segment and
the p2p segment with LocalBlend (each 16x16 map site all-reduces its maps'
head sum once more), and a stage-1 and a stage-2 step with gradient
checkpointing, knobs off, AdamW and 8-bit AdamW (the recomputed forwards
all-reduce again, the backward all-reduces at each Megatron f whose input
needs a gradient, the clip once, 8-bit AdamW twice per split trainable;
one broadcast of model rank 0's replicated gradients).
On the frame route the layout stands for a (1, 2, T) rank: its frame
group's collectives, identities here, carry no data.
"""

import copy
import dataclasses

import pytest
import torch
import torch.distributed as dist

import chip_smoke as cs
from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.control.injection import InjectionSpec, prepare_injection_masks
from motioneditor_tpu_torch.models.controlnet import (
    ControlNetModel,
    controlnet_config,
    precompute_cond_embedding,
)
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from motioneditor_tpu_torch.parallel import tp
from motioneditor_tpu_torch.parallel.mesh import init_frame_sharding
from motioneditor_tpu_torch.pipelines.editor import (
    _count_16x16_sites,
    ddim_invert,
    denoise_segment,
    null_optimization,
)
from motioneditor_tpu_torch.schedulers import DiffusionSchedule
from motioneditor_tpu_torch.training import stage1, stage2
from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

META, BF16 = torch.device("meta"), torch.bfloat16
F, LAT = cs.FRAMES, cs.LATENT
CONFIG, CN_CONFIG = UNetConfig(), controlnet_config()
SCHEDULE = DiffusionSchedule()


class StandInLibrary:
    """The kernel library's ``me_*`` entry points, each returning 0
    (launched) and launching nothing."""

    def __getattr__(self, name):
        if not name.startswith("me_"):
            raise AttributeError(name)
        return lambda *args: 0


def empty(*shape, dtype=BF16):
    return torch.empty(shape, device=META, dtype=dtype)


@pytest.fixture(scope="module")
def sd15():
    """SD-1.5's UNet and ControlNet on the meta device, and the one-rank
    frame-sharding context, with the stand-in library in place."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "kernels", StandInLibrary)
        mp.setattr(_build, "stream_handle", lambda device: 0)
        mp.setattr(_build, "check_operands", lambda *args, **kwargs: None)
        for op in ("all_reduce", "all_gather", "broadcast"):
            mp.setattr(dist, op, lambda *args, **kwargs: None)
        ctx = init_frame_sharding(1, 1, "cpu")
        try:
            with META:
                models = dict(unet=UNet3DConditionModel(CONFIG), cn=ControlNetModel(CN_CONFIG))
            yield dict({k: m.to(BF16).eval() for k, m in models.items()},
                       ctx=dataclasses.replace(ctx, device=META))
        finally:
            dist.destroy_process_group()
            _build.reset_launch_counts()  # leave no stand-in launch for later tests
            tp.reset_collective_counts()


def split(sd15, t):
    """Copies of the models split for model rank 0 of a group of ``t``, and
    that group's context (its group a stand-in: the collectives are
    identities here)."""
    tp_ctx = dataclasses.replace(sd15["ctx"], model_group=object(), model_ranks=tuple(range(t)))
    unet, cn = copy.deepcopy(sd15["unet"]), copy.deepcopy(sd15["cn"])
    tp.shard_params_tp(unet, tp_ctx)
    tp.shard_params_tp(cn, tp_ctx)
    return unet, cn, tp_ctx


def edit_step(unet, cn, shard):
    masks = prepare_injection_masks(empty(F, LAT, LAT), F)
    denoise_segment(
        unet, CONFIG, cn, CN_CONFIG, SCHEDULE, 50, InjectionSpec.from_start_layer(10), 7.5, 1.0,
        empty(2, F, LAT, LAT, 4), SCHEDULE.inference_timesteps(50)[4:5], empty(2, 77, 768),
        empty(2, 77, 768), precompute_cond_embedding(cn, empty(2, F, 8 * LAT, 8 * LAT, 3)),
        masks, shard_ctx=shard)


def inversion(unet, cn, shard):
    ddim_invert(unet, CONFIG, SCHEDULE, empty(1, F, LAT, LAT, 4), empty(1, 77, 768), 1,
                normal_infer=False, shard_ctx=shard)


@pytest.mark.parametrize("path", ["denoise", "inversion"])
@pytest.mark.parametrize("frames", [1, 2], ids=["1xT", "FxT"])
@pytest.mark.parametrize("t", [2, 4])
def test_tp_launches_and_all_reduces_per_step(sd15, t, frames, path):
    unet, cn, tp_ctx = split(sd15, t)
    # (1, 1, T) runs the unsharded routes; (1, F, T) the frame route of the
    # one-rank frame group, its modules still split over the model group
    shard = tp_ctx if frames == 1 else sd15["ctx"]
    assert shard.shards_frames == (frames > 1)
    _build.reset_launch_counts()
    tp.reset_collective_counts()
    (edit_step if path == "denoise" else inversion)(unet, cn, shard)
    assert dict(_build.launch_counts) == cs.tp_expected((1, frames, t), shard.fp)[path]
    assert tp.collective_counts["all_reduce"] == cs.TP_ALL_REDUCES_PER_STEP[path]
    assert "all_gather" not in tp.collective_counts
    assert unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_q.weight.shape == (
        320 // t, 320)


def frame_route(sd15, t):
    """A (1, 2, t) rank's layout on the one-rank group: two frame ranks
    (the other a stand-in), the model group of t."""
    return dataclasses.replace(sd15["ctx"], frame_ranks=(0, 1), model_group=object(),
                               model_ranks=tuple(range(t)))


def null_text(unet, cn, shard):
    null_optimization(unet, CONFIG, SCHEDULE, empty(2, 1, F, LAT, LAT, 4), empty(1, 77, 768),
                      empty(1, 77, 768), 1, 1, 1e-2, 7.5, compute_dtype="bfloat16",
                      shard_ctx=shard)


def auto_step(unet, cn, shard):
    masks = prepare_injection_masks(empty(F, LAT, LAT), F)
    denoise_segment(
        unet, CONFIG, cn, CN_CONFIG, SCHEDULE, 50,
        InjectionSpec.from_start_layer(10, mask_mode="auto", auto_token_idx=(1,)), 7.5, 1.0,
        empty(2, F, LAT, LAT, 4), SCHEDULE.inference_timesteps(50)[4:5], empty(2, 77, 768),
        empty(2, 77, 768), precompute_cond_embedding(cn, empty(2, F, 8 * LAT, 8 * LAT, 3)),
        masks, shard_ctx=shard)


def p2p_step(unet, cn, shard):
    """An injected mask-mode step under the replace controller with
    LocalBlend (phase 12's)."""
    from motioneditor_tpu_torch.control.p2p import make_controller, make_local_blend
    from motioneditor_tpu_torch.models.clip_text import StubTokenizer

    prompts, tok = ["a girl is dancing", "a man is dancing"], StubTokenizer()
    masks = prepare_injection_masks(empty(F, LAT, LAT), F)
    maps = empty(_count_16x16_sites(LAT, LAT), 4 * F, 256, 77, dtype=torch.float32)
    denoise_segment(
        unet, CONFIG, cn, CN_CONFIG, SCHEDULE, 50, InjectionSpec.from_start_layer(10), 7.5, 1.0,
        empty(2, F, LAT, LAT, 4), SCHEDULE.inference_timesteps(50)[4:5], empty(2, 77, 768),
        empty(2, 77, 768), precompute_cond_embedding(cn, empty(2, F, 8 * LAT, 8 * LAT, 3)),
        masks, shard_ctx=shard, p2p_controller=make_controller(prompts, tok, 50),
        local_blend=make_local_blend(prompts, [["man"]] * 2, tok), seg_lo=4, maps_sum=maps)


def train_step(stage, use_8bit):
    def run(unet, cn, shard):
        module = stage1 if stage == 1 else stage2
        state = make_train_state(unet, module.TRAINABLE_MODULES,
                                 make_optimizer(3e-5, use_8bit=use_8bit), frozen_dtype=BF16)
        lat = empty(1, F, LAT, LAT, 4, dtype=torch.float32)
        enc = empty(1, 77, 768, dtype=torch.float32)
        kw = dict(remat=True, compute_dtype=BF16, shard_ctx=shard)
        if stage == 1:
            stage1.train_step_stage1(state, lat, enc, None, CONFIG, **kw)
        else:
            stage2.train_step_stage2(state, cn, lat, empty(1, F, 8 * LAT, 8 * LAT, 3), enc,
                                     None, CONFIG, CN_CONFIG, **kw)
    return run


PATHS = {"null_text": null_text, "auto": auto_step, "p2p": p2p_step,
         "stage1": train_step(1, False), "stage2": train_step(2, False),
         "stage1_8bit": train_step(1, True), "stage2_8bit": train_step(2, True)}
# 8-bit AdamW changes no launch and adds the same all-reduces on every
# layout: one layout each
CASES = [(t, frames, path) for t in (2, 4) for frames in (1, 2) for path in PATHS
         if not path.endswith("_8bit") or (t, frames) == ((2, 1) if "1" in path else (4, 2))]


@pytest.mark.parametrize("t,frames,path", CASES,
                         ids=[f"{t}-{'1xT' if f == 1 else 'FxT'}-{p}" for t, f, p in CASES])
def test_tp_paths_launches_and_all_reduces_per_step(sd15, t, frames, path, monkeypatch):
    # the frame route's halo exchange, to a stand-in frame rank: no data
    monkeypatch.setattr(dist, "P2POp", lambda *args: None)
    monkeypatch.setattr(dist, "batch_isend_irecv", lambda ops: [])
    unet, cn, tp_ctx = split(sd15, t)
    shard = tp_ctx if frames == 1 else frame_route(sd15, t)
    assert shard.shards_frames == (frames > 1)
    if path.startswith("stage"):
        with META:
            unet = UNet3DConditionModel(CONFIG).to(BF16)
        tp.shard_params_tp(unet, tp_ctx)
    _build.reset_launch_counts()
    tp.reset_collective_counts()
    PATHS[path](unet, cn, shard)
    assert dict(_build.launch_counts) == cs.tp_expected((1, frames, t))[path.split("_8")[0]]
    assert tp.collective_counts["all_reduce"] == cs.TP_ALL_REDUCES_PER_STEP[path]
    assert tp.collective_counts.get("broadcast", 0) == cs.TP_BROADCASTS_PER_STEP.get(
        path.split("_8")[0], 0)
    assert "all_gather" not in tp.collective_counts
