"""The kernel launches per step that chip_smoke.py asserts on the card,
derived here on the CPU for the frame-sharded paths of phase 11 and the
unsharded paths they stand beside (phases 6 and 7), and the p2p edit of
phase 12 (whose hooks act below every kernel's gate).

SD-1.5 runs at full width in bf16 on the meta device (shapes, no data), 8
frames of 64x64 latents, in a one-rank process group whose collectives are
identities. Every attention wrapper takes its CUDA dispatch (the size gates,
the grad path, the body the routing rules pick) down to a stand-in kernel
library that launches nothing; the counts are the wrappers' own
``_build.launch_counts``, as on the card. So each expectation of
chip_smoke.py is pinned against the code's real routing, not written down by
hand: one step of each path against its ``EXPECTED_PER_*`` constant, and the
pipeline's runs against the sums phase 7 and phase 11 assert.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist

import chip_smoke as cs
from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.control.injection import InjectionSpec, prepare_injection_masks
from motioneditor_tpu_torch.models.clip_text import CLIPTextModel, StubTokenizer
from motioneditor_tpu_torch.models.controlnet import (
    ControlNetModel,
    controlnet_config,
    precompute_cond_embedding,
)
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from motioneditor_tpu_torch.models.vae import AutoencoderKL
from motioneditor_tpu_torch.parallel.mesh import init_frame_sharding
from motioneditor_tpu_torch.pipelines.editor import (
    MotionEditorPipeline,
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
    """The models on the meta device and a one-rank frame-sharding context
    on it, with the stand-in library in place."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "kernels", StandInLibrary)
        mp.setattr(_build, "stream_handle", lambda device: 0)
        mp.setattr(_build, "check_operands", lambda *args, **kwargs: None)
        for op in ("all_reduce", "all_gather", "broadcast"):
            # a one-rank group's collectives are identities
            mp.setattr(dist, op, lambda *args, **kwargs: None)
        ctx = init_frame_sharding(1, 1, "cpu")
        try:
            with META:
                models = dict(unet=UNet3DConditionModel(CONFIG), cn=ControlNetModel(CN_CONFIG),
                              vae=AutoencoderKL(), text=CLIPTextModel())
            yield dict({k: m.to(BF16).eval() for k, m in models.items()},
                       ctx=dataclasses.replace(ctx, device=META))
        finally:
            dist.destroy_process_group()
            _build.reset_launch_counts()  # leave no stand-in launch for later tests


def _shard(m, sharded):
    return m["ctx"] if sharded else None


def inversion(m, sharded):
    ddim_invert(m["unet"], CONFIG, SCHEDULE, empty(1, F, LAT, LAT, 4), empty(1, 77, 768), 1,
                normal_infer=False, shard_ctx=_shard(m, sharded))


def null_text(m, sharded):
    null_optimization(m["unet"], CONFIG, SCHEDULE, empty(2, 1, F, LAT, LAT, 4),
                      empty(1, 77, 768), empty(1, 77, 768), 1, 1, 1e-2, 7.5,
                      compute_dtype="bfloat16", shard_ctx=_shard(m, sharded))


def edit_step(m, sharded, injected):
    masks = prepare_injection_masks(empty(F, LAT, LAT), F)
    denoise_segment(
        m["unet"], CONFIG, m["cn"], CN_CONFIG, SCHEDULE, 50,
        InjectionSpec.from_start_layer(10) if injected else None, 7.5, 1.0,
        empty(2, F, LAT, LAT, 4), SCHEDULE.inference_timesteps(50)[4:5], empty(2, 77, 768),
        empty(2, 77, 768), precompute_cond_embedding(m["cn"], empty(2, F, 8 * LAT, 8 * LAT, 3)),
        masks, shard_ctx=_shard(m, sharded))


def train_step(m, sharded, stage):
    """One step of ``stage`` on a fresh SD-1.5 UNet, as phase 10 / 11 runs it."""
    with META:
        unet = UNet3DConditionModel(CONFIG)
    module = stage1 if stage == 1 else stage2
    state = make_train_state(unet, module.TRAINABLE_MODULES, make_optimizer(3e-5),
                             frozen_dtype=BF16)
    lat, enc = empty(1, F, LAT, LAT, 4, dtype=torch.float32), empty(1, 77, 768, dtype=torch.float32)
    kw = dict(remat=True, compute_dtype=BF16, shard_ctx=_shard(m, sharded))
    if stage == 1:
        stage1.train_step_stage1(state, lat, enc, None, CONFIG, **kw)
    else:
        stage2.train_step_stage2(state, m["cn"], lat, empty(1, F, 8 * LAT, 8 * LAT, 3), enc, None,
                                 CONFIG, CN_CONFIG, **kw)


def pipeline(m, sharded):
    return MotionEditorPipeline(unet=m["unet"], vae=m["vae"], text_encoder=m["text"],
                                controlnet=m["cn"], tokenizer=StubTokenizer(),
                                shard_ctx=_shard(m, sharded))


def pipeline_inversion(m, sharded):
    """null_text_inversion over 2 steps: 2 inversion and 2 null-text steps."""
    pipeline(m, sharded).null_text_inversion(empty(1, F, LAT, LAT, 4), "a man", num_steps=2)


def pipeline_edit(m, sharded):
    """The edit over 2 steps from start_step 1: one vanilla step, one
    injected, with masks and per-step embeddings, then the decode (its
    GroupNorms launch too)."""
    pipeline(m, sharded)(["a man", "a woman"], empty(2, F, LAT, LAT, 4),
                         empty(F, 8 * LAT, 8 * LAT, 3), source_masks=empty(F, 8 * LAT, 8 * LAT),
                         uncond_embeddings=empty(2, 1, 77, 768, dtype=torch.float32),
                         num_inference_steps=2, start_step=1)


def p2p_pipeline_edit(m, sharded):
    """``pipeline_edit`` under the replace controller with LocalBlend: the
    p2p hooks act at the 16x16 map sites and the cross-attention, below
    every kernel's gate, so the launches are the mask edit's."""
    from motioneditor_tpu_torch.control.p2p import make_controller, make_local_blend

    pipe = pipeline(m, sharded)
    prompts = ["a girl is dancing", "a man is dancing"]
    pipe(prompts, empty(2, F, LAT, LAT, 4), empty(F, 8 * LAT, 8 * LAT, 3),
         source_masks=empty(F, 8 * LAT, 8 * LAT),
         uncond_embeddings=empty(2, 1, 77, 768, dtype=torch.float32), num_inference_steps=2,
         start_step=1, p2p_controller=make_controller(prompts, pipe.tokenizer, 2),
         local_blend=make_local_blend(prompts, [["man"]] * 2, pipe.tokenizer))


CASES = {
    # phase 11: the frame-sharded paths in a one-rank group
    "sharded_inversion": (lambda m: inversion(m, True), cs.EXPECTED_PER_SHARDED_INVERSION_STEP),
    "sharded_null_text": (lambda m: null_text(m, True), cs.EXPECTED_PER_SHARDED_NULL_STEP),
    "sharded_vanilla_step": (lambda m: edit_step(m, True, False),
                             cs.EXPECTED_PER_SHARDED_VANILLA_STEP),
    "sharded_injected_step": (lambda m: edit_step(m, True, True), cs.EXPECTED_PER_SHARDED_STEP),
    "sharded_stage1": (lambda m: train_step(m, True, 1), cs.EXPECTED_PER_SHARDED_STAGE1_STEP),
    "sharded_stage2": (lambda m: train_step(m, True, 2), cs.EXPECTED_PER_SHARDED_STAGE2_STEP),
    "sharded_pipeline_inversion": (
        lambda m: pipeline_inversion(m, True),
        cs.add_counts(cs.scaled(cs.EXPECTED_PER_SHARDED_INVERSION_STEP, 2),
                      cs.scaled(cs.EXPECTED_PER_SHARDED_NULL_STEP, 2))),
    "sharded_pipeline_edit": (
        lambda m: pipeline_edit(m, True),
        cs.add_counts(cs.EXPECTED_PER_SHARDED_VANILLA_STEP, cs.EXPECTED_PER_SHARDED_STEP,
                      cs.VAE_DECODE_GROUP_NORMS)),
    "sharded_p2p_pipeline_edit": (
        lambda m: p2p_pipeline_edit(m, True),
        cs.add_counts(cs.EXPECTED_PER_SHARDED_VANILLA_STEP, cs.EXPECTED_PER_SHARDED_STEP,
                      cs.VAE_DECODE_GROUP_NORMS)),
    # phases 4, 6 and 7: the unsharded paths they stand beside
    "inversion": (lambda m: inversion(m, False), cs.EXPECTED_PER_INVERSION_STEP),
    "null_text": (lambda m: null_text(m, False), cs.EXPECTED_PER_NULL_STEP),
    "vanilla_step": (lambda m: edit_step(m, False, False), cs.EXPECTED_PER_VANILLA_STEP),
    "injected_step": (lambda m: edit_step(m, False, True), cs.EXPECTED_PER_STEP),
    "pipeline_inversion": (
        lambda m: pipeline_inversion(m, False),
        cs.add_counts(cs.scaled(cs.EXPECTED_PER_INVERSION_STEP, 2),
                      cs.scaled(cs.EXPECTED_PER_NULL_STEP, 2))),
    "pipeline_edit": (lambda m: pipeline_edit(m, False),
                      cs.add_counts(cs.EXPECTED_PER_VANILLA_STEP, cs.EXPECTED_PER_STEP,
                                    cs.VAE_DECODE_GROUP_NORMS)),
    # phase 12: the p2p edit
    "p2p_pipeline_edit": (lambda m: p2p_pipeline_edit(m, False),
                          cs.add_counts(cs.EXPECTED_PER_VANILLA_STEP, cs.EXPECTED_PER_STEP,
                                        cs.VAE_DECODE_GROUP_NORMS)),
}


@pytest.mark.parametrize("path", list(CASES))
def test_launches_per_step_match_chip_smoke(sd15, path):
    run, expected = CASES[path]
    _build.reset_launch_counts()
    run(sd15)
    assert dict(_build.launch_counts) == expected
