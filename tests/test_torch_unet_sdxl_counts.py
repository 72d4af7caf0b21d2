"""The kernel launches of one stage-1 step of SDXL's video UNet at the
benchmark's train-sdxl-8f shapes (8 frames of 128x128 latents, bf16,
checkpointing, the fused-norm knobs off), derived on the meta device with a
stand-in kernel library as tests/test_torch_sharding_phases_counts.py
derives SD-1.5's, against chip_smoke.EXPECTED_PER_SDXL_STAGE1_STEP: K4, K5
and K6 at heads of 64 on their tensor-core bodies, K3 and K7 at 10 and 20
heads, and the GroupNorm pair."""

import torch

import chip_smoke as cs
from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.models.unet import SDXL_BASE, UNet3DConditionModel
from motioneditor_tpu_torch.ops import fused_norm, gn_stats
from motioneditor_tpu_torch.training import stage1
from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state

META, BF16 = torch.device("meta"), torch.bfloat16


class StandInLibrary:
    """The kernel library's ``me_*`` entry points, each returning 0
    (launched) and launching nothing."""

    def __getattr__(self, name):
        if not name.startswith("me_"):
            raise AttributeError(name)
        return lambda *args: 0


def empty(*shape):
    return torch.empty(shape, device=META)


def test_sdxl_stage1_launches_match_chip_smoke(monkeypatch):
    monkeypatch.setattr(_build, "kernels", StandInLibrary)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_build, "check_operands", lambda *args, **kwargs: None)
    assert not gn_stats.enabled() and not fused_norm.enabled()  # the cell's knobs
    with META:
        unet = UNet3DConditionModel(SDXL_BASE, include_adapter=False)
    state = make_train_state(unet.to(BF16), stage1.TRAINABLE_MODULES, make_optimizer(3e-5),
                             frozen_dtype=BF16)
    f, lat = cs.SDXL_FRAMES, cs.SDXL_LATENT
    added = {"text_embeds": empty(1, 1280), "time_ids": empty(1, 6)}
    _build.reset_launch_counts()
    try:
        stage1.train_step_stage1(state, empty(1, f, lat, lat, 4), empty(1, 77, 2048), None,
                                 SDXL_BASE, remat=True, compute_dtype=BF16,
                                 added_cond_kwargs=added)
        assert dict(_build.launch_counts) == cs.EXPECTED_PER_SDXL_STAGE1_STEP
    finally:
        _build.reset_launch_counts()  # leave no stand-in launch for later tests
