"""The p2p and the auto-mask denoise segments under tensor parallelism on the
CPU: the tiny UNet with its adapter and the ControlNet split over the model
group of a (1, 1, 2) and a (1, 2, 2) layout of gloo ranks
(tests/torch_tp_workers.py ``segments``), fp32, the models and inputs of
tests/torch_p2p_helpers.py ``check_segment`` (F = 2, 16x16 latents: level
0 is a 256-token map site), two injected steps of a 6-step schedule:

- mask mode under the replace controller with LocalBlend, from a nonzero
  running map sum, at the threshold ``chip_smoke.clear_threshold`` picks
  on the unsharded port; every LocalBlend map value of every rank must lie
  more than ``chip_smoke.P2P_MARGIN`` from it;
- auto mode (the auto mask from the 16x16 cross-attention maps, token 2,
  threshold 0.5), no controller.

Against JAX's unsharded ``_jit_denoise_segment``: the latents at atol 2e-3
and the map sum at 1e-4, the tolerances of tests/torch_p2p_helpers.py;
against the port's unsharded segment at 1e-4 (as
tests/test_torch_tp_phases.py). The maps the sites collect are the full
width's: one model-group all-reduce per collecting site per step on top of
the segment's 98 (48 UNet, 36 adapter, 14 ControlNet).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import torch_sharding_workers as workers
import torch_tp_workers as tp_workers
from motioneditor_tpu.control import p2p as JP
from motioneditor_tpu.control.injection import InjectionSpec as JaxInjectionSpec
from motioneditor_tpu.models.controlnet import (
    precompute_cond_embedding as jax_precompute_cond_embedding,
)
from motioneditor_tpu.pipelines import editor as JE
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule

from motioneditor_tpu_torch.control.injection import InjectionSpec
from motioneditor_tpu_torch.control.p2p import LocalBlend
from motioneditor_tpu_torch.models.controlnet import controlnet_config, precompute_cond_embedding
from motioneditor_tpu_torch.models.unet import UNetConfig
from motioneditor_tpu_torch.pipelines import editor as TE
from motioneditor_tpu_torch.schedulers import DiffusionSchedule
from test_p2p import WordTokenizer
from torch_p2p_helpers import F, HW, STEPS, controllers, models  # noqa: F401
from torch_port_helpers import JAX_TINY, TINY_KW, normal

MODES = {"mask": {}, "auto": dict(mask_mode="auto", auto_token_idx=(2,), auto_thres=0.5)}
SEG_LO, SITES = 3, 5  # the 16x16 map sites at 16x16 latents: down block 0, up block 3
ALL_REDUCES = 48 + 36 + 14 + SITES  # per step and rank


@pytest.fixture(scope="module")
def case(models):  # noqa: F811
    """The inputs, the controller and threshold, and JAX's and the port's
    unsharded segments of each mode."""
    unet_tree, unet, cn_params, cn, cn_jax_config = models
    t_ctl, j_ctl, t_lb, _ = controllers("replace", WordTokenizer())
    rng = np.random.default_rng(24)
    lat0 = normal(rng, (2, F, HW, HW, 4), 0.3)
    cond, uncond = (normal(rng, (2, 77, 16), 0.3) for _ in range(2))
    skel = rng.random((2, F, 8 * HW, 8 * HW, 3)).astype(np.float32)
    masks = {(s, s): (rng.random((F, s * s, 1)) > 0.5).astype(np.float32)
             for s in (16, 8, 4, 2)}
    maps0 = rng.random((SITES, 4 * F, 256, 77), dtype=np.float32) * 0.01
    seg_ts = JaxSchedule().inference_timesteps(STEPS)[SEG_LO:SEG_LO + 2]
    tiny = UNetConfig(**TINY_KW)
    with torch.no_grad():
        cond_emb = precompute_cond_embedding(cn, torch.from_numpy(skel))

    def run_port(mode, blend=None):
        maps_sum = torch.from_numpy(maps0.copy()) if mode == "mask" else None
        out = TE.denoise_segment(
            unet, tiny, cn, controlnet_config(tiny), DiffusionSchedule(), STEPS,
            InjectionSpec.from_start_layer(10, **MODES[mode]), 7.5, 1.0, torch.from_numpy(lat0),
            seg_ts, torch.from_numpy(cond), torch.from_numpy(uncond), cond_emb,
            {k: torch.from_numpy(v) for k, v in masks.items()}, use_flash=False,
            p2p_controller=t_ctl if mode == "mask" else None, local_blend=blend, seg_lo=SEG_LO,
            maps_sum=maps_sum)
        return out, maps_sum

    threshold = cs.clear_threshold(t_lb.alpha_layers, lambda blend: run_port("mask", blend))
    port = {"mask": run_port("mask", LocalBlend(t_lb.alpha_layers, threshold)),
            "auto": run_port("auto")}
    cond_emb_jax = jax_precompute_cond_embedding(cn_params, jnp.asarray(skel))
    jax_ref = {}
    for mode in MODES:
        p2p = mode == "mask"
        fn = JE._jit_denoise_segment(
            JAX_TINY, cn_jax_config, JaxSchedule(), STEPS,
            JaxInjectionSpec.from_start_layer(10, **MODES[mode]), 7.5, 1.0, False, False,
            *((j_ctl, JP.LocalBlend(alpha_layers=t_lb.alpha_layers, threshold=threshold),
               SEG_LO) if p2p else ()))
        jax_ref[mode] = fn(unet_tree, cn_params, jnp.asarray(lat0), jnp.asarray(seg_ts),
                           jnp.asarray(cond), jnp.asarray(uncond),
                           jnp.zeros((len(seg_ts), 1, 1, 1)), cond_emb_jax,
                           {k: jnp.asarray(v) for k, v in masks.items()},
                           jnp.asarray(maps0) if p2p else jnp.zeros(()))
    ctl_fields = {k: getattr(t_ctl, k) for k in (
        "kind", "num_steps", "cross_alpha", "self_replace_until", "mapper", "refine_alphas",
        "equalizer")}
    inputs = dict(config=TINY_KW, unet={k: v.clone() for k, v in unet.state_dict().items()},
                  controlnet=cn.state_dict(), lat=torch.from_numpy(lat0),
                  cond=torch.from_numpy(cond), uncond=torch.from_numpy(uncond),
                  skel=torch.from_numpy(skel),
                  masks={k: torch.from_numpy(v) for k, v in masks.items()},
                  maps0=torch.from_numpy(maps0), seg_ts=list(seg_ts), steps=STEPS,
                  seg_lo=SEG_LO, modes=MODES, controller=ctl_fields, alpha=t_lb.alpha_layers,
                  threshold=threshold)
    return inputs, port, jax_ref


@pytest.fixture(scope="module", params=[(1, 1, 2), (1, 2, 2)], ids=["1x1x2", "1x2x2"])
def ranks(request, case, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_segments")
    workers.spawn(tp_workers.segments, request.param, tmp, case[0])
    return [torch.load(tmp / f"rank{r}.pt") for r in range(math.prod(request.param))]


@pytest.mark.parametrize("mode", list(MODES))
def test_tp_segment_matches_jax_and_unsharded(ranks, case, mode):
    _, port, jax_ref = case
    got = ranks[0][mode]
    ref = jax_ref[mode][0]  # (latents, map sum)
    assert got["latents"].shape == port[mode][0].shape and torch.isfinite(got["latents"]).all()
    np.testing.assert_allclose(got["latents"].numpy(), np.asarray(ref), atol=2e-3)
    np.testing.assert_allclose(got["latents"].numpy(), port[mode][0].numpy(), atol=1e-4)
    if mode == "mask":
        assert got["gap"] > cs.P2P_MARGIN
        np.testing.assert_allclose(got["maps_sum"].numpy(), np.asarray(jax_ref[mode][1]),
                                   atol=1e-4)
        np.testing.assert_allclose(got["maps_sum"].numpy(), port[mode][1].numpy(), atol=1e-4)


@pytest.mark.parametrize("mode", list(MODES))
def test_tp_segment_is_the_same_bits_on_every_model_rank(ranks, mode):
    for rank in ranks[1:]:
        for key in ("latents", "maps_sum"):
            if key in ranks[0][mode]:
                assert torch.equal(rank[mode][key], ranks[0][mode][key]), key


def test_tp_segment_all_reduces_per_step(ranks):
    for rank in ranks:
        for mode in MODES:
            assert rank[mode]["all_reduce"] == ALL_REDUCES * 2, mode
