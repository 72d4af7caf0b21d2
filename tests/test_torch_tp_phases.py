"""The injected denoise segment and DDIM inversion under tensor parallelism,
on the CPU over gloo ranks (tests/torch_tp_workers.py): the tiny UNet with
its adapter and the ControlNet split over the model group of a (1, 1, 2)
and a (1, 2, 2) layout, against rank 0's unsharded run of the port and
against JAX's unsharded ``_jit_denoise_segment`` / ``_jit_ddim_invert``:

- the segment: mask injection from block 10, 2 steps, 4 frames of 16x16
  latents, atol 2e-3 against JAX (as tests/test_torch_sharding_pipeline.py)
  and 1e-4 against the unsharded port;
- inversion: video attention, 2 steps, 4 frames of 32x32 latents, where
  level-0 attention takes the kernels' routes at head-local widths (their
  plain versions on the CPU), atol 1e-4 against both.

Each rank's model-group all-reduces: one per split attention module
called, per step 48 in the UNet, 36 in the adapter and 14 in the ControlNet
(its 7 blocks x attn1 and attn2) for the segment, 48 for inversion.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_workers as tp_workers
import torch_sharding_workers as workers
from motioneditor_tpu.control.injection import InjectionSpec as JaxInjectionSpec
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.controlnet import (
    precompute_cond_embedding as jax_precompute_cond_embedding,
)
from motioneditor_tpu.models.unet import init_unet
from motioneditor_tpu.pipelines.editor import _jit_ddim_invert, _jit_denoise_segment
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule

from motioneditor_tpu_torch.models.from_jax import controlnet_state_dict, unet_state_dict
from torch_port_helpers import JAX_TINY, TINY_KW, normal, random_params, setup_torch, tensor

F, SEG_HW, INV_HW, STEPS = 4, 16, 32, 2
SEGMENT_ALL_REDUCES, INVERSION_ALL_REDUCES = 48 + 36 + 14, 48  # per step


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def case():
    """The weights, the inputs and JAX's unsharded segment and inversion."""
    setup_torch()
    unet_tree = random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=71)
    cn_config = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    cn_tree = random_params(lambda: init_controlnet(jax.random.PRNGKey(1), cn_config), seed=72)
    rng = np.random.default_rng(73)
    lat = normal(rng, (2, F, SEG_HW, SEG_HW, 4), 0.3)
    cond, uncond = normal(rng, (2, 7, 16), 0.3), normal(rng, (2, 7, 16), 0.3)
    skel = rng.random((2, F, 8 * SEG_HW, 8 * SEG_HW, 3)).astype(np.float32)
    masks = {(s, s): (rng.random((F, s * s, 1)) > 0.5).astype(np.float32)
             for s in (16, 8, 4, 2)}
    inv_lat, inv_cond = normal(rng, (1, F, INV_HW, INV_HW, 4), 0.3), normal(rng, (1, 7, 16), 0.3)
    schedule = JaxSchedule()
    seg_ts = schedule.inference_timesteps(50)[4:6]

    cn_params = _jnp(cn_tree)
    seg_ref, _ = _jit_denoise_segment(
        JAX_TINY, cn_config, schedule, 50, JaxInjectionSpec.from_start_layer(10), 7.5, 1.0,
        True, False)(
        _jnp(unet_tree), cn_params, jnp.asarray(lat), jnp.asarray(seg_ts), jnp.asarray(cond),
        jnp.asarray(uncond), jnp.zeros((2, 1, 1, 1)),
        jax_precompute_cond_embedding(cn_params, jnp.asarray(skel)), _jnp(masks), jnp.zeros(()))
    _, inv_ref = _jit_ddim_invert(JAX_TINY, schedule, STEPS, False, False)(
        _jnp(unet_tree), jnp.asarray(inv_lat), jnp.asarray(inv_cond),
        jnp.asarray(schedule.inference_timesteps(STEPS)))
    inputs = dict(config=TINY_KW, unet=unet_state_dict(unet_tree),
                  controlnet=controlnet_state_dict(cn_tree), lat=tensor(lat),
                  seg_ts=list(seg_ts), cond=tensor(cond), uncond=tensor(uncond),
                  skel=tensor(skel), masks={k: tensor(v) for k, v in masks.items()},
                  inv_lat=tensor(inv_lat), inv_cond=tensor(inv_cond), inv_steps=STEPS)
    return inputs, {"segment": np.asarray(seg_ref), "inversion": np.asarray(inv_ref)}


@pytest.mark.parametrize("layout", [(1, 1, 2), (1, 2, 2)], ids=["1x1x2", "1x2x2"])
def test_tp_segment_and_inversion_match_unsharded_and_jax(case, tmp_path, layout):
    inputs, ref = case
    workers.spawn(tp_workers.phases, layout, tmp_path, inputs)
    out = torch.load(tmp_path / "out.pt")
    for phase, atol_jax in (("segment", 2e-3), ("inversion", 1e-4)):
        got, one = out["tp"][phase], out["one"][phase]
        assert got.shape == ref[phase].shape and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), ref[phase], atol=atol_jax, err_msg=phase)
        np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-4, err_msg=phase)
    for rank in range(math.prod(layout)):
        counts = torch.load(tmp_path / f"counts{rank}.pt")
        assert counts["segment"]["all_reduce"] == SEGMENT_ALL_REDUCES * STEPS
        assert counts["inversion"]["all_reduce"] == INVERSION_ALL_REDUCES * STEPS
        assert "all_gather" not in counts["segment"]
