"""The port's frame-sharded denoise segment and stage-1 step on the CPU,
ranks over gloo started by ``torch.multiprocessing.spawn``
(tests/torch_sharding_workers.py; the collectives and the UNet forward are
in tests/test_torch_sharding.py):

- a 2-step injected denoise segment at fp = 2 against JAX's unsharded
  segment, mask and auto mode (atol 2e-3, as tests/test_torch_slice.py);
- a stage-1 step on a (data 2, frames 2) world: its loss against JAX's
  unsharded loss on the same noise (rtol 1e-4, as sharding_runner.py:343),
  its loss (rtol 1e-5) and updated trainables (atol 1e-6, Adam eps 1e-4 as
  tests/test_torch_training.py takes it) against the port's unsharded step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
from torch_sharding_workers import spawn
from motioneditor_tpu.control.injection import InjectionSpec as JaxInjectionSpec
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.controlnet import (
    precompute_cond_embedding as jax_precompute_cond_embedding,
)
from motioneditor_tpu.models.unet import init_unet, unet_apply as jax_unet_apply
from motioneditor_tpu.pipelines.editor import _jit_denoise_segment
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule
from motioneditor_tpu.schedulers import ddpm_add_noise as jax_add_noise

from motioneditor_tpu_torch.models.from_jax import controlnet_state_dict, unet_state_dict
from torch_port_helpers import JAX_TINY, TINY_KW, normal, random_params, setup_torch, tensor


# ---------------------------------------------------------------------------
# the injected denoise segment against JAX
# ---------------------------------------------------------------------------

SEG_F, SEG_HW = 4, 16


@pytest.fixture(scope="module")
def segment_weights():
    setup_torch()
    unet_tree = random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=41)
    cn_config = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
    cn_tree = random_params(lambda: init_controlnet(jax.random.PRNGKey(1), cn_config), seed=42)
    return unet_tree, cn_tree, cn_config


@pytest.mark.parametrize("mask_mode", ["mask", "auto"])
def test_sharded_denoise_segment_matches_jax(segment_weights, tmp_path, mask_mode):
    unet_tree, cn_tree, cn_config = segment_weights
    rng = np.random.default_rng(43)
    lat = normal(rng, (2, SEG_F, SEG_HW, SEG_HW, 4), 0.3)
    cond, uncond = normal(rng, (2, 7, 16), 0.3), normal(rng, (2, 7, 16), 0.3)
    skel = rng.random((2, SEG_F, 8 * SEG_HW, 8 * SEG_HW, 3)).astype(np.float32)
    masks = {(s, s): (rng.random((SEG_F, s * s, 1)) > 0.5).astype(np.float32)
             for s in (16, 8, 4, 2)}
    spec_kw = dict(mask_mode=mask_mode, auto_token_idx=(1, 2), auto_thres=0.3)
    seg_ts = JaxSchedule().inference_timesteps(50)[4:6]

    cn_params = jax.tree_util.tree_map(jnp.asarray, cn_tree)
    seg_fn = _jit_denoise_segment(
        JAX_TINY, cn_config, JaxSchedule(), 50, JaxInjectionSpec.from_start_layer(10, **spec_kw),
        7.5, 1.0, True, False)
    ref, _ = seg_fn(
        jax.tree_util.tree_map(jnp.asarray, unet_tree), cn_params, jnp.asarray(lat),
        jnp.asarray(seg_ts), jnp.asarray(cond), jnp.asarray(uncond), jnp.zeros((2, 1, 1, 1)),
        jax_precompute_cond_embedding(cn_params, jnp.asarray(skel)),
        {k: jnp.asarray(v) for k, v in masks.items()}, jnp.zeros(()))

    inputs = dict(config=TINY_KW, unet=unet_state_dict(unet_tree),
                  controlnet=controlnet_state_dict(cn_tree), spec=spec_kw, lat=tensor(lat),
                  seg_ts=list(seg_ts), cond=tensor(cond), uncond=tensor(uncond),
                  skel=tensor(skel), masks={k: tensor(v) for k, v in masks.items()})
    spawn(workers.denoise, (1, 2), tmp_path, inputs)
    out = torch.load(tmp_path / "out.pt")
    assert out.shape == lat.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3)


# ---------------------------------------------------------------------------
# the stage-1 step on a (data 2, frames 2) world
# ---------------------------------------------------------------------------


def test_sharded_stage1_step_matches_jax_and_unsharded(tmp_path):
    setup_torch()
    tree = random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=51)
    rng = np.random.default_rng(52)
    lat, enc = normal(rng, (2, 4, 16, 16, 4), 0.5), normal(rng, (2, 7, 16), 0.5)
    noise = normal(rng, lat.shape)
    t = np.array([437, 91], dtype=np.int64)

    @jax.jit
    def jax_loss(params, lat, noise, t, enc):
        noisy = jax_add_noise(JaxSchedule(), lat, noise, t)
        pred = jax_unet_apply(params, JAX_TINY, noisy, t, enc, use_flash=False)
        return jnp.mean((pred - noise) ** 2)

    ref_loss = float(jax_loss(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(lat),
                              jnp.asarray(noise), jnp.asarray(t), jnp.asarray(enc)))

    inputs = dict(config=TINY_KW, unet=unet_state_dict(tree), lat=tensor(lat), enc=tensor(enc),
                  noise=tensor(noise), timesteps=torch.from_numpy(t))
    spawn(workers.stage1_step, (2, 2), tmp_path, inputs)
    unsharded = torch.load(tmp_path / "unsharded0.pt")
    np.testing.assert_allclose(unsharded["loss"], ref_loss, rtol=1e-4)
    for rank in range(4):
        got = torch.load(tmp_path / f"sharded{rank}.pt")
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-4)
        np.testing.assert_allclose(got["loss"], unsharded["loss"], rtol=1e-5)
        assert got["trainable"].keys() == unsharded["trainable"].keys()
        for name, p in unsharded["trainable"].items():
            np.testing.assert_allclose(got["trainable"][name].numpy(), p.numpy(), atol=1e-6,
                                       err_msg=f"rank {rank}: {name}")
