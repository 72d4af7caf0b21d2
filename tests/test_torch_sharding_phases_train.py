"""The port's frame-sharded stage-2 step on the CPU: a (data 2, frames 2)
world of gloo ranks (tests/torch_sharding_workers.py), the tiny UNet with
its adapter and the tiny ControlNet (F = 4, 16x16 latents, 128 px skeleton
frames, batch 2), fp32, on noise and timesteps the test draws:

- the loss against JAX's unsharded stage-2 loss on the same noise (rtol
  1e-4, as the stage-1 case of tests/test_torch_sharding_pipeline.py);
- the loss (rtol 1e-5) and the adapter's parameters after one AdamW step
  (atol 1e-6, Adam eps 1e-4 as tests/test_torch_training_stage2.py takes
  it) against the port's unsharded step, on every rank.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
from torch_sharding_workers import spawn
from motioneditor_tpu.models.controlnet import controlnet_apply as jax_controlnet_apply
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.unet import init_unet, unet_apply as jax_unet_apply
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule
from motioneditor_tpu.schedulers import ddpm_add_noise as jax_add_noise

from motioneditor_tpu_torch.models.from_jax import controlnet_state_dict, unet_state_dict
from torch_port_helpers import JAX_TINY, TINY_KW, normal, random_params, setup_torch, tensor, to_jax

JAX_CN = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
B, F, HW, L = 2, 4, 16, 7


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX's loss, and every rank's results of the sharded and (rank 0) the
    unsharded step."""
    setup_torch()
    unet_tree = random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=81)
    cn_tree = random_params(lambda: init_controlnet(jax.random.PRNGKey(1), JAX_CN), seed=82)
    rng = np.random.default_rng(83)
    lat, enc = normal(rng, (B, F, HW, HW, 4), 0.5), normal(rng, (B, L, 16), 0.5)
    skel = rng.uniform(0.0, 1.0, (B, F, 8 * HW, 8 * HW, 3)).astype(np.float32)
    noise = normal(rng, lat.shape)
    t = np.array([437, 91], dtype=np.int64)

    @jax.jit
    def jax_loss(params, cn_params, lat, noise, t, enc, skel):
        noisy = jax_add_noise(JaxSchedule(), lat, noise, t)
        down, mid = jax_controlnet_apply(cn_params, JAX_CN, noisy, t, enc, skel,
                                         conditioning_scale=1.0, use_flash=False)
        pred = jax_unet_apply(params, JAX_TINY, noisy, t, enc,
                              down_block_additional_residuals=down,
                              mid_block_additional_residual=mid, use_flash=False)
        return jnp.mean((pred - noise) ** 2)

    ref_loss = float(jax_loss(to_jax(unet_tree), to_jax(cn_tree), *(
        jnp.asarray(a) for a in (lat, noise, t, enc, skel))))
    tmp = tmp_path_factory.mktemp("stage2")
    spawn(workers.stage2_step, (2, 2), tmp,
          dict(config=TINY_KW, unet=unet_state_dict(unet_tree),
               controlnet=controlnet_state_dict(cn_tree), lat=tensor(lat), enc=tensor(enc),
               skel=tensor(skel), noise=tensor(noise), timesteps=torch.from_numpy(t)))
    return (ref_loss, torch.load(tmp / "unsharded0.pt"),
            [torch.load(tmp / f"sharded{r}.pt") for r in range(4)])


def test_sharded_stage2_loss_matches_jax(case):
    ref_loss, unsharded, sharded = case
    np.testing.assert_allclose(unsharded["loss"], ref_loss, rtol=1e-4)
    for got in sharded:
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-4)


@pytest.mark.parametrize("rank", range(4))
def test_sharded_stage2_step_matches_unsharded(case, rank):
    _, unsharded, sharded = case
    got = sharded[rank]
    np.testing.assert_allclose(got["loss"], unsharded["loss"], rtol=1e-5)
    assert got["trainable"].keys() == unsharded["trainable"].keys()
    assert all("controlnet_adapter" in name for name in got["trainable"])
    for name, p in unsharded["trainable"].items():
        np.testing.assert_allclose(got["trainable"][name].numpy(), p.numpy(), atol=1e-6,
                                   err_msg=f"rank {rank}: {name}")
