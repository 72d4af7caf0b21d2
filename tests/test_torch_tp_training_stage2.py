"""Stage-2 adapter training under tensor parallelism on the CPU: the tiny
UNet with its adapter and the tiny ControlNet of
tests/test_torch_training_stage2.py (F = 2, 8x8 latents, 64x64 skeleton
frames), both split over the model group of a (1, 1, 2) and a (1, 2, 2)
layout of gloo ranks (tests/torch_tp_workers.py ``train``), two steps with
gradient checkpointing, with AdamW and with 8-bit AdamW, the clip acting
(tests/torch_tp_train_helpers.py):

- the first step against JAX's (the loss to 1e-5 relative, the adapter's
  parameters to 1e-6), both steps against the port's unsharded run;
- every rank holds the same full adapter, bit for bit, and model rank m
  the m-th block of each split weight;
- the adapter file a split run writes is the full-width file (the
  unsharded adapter's keys and shapes, within 1e-6 of its values), and it
  loads back into the same blocks.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
import torch_tp_train_helpers as H
import torch_tp_workers as tp_workers
from motioneditor_tpu.models.controlnet import controlnet_apply as jax_controlnet_apply
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.unet import unet_apply as jax_unet_apply
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule
from motioneditor_tpu.schedulers import ddpm_add_noise as jax_add_noise
from motioneditor_tpu.training import common as JT

from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
from motioneditor_tpu_torch.models.from_jax import controlnet_state_dict
from motioneditor_tpu_torch.models.unet import UNetConfig
from motioneditor_tpu_torch.training import stage2
from torch_port_helpers import (
    JAX_TINY,
    TINY_KW,
    normal,
    random_params,
    setup_torch,
    tensor,
    tiny_unet,
    to_jax,
)

TINY = UNetConfig(**TINY_KW)
JAX_CN = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
F, HW, L = 2, 8, 7


@pytest.fixture(scope="module")
def case():
    setup_torch()
    params, unet = tiny_unet(seed=31)
    cn_tree = random_params(lambda: init_controlnet(jax.random.PRNGKey(1), JAX_CN), seed=32)
    cn = ControlNetModel(controlnet_config(TINY)).eval()
    cn.load_state_dict(controlnet_state_dict(cn_tree))
    cn.requires_grad_(False)
    rng = np.random.default_rng(33)
    lat, enc = normal(rng, (1, F, HW, HW, 4), 0.5), normal(rng, (1, L, 16), 0.5)
    skel = rng.uniform(0.0, 1.0, (1, F, 8 * HW, 8 * HW, 3)).astype(np.float32)
    draw_list = H.draws(rng, lat.shape)
    cn_params = to_jax(cn_tree)

    # the frozen ControlNet's residuals, outside the gradient (stage2.py's
    # stop_gradient), compiled on their own
    noisy0 = jax_add_noise(JaxSchedule(), jnp.asarray(lat), *(
        jnp.asarray(x.numpy()) for x in draw_list[0]))
    down, mid = jax.jit(lambda x, t: jax_controlnet_apply(
        cn_params, JAX_CN, x, t, jnp.asarray(enc), jnp.asarray(skel),
        conditioning_scale=1.0))(noisy0, jnp.asarray(draw_list[0][1].numpy()))

    def loss_fn(trainable, frozen, noisy, t, noise):
        pred = jax_unet_apply(JT.combine_params(trainable, frozen), JAX_TINY, noisy, t,
                              jnp.asarray(enc), down_block_additional_residuals=down,
                              mid_block_additional_residual=mid)
        return jnp.mean((pred.astype(jnp.float32) - noise) ** 2)

    jax_out, jax_loss = H.jax_first_step(params, stage2.TRAINABLE_MODULES, loss_fn,
                                         draw_list[0], lat)
    port = H.port_steps(unet, stage2, lambda s: stage2.train_step_stage2(
        s, cn, tensor(lat), tensor(skel), tensor(enc), torch.Generator(), TINY,
        controlnet_config(TINY), remat=True), draw_list)
    inputs = dict(config=TINY_KW, unet=unet.state_dict(), controlnet=cn.state_dict(), stage=2,
                  lat=tensor(lat), enc=tensor(enc), skel=tensor(skel), draws=draw_list,
                  optimizers=H.OPTIMIZERS)
    return inputs, jax_out, jax_loss, port


@pytest.fixture(scope="module", params=H.LAYOUTS, ids=["1x1x2", "1x2x2"])
def ranks(request, case, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_stage2")
    workers.spawn(tp_workers.train, request.param, tmp, case[0])
    return request.param, [torch.load(tmp / f"rank{r}.pt")
                           for r in range(math.prod(request.param))]


def test_tp_stage2_first_step_matches_jax(ranks, case):
    H.check_first_step(ranks[1][0], case[1], case[2])


def test_tp_stage2_steps_match_unsharded(ranks, case):
    H.check_against_unsharded(ranks[1][0], case[3])


def test_tp_stage2_ranks_hold_the_same_bits_and_their_blocks(ranks):
    H.check_same_bits(ranks[1])
    H.check_split(ranks[1], ranks[0])
    for rank in ranks[1]:
        assert all(got["restored_equal"] and got["adapter_equal"] for got in rank.values())


@pytest.mark.parametrize("opt", list(H.OPTIMIZERS))
def test_tp_adapter_file_is_the_full_width_file(ranks, case, opt):
    got = ranks[1][0][opt]
    saved = torch.load(f"{got['adapter_path']}/adapter.pt", weights_only=True)
    final = case[3][opt][1][-1]
    prefix = "controlnet_adapter."
    want = {n[len(prefix):]: p for n, p in final.items()}
    assert set(want) <= set(saved)
    for n, p in want.items():
        assert saved[n].shape == p.shape, n
        np.testing.assert_allclose(saved[n].numpy(), p.numpy(), atol=1e-6, err_msg=n)
