"""Stage-1 training and its checkpoints under tensor parallelism on the CPU:
the tiny UNet of tests/test_torch_training.py (F = 2, 16x16 latents) split
over the model group of a (1, 1, 2) and a (1, 2, 2) layout of gloo ranks
(tests/torch_tp_workers.py ``train``), two steps with gradient
checkpointing, with AdamW and with 8-bit AdamW, the clip acting
(tests/torch_tp_train_helpers.py):

- the first step against JAX's (the loss to 1e-5 relative, the trainables
  to 1e-6), both steps against the port's unsharded run (the same);
- every rank holds the same full trainables, bit for bit, and model rank
  m the m-th block of each split one;
- the checkpoint a (1, 1, 2) or (1, 2, 2) run writes is the full-width
  file: the unsharded run's keys, shapes and dtypes, its trainables those
  the ranks gathered, within the step's tolerance of the unsharded file
  (AdamW's moments to 1e-4 of their largest magnitude, 8-bit codes within
  one code, their scales within what one code's step at the first step
  moves them, 1e-2); it restores at T = 1 into an unsplit state,
  and at T = 2 into the same blocks and moments, bit for bit.
"""

import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
import torch_tp_train_helpers as H
import torch_tp_workers as tp_workers
from motioneditor_tpu.models.unet import unet_apply as jax_unet_apply
from motioneditor_tpu.training import common as JT
from motioneditor_tpu.training.stage1 import TRAINABLE_MODULES as JAX_MODULES

from motioneditor_tpu_torch.models.unet import UNetConfig
from motioneditor_tpu_torch.training import stage1
from motioneditor_tpu_torch.training.checkpoint import restore_train_state
from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state
from torch_port_helpers import JAX_TINY, TINY_KW, normal, setup_torch, tensor, tiny_unet

TINY = UNetConfig(**TINY_KW)
F, HW, L = 2, 16, 7


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    setup_torch()
    params, unet = tiny_unet(seed=21)
    rng = np.random.default_rng(22)
    lat, enc = normal(rng, (1, F, HW, HW, 4), 0.5), normal(rng, (1, L, 16), 0.5)
    draw_list = H.draws(rng, lat.shape)

    def loss_fn(trainable, frozen, noisy, t, noise):
        pred = jax_unet_apply(JT.combine_params(trainable, frozen), JAX_TINY, noisy, t,
                              jnp.asarray(enc))
        return jnp.mean((pred.astype(jnp.float32) - noise) ** 2)

    jax_out, jax_loss = H.jax_first_step(params, JAX_MODULES, loss_fn, draw_list[0], lat)
    tmp = tmp_path_factory.mktemp("tp_stage1_unsharded")
    port = H.port_steps(unet, stage1, lambda s: stage1.train_step_stage1(
        s, tensor(lat), tensor(enc), torch.Generator(), TINY, remat=True), draw_list, tmp)
    inputs = dict(config=TINY_KW, unet=unet.state_dict(), stage=1, lat=tensor(lat),
                  enc=tensor(enc), draws=draw_list, optimizers=H.OPTIMIZERS)
    return inputs, jax_out, jax_loss, port, unet


@pytest.fixture(scope="module", params=H.LAYOUTS, ids=["1x1x2", "1x2x2"])
def ranks(request, case, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_stage1")
    workers.spawn(tp_workers.train, request.param, tmp, case[0])
    return request.param, [torch.load(tmp / f"rank{r}.pt")
                           for r in range(math.prod(request.param))]


def test_tp_stage1_first_step_matches_jax(ranks, case):
    H.check_first_step(ranks[1][0], case[1], case[2])


def test_tp_stage1_steps_match_unsharded(ranks, case):
    H.check_against_unsharded(ranks[1][0], case[3])


def test_tp_stage1_ranks_hold_the_same_bits_and_their_blocks(ranks):
    H.check_same_bits(ranks[1])
    H.check_split(ranks[1], ranks[0])


def _payload(path):
    return torch.load(f"{path}/state.pt", weights_only=True)


@pytest.mark.parametrize("opt", list(H.OPTIMIZERS))
def test_tp_checkpoint_is_the_full_width_file(ranks, case, opt):
    got = ranks[1][0][opt]
    tp_file, one_file = _payload(got["path"]), _payload(case[3][opt][2])
    assert tp_file["step"] == one_file["step"] == 2
    for n, v in one_file["trainable"].items():
        assert torch.equal(tp_file["trainable"][n], got["steps"][-1]["trainable"][n]), n
        np.testing.assert_allclose(tp_file["trainable"][n].numpy(), v.numpy(), atol=1e-6)
    assert tp_file["opt_state"]["state"].keys() == one_file["opt_state"]["state"].keys()
    for i, st in one_file["opt_state"]["state"].items():
        mine = tp_file["opt_state"]["state"][i]
        assert mine.keys() == st.keys()
        for k, v in st.items():
            a = mine[k]
            if not torch.is_tensor(v):
                assert a == v, k
                continue
            assert a.shape == v.shape and a.dtype == v.dtype, (i, k)
            if k in ("m", "v"):
                assert (a.int() - v.int()).abs().max() <= 1, (i, k)
            elif k in ("m_scale", "v_scale"):
                # a code one step off at step 1 moves its block's maximum at
                # step 2 by up to 2 / 255 of it
                np.testing.assert_allclose(a.numpy(), v.numpy(), rtol=1e-2, atol=0)
            elif k != "step":
                top = float(v.abs().max())
                np.testing.assert_allclose(a.numpy(), v.numpy(), rtol=1e-4, atol=1e-4 * top)


@pytest.mark.parametrize("opt", list(H.OPTIMIZERS))
def test_tp_checkpoint_restores_at_one_and_two_ranks(ranks, case, opt):
    got = ranks[1][0][opt]
    assert got["restored_equal"]
    state = make_train_state(copy.deepcopy(case[4]), stage1.TRAINABLE_MODULES,
                             make_optimizer(**H.OPTIMIZERS[opt]))
    restore_train_state(got["path"], state)
    saved = _payload(got["path"])
    assert state.step == 2
    for n, p in state.trainable.items():
        assert torch.equal(p.detach(), saved["trainable"][n]), n
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            if torch.is_tensor(v) and k != "step":
                assert torch.equal(v.to(saved["opt_state"]["state"][i][k].dtype),
                                   saved["opt_state"]["state"][i][k]), (i, k)
