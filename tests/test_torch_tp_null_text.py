"""Null-text optimization and null-text inversion under tensor parallelism
on the CPU: the tiny UNet split over the model group of a (1, 1, 2) and a
(1, 2, 2) layout of gloo ranks (tests/torch_tp_workers.py ``null_text``),
at the size and on the inputs of tests/test_torch_sharding_phases_null_text.py
(F = 4, 16x16 latents, fp32, 3 timesteps, 3 inner Adam steps, the early
stop reached at the first timestep and at no other):

- ``null_optimization`` along JAX's trajectory against JAX's
  ``_jit_null_optimization`` and the port's unsharded optimization, and
  ``null_text_inversion`` against JAX's inversion then optimization: the
  embeddings at atol 1e-3, x_T at 1e-4 (tests/test_torch_null_text.py's);
- every rank takes the unsharded run's inner steps and ends with the same
  embeddings, bit for bit: the embedding's gradient arrives summed over
  the model group, and model rank 0's loss and gradient are broadcast over
  it once per inner step.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
import torch_tp_workers as tp_workers
from motioneditor_tpu.models.unet import init_unet
from motioneditor_tpu.pipelines.editor import _jit_ddim_invert, _jit_null_optimization
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule

from motioneditor_tpu_torch.models.from_jax import unet_state_dict
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from motioneditor_tpu_torch.pipelines import editor
from motioneditor_tpu_torch.schedulers import DiffusionSchedule
from torch_port_helpers import JAX_TINY, TINY_KW, normal, random_params, setup_torch, tensor

TINY = UNetConfig(**TINY_KW)
F, HW, L, NUM_STEPS = 4, 16, 7, 3
# tests/test_torch_sharding_phases_null_text.py's: the unsharded run stops
# after 2 of 3 inner steps at the first timestep and takes all 3 at the others
OPT = dict(num_steps=NUM_STEPS, inner_steps=3, base_lr=1e-2, guidance_scale=7.5,
           early_stop_epsilon=0.17)
LAYOUTS = [(1, 1, 2), (1, 2, 2)]


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def case():
    """The weights and inputs, JAX's inversion and optimization along its
    trajectory, and the port's unsharded optimization with its inner
    steps."""
    setup_torch()
    weights = random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=1)
    rng = np.random.default_rng(9)
    lat, cond, uncond0 = (normal(rng, (1, F, HW, HW, 4), 0.3), normal(rng, (1, L, 16), 0.3),
                          normal(rng, (1, L, 16), 0.3))
    schedule = JaxSchedule()
    ts = jnp.asarray(schedule.inference_timesteps(NUM_STEPS))
    x_t, all_lat = _jit_ddim_invert(JAX_TINY, schedule, NUM_STEPS, False, True)(
        _jnp(weights), jnp.asarray(lat), jnp.asarray(cond), ts)
    opt = _jit_null_optimization(JAX_TINY, schedule, NUM_STEPS, OPT["inner_steps"],
                                 OPT["base_lr"], OPT["guidance_scale"], True, "float32", None,
                                 OPT["early_stop_epsilon"])
    jax_uncond = opt(_jnp(weights), all_lat, jnp.asarray(cond), jnp.asarray(uncond0), ts)
    unet = UNet3DConditionModel(TINY).eval()
    unet.load_state_dict(unet_state_dict(weights))
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(editor, "null_text_loss", tp_workers._counting_loss(calls))
        port = editor.null_optimization(
            unet, TINY, DiffusionSchedule(), tensor(all_lat), tensor(cond), tensor(uncond0),
            NUM_STEPS, OPT["inner_steps"], OPT["base_lr"], OPT["guidance_scale"],
            early_stop_epsilon=OPT["early_stop_epsilon"])
    inputs = dict(config=TINY_KW, unet=unet_state_dict(weights), lat=tensor(lat),
                  all_lat=tensor(all_lat), cond=tensor(cond), uncond0=tensor(uncond0), opt=OPT)
    return inputs, dict(x_t=np.asarray(x_t), uncond=np.asarray(jax_uncond), port=port,
                        calls=calls, uncond0=uncond0)


@pytest.fixture(scope="module", params=LAYOUTS, ids=["1x1x2", "1x2x2"])
def ranks(request, case, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_null_text")
    workers.spawn(tp_workers.null_text, request.param, tmp, case[0])
    return [torch.load(tmp / f"rank{r}.pt") for r in range(math.prod(request.param))]


def test_tp_null_optimization_matches_jax_and_unsharded(ranks, case):
    ref = case[1]
    uncond = ranks[0]["uncond"]
    assert uncond.shape == (NUM_STEPS, 1, L, 16) and uncond.dtype == torch.float32
    assert not np.allclose(ref["uncond"][0], ref["uncond0"], atol=1e-3)  # it moved
    np.testing.assert_allclose(uncond.numpy(), ref["uncond"], atol=1e-3)
    np.testing.assert_allclose(uncond.numpy(), ref["port"].numpy(), atol=1e-3)


def test_tp_null_text_takes_the_unsharded_inner_steps(ranks, case):
    calls = case[1]["calls"]
    steps = collections.Counter(calls)
    assert len(steps) == NUM_STEPS
    assert min(steps.values()) < OPT["inner_steps"] == max(steps.values())
    for rank in ranks:
        assert rank["calls"] == calls and rank["inversion_calls"] == calls
        # model rank 0's loss and gradient, once per inner step
        assert rank["counts"]["broadcast"] == len(calls)


def test_tp_null_text_embeddings_are_the_same_bits_on_every_rank(ranks):
    for rank in ranks[1:]:
        for key in ("uncond", "inversion_uncond", "x_t"):
            assert torch.equal(rank[key], ranks[0][key]), key


def test_tp_null_text_inversion_matches_jax(ranks, case):
    ref = case[1]
    np.testing.assert_allclose(ranks[0]["x_t"].numpy(), ref["x_t"], atol=1e-4)
    np.testing.assert_allclose(ranks[0]["inversion_uncond"].numpy(), ref["uncond"], atol=1e-3)
