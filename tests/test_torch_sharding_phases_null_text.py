"""The port's frame-sharded null-text optimization and null-text inversion
on the CPU over 2 gloo ranks (tests/torch_sharding_workers.py), at the size
of tests/test_torch_sharding_phases.py (F = 4, 16x16 latents, fp32, 3
timesteps, 3 inner Adam steps):

- ``null_optimization`` at fp = 2 along JAX's trajectory against JAX's
  ``_jit_null_optimization`` and the port's unsharded optimization, and
  ``null_text_inversion`` against JAX's inversion + optimization: the
  embeddings at atol 1e-3, x_T at 1e-4 (as tests/test_torch_null_text.py,
  which gives the reason for 1e-3);
- the early stop is set where the unsharded run stops early at one
  timestep and not at the others: every rank must take the inner steps the
  unsharded run takes (a rank that decided alone would hang the others),
  and every rank's embeddings must be the same bits.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
from torch_sharding_workers import spawn
from motioneditor_tpu.models.unet import init_unet
from motioneditor_tpu.pipelines.editor import _jit_ddim_invert, _jit_null_optimization
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule

from motioneditor_tpu_torch.models.from_jax import unet_state_dict
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from motioneditor_tpu_torch.parallel.mesh import FrameShardingCtx
from motioneditor_tpu_torch.pipelines import editor
from motioneditor_tpu_torch.schedulers import DiffusionSchedule
from torch_port_helpers import (
    JAX_TINY,
    TINY_KW,
    assert_close,
    normal,
    random_params,
    setup_torch,
    tensor,
)

TINY = UNetConfig(**TINY_KW)
F, HW, L = 4, 16, 7
NUM_STEPS = 3
# at this epsilon the unsharded run stops after 2 of 3 inner steps at the
# first timestep (pre-update losses 0.1748, 0.1648 against 0.17) and takes
# all 3 at the others (losses 0.39-0.41 against 0.17002 and 0.17004)
OPT = dict(num_steps=NUM_STEPS, inner_steps=3, base_lr=1e-2, guidance_scale=7.5,
           early_stop_epsilon=0.17)


@pytest.fixture(scope="module")
def weights():
    """The weights of torch_port_helpers.tiny_unet(seed=1), as a JAX tree."""
    setup_torch()
    return random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=1)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(9)
    return dict(lat=normal(rng, (1, F, HW, HW, 4), 0.3), cond=normal(rng, (1, L, 16), 0.3),
                uncond0=normal(rng, (1, L, 16), 0.3))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def jax_inversion(weights, inputs):
    """JAX's unsharded inversion with video attention (null-text's first
    pass): x_T and the trajectory."""
    schedule = JaxSchedule()
    x_t, all_lat = _jit_ddim_invert(JAX_TINY, schedule, NUM_STEPS, False, True)(
        _to_jax(weights), jnp.asarray(inputs["lat"]), jnp.asarray(inputs["cond"]),
        jnp.asarray(schedule.inference_timesteps(NUM_STEPS)))
    return np.asarray(x_t), np.asarray(all_lat)


@pytest.fixture(scope="module")
def port_unet(weights):
    unet = UNet3DConditionModel(TINY).eval()
    unet.load_state_dict(unet_state_dict(weights))
    return unet


# ---------------------------------------------------------------------------
# null-text optimization and null-text inversion at fp = 2
# ---------------------------------------------------------------------------


def _counted(fn):
    """``fn()`` and the timestep of every null-text objective call it made
    (one per inner Adam step)."""
    calls = []
    loss_fn = editor.null_text_loss

    def counting_loss(*args, **kwargs):
        calls.append(args[8])
        return loss_fn(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(editor, "null_text_loss", counting_loss)
        return fn(), calls


@pytest.fixture(scope="module")
def null_runs(weights, inputs, jax_inversion, tmp_path_factory):
    """Both ranks' results, and JAX's optimization along its video-attention
    trajectory."""
    tmp = tmp_path_factory.mktemp("null_text")
    all_lat = jax_inversion[1]
    spawn(workers.null_text, (1, 2), tmp,
          dict(config=TINY_KW, unet=unet_state_dict(weights), lat=tensor(inputs["lat"]),
               all_lat=tensor(all_lat), cond=tensor(inputs["cond"]),
               uncond0=tensor(inputs["uncond0"]), opt=OPT))
    schedule = JaxSchedule()
    opt = _jit_null_optimization(JAX_TINY, schedule, NUM_STEPS, OPT["inner_steps"],
                                 OPT["base_lr"], OPT["guidance_scale"], True, "float32", None,
                                 OPT["early_stop_epsilon"])
    jax_uncond = opt(_to_jax(weights), jnp.asarray(all_lat), jnp.asarray(inputs["cond"]),
                     jnp.asarray(inputs["uncond0"]),
                     jnp.asarray(schedule.inference_timesteps(NUM_STEPS)))
    return [torch.load(tmp / f"rank{r}.pt") for r in range(2)], np.asarray(jax_uncond)


@pytest.fixture(scope="module")
def unsharded_null(port_unet, inputs, jax_inversion):
    """The port's unsharded optimization along JAX's trajectory, with the
    timestep of each objective call."""
    return _counted(lambda: editor.null_optimization(
        port_unet, TINY, DiffusionSchedule(), tensor(jax_inversion[1]),
        tensor(inputs["cond"]), tensor(inputs["uncond0"]), NUM_STEPS, OPT["inner_steps"],
        OPT["base_lr"], OPT["guidance_scale"], early_stop_epsilon=OPT["early_stop_epsilon"]))


def test_sharded_null_optimization_matches_jax_and_unsharded(null_runs, unsharded_null, inputs):
    ranks, jax_uncond = null_runs
    uncond = ranks[0]["uncond"]
    assert uncond.shape == (NUM_STEPS, 1, L, 16) and uncond.dtype == torch.float32
    assert not np.allclose(jax_uncond[0], inputs["uncond0"], atol=1e-3)  # it moved
    assert_close(uncond, jax_uncond, atol=1e-3)
    np.testing.assert_allclose(uncond.numpy(), unsharded_null[0].numpy(), atol=1e-3)


def test_sharded_null_text_takes_the_unsharded_inner_steps(null_runs, unsharded_null):
    """The early stop reads the world's loss: every rank takes the inner
    steps of the unsharded run, which stops early at some timesteps and
    not at others."""
    ranks, _ = null_runs
    calls = unsharded_null[1]
    steps = collections.Counter(calls)
    assert len(steps) == NUM_STEPS
    assert min(steps.values()) < OPT["inner_steps"] == max(steps.values())
    for rank in ranks:
        assert rank["calls"] == calls
        assert rank["inversion_calls"] == calls


def test_sharded_null_text_embeddings_are_the_same_bits_on_every_rank(null_runs):
    ranks, _ = null_runs
    for key in ("uncond", "inversion_uncond"):
        assert torch.equal(ranks[0][key], ranks[1][key]), key


def test_sharded_null_text_inversion_matches_jax(null_runs, jax_inversion):
    """null_text_inversion over fp = 2 (both phases sharded) against JAX's
    inversion then optimization (MotionEditorPipeline.null_text_inversion's
    chain)."""
    ranks, jax_uncond = null_runs
    assert_close(ranks[0]["x_t"], jax_inversion[0], atol=1e-4)
    assert_close(ranks[0]["inversion_uncond"], jax_uncond, atol=1e-3)


def test_null_optimization_refuses_a_data_axis(port_unet, inputs):
    """The embedding is one for the clip: a (data 2, frames 1) layout is
    refused before any collective."""
    ctx = FrameShardingCtx(None, (0,), None, (0, 1), torch.device("cpu"))
    with pytest.raises(ValueError, match="data"):
        editor.null_optimization(
            port_unet, TINY, DiffusionSchedule(), torch.zeros((2, 1, F, HW, HW, 4)),
            tensor(inputs["cond"]), tensor(inputs["uncond0"]), 1, 1, 1e-2, 7.5, shard_ctx=ctx)
