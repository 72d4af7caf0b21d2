"""The port's frame-sharded DDIM inversion on the CPU, ranks over gloo
started by ``torch.multiprocessing.spawn`` (tests/torch_sharding_workers.py),
at the tiny size of tests/test_torch_inversion.py but 4 frames (F = 4,
16x16 latents, fp32): ``ddim_invert`` at fp = 2 and 4, video attention on
and off, against JAX's unsharded ``_jit_ddim_invert`` and the port's
unsharded inversion, x_T and the trajectory at atol 1e-4 (as there).
Null-text: tests/test_torch_sharding_phases_null_text.py; the pipeline:
tests/test_torch_sharding_phases_pipeline.py; stage 2:
tests/test_torch_sharding_phases_train.py; the launches per step of the
sharded paths: tests/test_torch_sharding_phases_counts.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
from torch_sharding_workers import spawn
from motioneditor_tpu.models.unet import init_unet
from motioneditor_tpu.pipelines.editor import _jit_ddim_invert
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule

from motioneditor_tpu_torch.models.from_jax import unet_state_dict
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
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


@pytest.fixture(scope="module")
def weights():
    """The weights of torch_port_helpers.tiny_unet(seed=1), as a JAX tree."""
    setup_torch()
    return random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=1)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(9)
    return dict(lat=normal(rng, (1, F, HW, HW, 4), 0.3), cond=normal(rng, (1, L, 16), 0.3))


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def jax_inversions(weights, inputs):
    """JAX's unsharded inversions, video attention off (True) and on."""
    schedule = JaxSchedule()
    ts = jnp.asarray(schedule.inference_timesteps(NUM_STEPS))
    out = {}
    for normal_infer in (True, False):
        x_t, all_lat = _jit_ddim_invert(JAX_TINY, schedule, NUM_STEPS, normal_infer, True)(
            _to_jax(weights), jnp.asarray(inputs["lat"]), jnp.asarray(inputs["cond"]), ts)
        out[normal_infer] = (np.asarray(x_t), np.asarray(all_lat))
    return out


@pytest.fixture(scope="module")
def port_unet(weights):
    unet = UNet3DConditionModel(TINY).eval()
    unet.load_state_dict(unet_state_dict(weights))
    return unet


# ---------------------------------------------------------------------------
# DDIM inversion at fp = 2 and 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 4], ids=["fp2", "fp4"])
def sharded_inversions(request, weights, inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"inversion{request.param}")
    spawn(workers.inversion, (1, request.param), tmp,
          dict(config=TINY_KW, unet=unet_state_dict(weights), lat=tensor(inputs["lat"]),
               cond=tensor(inputs["cond"]), steps=NUM_STEPS))
    return torch.load(tmp / "out.pt")


@pytest.mark.parametrize("normal_infer", [True, False], ids=["normal", "video"])
def test_sharded_ddim_invert_matches_jax_and_unsharded(sharded_inversions, jax_inversions,
                                                       port_unet, inputs, normal_infer):
    x_t, all_lat = sharded_inversions[normal_infer]
    assert all_lat.shape == (NUM_STEPS + 1, 1, F, HW, HW, 4)
    assert torch.equal(x_t, all_lat[-1]) and torch.equal(all_lat[0], tensor(inputs["lat"]))
    ref_x, ref_all = jax_inversions[normal_infer]
    assert_close(x_t, ref_x, atol=1e-4)
    assert_close(all_lat, ref_all, atol=1e-4)
    _, port_all = editor.ddim_invert(port_unet, TINY, DiffusionSchedule(), tensor(inputs["lat"]),
                                     tensor(inputs["cond"]), NUM_STEPS, normal_infer=normal_infer)
    np.testing.assert_allclose(all_lat.numpy(), port_all.numpy(), atol=1e-4)
