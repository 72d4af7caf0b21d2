"""The port's null-text optimization and null-text inversion (pipelines/
editor.py) against the JAX package (editor.py _jit_null_optimization and
the chain of MotionEditorPipeline.null_text_inversion), on the same
converted weights and seeded inputs, at the tiny size of
tests/test_torch_slice.py (F = 3, 16x16 latents, fp32, CPU); 3 timesteps,
2 inner Adam steps each.

Tolerances: x_T at 1e-4; the optimized uncond trajectory at 1e-3, because
Adam's first update is about lr * sign(g): an element whose gradient is
near 0 can move by up to 2 * lr = 2e-2 on a difference of 1e-7 in g, so a
tight tolerance would test rounding rather than the algorithm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.pipelines.editor import _jit_ddim_invert, _jit_null_optimization
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule

from motioneditor_tpu_torch.models.unet import UNetConfig
from motioneditor_tpu_torch.pipelines.editor import null_optimization, null_text_inversion
from motioneditor_tpu_torch.schedulers import DiffusionSchedule

from torch_port_helpers import (
    JAX_TINY,
    TINY_KW,
    assert_close,
    normal,
    setup_torch,
    tensor,
    tiny_unet,
)

TINY = UNetConfig(**TINY_KW)
F, HW, L = 3, 16, 7
NUM_STEPS, INNER, LR, GUIDANCE, EPS = 3, 2, 1e-2, 7.5, 1e-5


@pytest.fixture(scope="module")
def weights():
    setup_torch()
    return tiny_unet()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    return dict(lat=normal(rng, (1, F, HW, HW, 4), 0.3), cond=normal(rng, (1, L, 16), 0.3),
                uncond0=normal(rng, (1, L, 16), 0.3))


@pytest.fixture(scope="module")
def jax_ref(weights, inputs):
    """JAX's null-text inversion: inversion with video attention, then the
    null-text optimization along its trajectory."""
    params, _ = weights
    schedule = JaxSchedule()
    ts = jnp.asarray(schedule.inference_timesteps(NUM_STEPS))
    cond = jnp.asarray(inputs["cond"])
    x_t, all_lat = _jit_ddim_invert(JAX_TINY, schedule, NUM_STEPS, False, True)(
        params, jnp.asarray(inputs["lat"]), cond, ts)
    opt = _jit_null_optimization(JAX_TINY, schedule, NUM_STEPS, INNER, LR, GUIDANCE, True,
                                 "float32", None, EPS)
    uncond = opt(params, all_lat, cond, jnp.asarray(inputs["uncond0"]), ts)
    return dict(x_t=np.asarray(x_t), all_lat=np.asarray(all_lat), uncond=np.asarray(uncond))


def test_null_optimization_matches_jax(weights, inputs, jax_ref):
    _, unet = weights
    uncond = null_optimization(unet, TINY, DiffusionSchedule(), tensor(jax_ref["all_lat"]),
                               tensor(inputs["cond"]), tensor(inputs["uncond0"]), NUM_STEPS,
                               INNER, LR, GUIDANCE, early_stop_epsilon=EPS)
    assert uncond.shape == (NUM_STEPS, 1, L, 16) and uncond.dtype == torch.float32
    assert not np.allclose(jax_ref["uncond"][0], inputs["uncond0"], atol=1e-3)  # it moved
    assert_close(uncond, jax_ref["uncond"], atol=1e-3)


def test_null_text_inversion_matches_jax(weights, inputs, jax_ref):
    _, unet = weights
    x_t, uncond = null_text_inversion(unet, TINY, DiffusionSchedule(), tensor(inputs["lat"]),
                                      tensor(inputs["cond"]), tensor(inputs["uncond0"]),
                                      NUM_STEPS, INNER, LR, GUIDANCE, null_normal_infer=False,
                                      early_stop_epsilon=EPS)
    assert_close(x_t, jax_ref["x_t"], atol=1e-4)
    assert_close(uncond, jax_ref["uncond"], atol=1e-3)


def test_bf16_compute_keeps_fp32_masters(inputs):
    """compute_dtype="bfloat16": the UNet runs in bf16, while the embedding
    it optimizes stays fp32 and receives the gradient through the casts;
    a compute dtype that is not the UNet's raises."""
    _, unet = tiny_unet()
    rng = np.random.default_rng(8)
    traj = tensor(normal(rng, (3, 1, F, HW, HW, 4), 0.3))
    args = (DiffusionSchedule(), traj, tensor(inputs["cond"]), tensor(inputs["uncond0"]), 2, 1,
            LR, GUIDANCE)
    with pytest.raises(ValueError):
        null_optimization(unet, TINY, *args, compute_dtype="bfloat16")
    uncond = null_optimization(unet.bfloat16(), TINY, *args, compute_dtype="bfloat16")
    assert uncond.dtype == torch.float32 and torch.isfinite(uncond).all()
    # one Adam step moves an element with a nonzero gradient by about lr
    moved = (uncond[0] - tensor(inputs["uncond0"])).abs()
    assert float((moved > 0.5 * LR).float().mean()) > 0.9
