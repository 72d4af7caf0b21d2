"""The port's DDIM inversion and the null-text objective (pipelines/
editor.py) against the JAX package, on the same converted weights and
seeded inputs, at the tiny size of tests/test_torch_slice.py (F = 3,
16x16 latents, fp32, CPU).

At 16x16 latents no attention site reaches the kernels' size gates, so
both packages take their plain paths; the attention gradients are held to
the JAX Pallas backward kernels in tests/test_torch_video_flash_bwd.py and
tests/test_torch_temporal_flash_bwd.py.

Tolerances: the inversion trajectory at 1e-4 (three UNet forwards, each
agreeing to ~1e-5); one null-text inner step's loss and gradient at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.models.unet import unet_apply as jax_unet_apply
from motioneditor_tpu.pipelines.editor import _jit_ddim_invert
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule
from motioneditor_tpu.schedulers import ddim_step as jax_ddim_step

from motioneditor_tpu_torch.models.unet import UNetConfig, unet_apply
from motioneditor_tpu_torch.pipelines import editor
from motioneditor_tpu_torch.pipelines.editor import ddim_invert, null_optimization, null_text_loss
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
NUM_STEPS, GUIDANCE = 3, 7.5


@pytest.fixture(scope="module")
def weights():
    setup_torch()
    return tiny_unet()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    return dict(lat=normal(rng, (1, F, HW, HW, 4), 0.3), cond=normal(rng, (1, L, 16), 0.3),
                uncond0=normal(rng, (1, L, 16), 0.3))


def _jax_invert(params, inputs, normal_infer):
    schedule = JaxSchedule()
    _, all_lat = _jit_ddim_invert(JAX_TINY, schedule, NUM_STEPS, normal_infer, True)(
        params, jnp.asarray(inputs["lat"]), jnp.asarray(inputs["cond"]),
        jnp.asarray(schedule.inference_timesteps(NUM_STEPS)))
    return np.asarray(all_lat)


@pytest.fixture(scope="module")
def jax_trajectory(weights, inputs):
    """JAX's inversion with video attention (null-text's first pass)."""
    return _jax_invert(weights[0], inputs, False)


@pytest.mark.parametrize("normal_infer", [True, False])
def test_ddim_invert_matches_jax(weights, inputs, jax_trajectory, normal_infer):
    params, unet = weights
    ref = _jax_invert(params, inputs, True) if normal_infer else jax_trajectory
    x_t, all_lat = ddim_invert(unet, TINY, DiffusionSchedule(), tensor(inputs["lat"]),
                               tensor(inputs["cond"]), NUM_STEPS, normal_infer=normal_infer)
    assert all_lat.shape == (NUM_STEPS + 1, 1, F, HW, HW, 4)
    assert torch.equal(x_t, all_lat[-1]) and torch.equal(all_lat[0], tensor(inputs["lat"]))
    assert_close(all_lat, ref, atol=1e-4)


def test_null_text_inner_step_matches_jax(weights, inputs, jax_trajectory):
    """Loss and gradient of the first inner step of the first timestep,
    against jax.value_and_grad of the same objective (editor.py:373-378)."""
    params, unet = weights
    t = int(DiffusionSchedule().inference_timesteps(NUM_STEPS)[0])
    cur, prev = jax_trajectory[-1], jax_trajectory[NUM_STEPS - 1]
    cond, u0 = inputs["cond"], inputs["uncond0"]

    @jax.jit
    def jax_value_and_grad(params, cur, prev, cond, u):
        tj = jnp.asarray(t)
        eps_cond = jax_unet_apply(params, JAX_TINY, cur, tj, cond)

        def loss_fn(u):
            eps_u = jax_unet_apply(params, JAX_TINY, cur, tj, u)
            eps = eps_u + GUIDANCE * (eps_cond - eps_u)
            rec = jax_ddim_step(JaxSchedule(), eps, tj, cur, NUM_STEPS)
            return jnp.mean((rec - prev) ** 2)

        return jax.value_and_grad(loss_fn)(u)

    ref_loss, ref_grad = jax_value_and_grad(
        params, *(jnp.asarray(a) for a in (cur, prev, cond, u0)))
    with torch.no_grad():
        eps_cond = unet_apply(unet, TINY, tensor(cur), t, tensor(cond))
    u = tensor(u0).requires_grad_()
    loss = null_text_loss(unet, TINY, DiffusionSchedule(), NUM_STEPS, GUIDANCE, torch.float32,
                          tensor(cur), tensor(prev), t, eps_cond, u)
    (grad,) = torch.autograd.grad(loss, u)
    assert_close(loss, ref_loss, atol=1e-5)
    assert float(np.abs(np.asarray(ref_grad)).max()) > 1e-4  # the comparison is not vacuous
    assert_close(grad, ref_grad, atol=1e-5)


def test_null_text_early_stop(weights, inputs, jax_trajectory, monkeypatch):
    """The inner loop tests the pre-update loss of the previous inner step
    (+inf at first; editor.py:383-400): epsilon = 1e9 stops after exactly
    one update per timestep, identical to inner_steps = 1; epsilon = -1
    never stops. Counted at the objective's call site."""
    _, unet = weights
    calls = []
    loss_fn = editor.null_text_loss

    def counting_loss(*args, **kwargs):
        calls.append(1)
        return loss_fn(*args, **kwargs)

    monkeypatch.setattr(editor, "null_text_loss", counting_loss)
    args = (unet, TINY, DiffusionSchedule(), tensor(jax_trajectory[:3]), tensor(inputs["cond"]),
            tensor(inputs["uncond0"]), 2)
    one = null_optimization(*args, 1, 0.1, GUIDANCE, early_stop_epsilon=-1.0)
    assert len(calls) == 2
    stopped = null_optimization(*args, 5, 0.1, GUIDANCE, early_stop_epsilon=1e9)
    assert len(calls) == 2 + 2
    full = null_optimization(*args, 5, 0.1, GUIDANCE, early_stop_epsilon=-1.0)
    assert len(calls) == 4 + 2 * 5
    assert torch.equal(stopped, one)
    assert not torch.allclose(full, one, atol=1e-6)
