"""The port's DDIM inversion step (schedulers.ddim_inverse_step) against the
JAX package's, on the same seeded inputs. atol 1e-6: both compute the
same fp32 formula from the same float64-derived tables.

t = 1 reaches final_alpha_cumprod (its "from" timestep is negative); t = 981
with 50 steps and t = 901 + ratio with 10 steps sit at the top of the
schedule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule
from motioneditor_tpu.schedulers import ddim_inverse_step as jax_ddim_inverse_step

from motioneditor_tpu_torch.schedulers import DiffusionSchedule, ddim_inverse_step

from torch_port_helpers import assert_close, normal


@pytest.mark.parametrize("num_steps", [50, 10])
@pytest.mark.parametrize("t", [1, 21, 501, 981])
def test_ddim_inverse_step_matches_jax(t, num_steps):
    rng = np.random.default_rng(t + num_steps)
    sample = normal(rng, (1, 3, 8, 8, 4))
    eps = normal(rng, (1, 3, 8, 8, 4))
    ref = jax_ddim_inverse_step(JaxSchedule(), jnp.asarray(eps), jnp.asarray(t),
                                jnp.asarray(sample), num_steps)
    out = ddim_inverse_step(DiffusionSchedule(), torch.from_numpy(eps), t,
                            torch.from_numpy(sample), num_steps)
    assert out.dtype == torch.float32
    assert_close(out, ref, atol=1e-6)


def test_ddim_inverse_step_keeps_bf16():
    rng = np.random.default_rng(0)
    sample = torch.from_numpy(normal(rng, (1, 2, 4, 4, 4))).bfloat16()
    eps = torch.from_numpy(normal(rng, (1, 2, 4, 4, 4))).bfloat16()
    out = ddim_inverse_step(DiffusionSchedule(), eps, 21, sample, 50)
    assert out.dtype == torch.bfloat16
    ref = ddim_inverse_step(DiffusionSchedule(), eps.float(), 21, sample.float(), 50)
    torch.testing.assert_close(out.float(), ref, atol=3e-2, rtol=1.6e-2)
