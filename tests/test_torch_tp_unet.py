"""The port of tests/sharding_runner.py's two tensor-parallel cases, on the
CPU over gloo ranks (tests/torch_tp_workers.py), against JAX's unsharded
``unet_apply`` at atol 5e-4 (sharding_runner.py:170 and :412):

- ``case_tensor_parallel``: the tiny UNet on a (1, 1, 2) layout, the
  Megatron column / row split of every attention, at 4 frames of 16x16
  latents;
- ``case_tp_flash``: its (1, 2, 2) config at 4 frames of 32x32 latents with
  ``use_flash`` on, so level-0 attention (N = 1024) takes the kernels'
  frame-sharded route at head-local widths (their plain versions on the
  CPU).

Each rank counts its model group's collectives: one all-reduce per split
attention module the forward calls (the UNet's 16 blocks x attn1, attn2 and
attn_temp; the adapter gets no residuals here), no all-gather; and the
blocks gather back to the whole weights.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_workers as tp_workers
import torch_sharding_workers as workers
from motioneditor_tpu.models.unet import UNetConfig as JaxUNetConfig
from motioneditor_tpu.models.unet import init_unet, unet_apply as jax_unet_apply

from motioneditor_tpu_torch.models.from_jax import unet_state_dict
from torch_port_helpers import TINY_KW, normal, random_params, setup_torch, tensor

# sharding_runner.py's TINY and case_tp_flash's cfg (no sparse-causal attn1)
RUNNER_KW = {k: v for k, v in TINY_KW.items() if k != "use_sc_attn"}
CASES = {
    "tensor_parallel": ((1, 1, 2), 16, False),  # layout, latent side, use_flash
    "tp_flash": ((1, 2, 2), 32, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tp_unet_forward_matches_jax(tmp_path, case):
    setup_torch()
    layout, hw, use_flash = CASES[case]
    config = JaxUNetConfig(**RUNNER_KW)
    tree = random_params(lambda: init_unet(jax.random.PRNGKey(0), config), seed=61)
    rng = np.random.default_rng(62)
    x, enc = normal(rng, (1, 4, hw, hw, 4)), normal(rng, (1, 7, 16))
    ref = jax.jit(lambda p, x, enc: jax_unet_apply(p, config, x, jnp.asarray(100), enc,
                                                   use_flash=False))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(enc))
    inputs = dict(config=RUNNER_KW, unet=unet_state_dict(tree), x=tensor(x), enc=tensor(enc),
                  t=100, use_flash=use_flash)
    workers.spawn(tp_workers.unet_forward, layout, tmp_path, inputs)
    out = torch.load(tmp_path / "out.pt")
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4)
    for rank in range(math.prod(layout)):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["gathered_equal"] and got["plan"] > 50
        assert got["sites_called"] == 48
        assert got["calls"] == {"all_reduce": 48, "all_gather": 0}
        assert got["counted"]["all_reduce"] == 48
