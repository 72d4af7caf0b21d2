"""The port's frame-sharded execution on the CPU: 2 and 4 ranks over gloo,
each a process started by ``torch.multiprocessing.spawn``
(tests/torch_sharding_workers.py), on a free localhost port.

- each collective (halo, frame-0 broadcast, all-gather, the temporal conv's
  two-sided halo, the frame-pooled GroupNorm with and without the pair-stats
  Function) and each sharded attention site (spatial sparse_causal /
  motion_frame / dense, temporal, mask injection; at N = 1024, where the
  kernels' sharded route runs their plain versions, and below the gate):
  forward and gradient against one process computing the same function;
- the frame-sharded tiny UNet forward at fp = 2 and 4 against JAX's
  unsharded ``unet_apply`` (atol 5e-4, as tests/sharding_runner.py:64);
- the denoise segment and the stage-1 step: tests/test_torch_sharding_pipeline.py.

The collectives' tolerances: fp32 sums in another order, 1e-5 of the
values' or gradients' magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharding_workers as workers
from torch_sharding_workers import spawn
from motioneditor_tpu.models.unet import UNetConfig as JaxUNetConfig
from motioneditor_tpu.models.unet import init_unet, unet_apply as jax_unet_apply

from motioneditor_tpu_torch.models.from_jax import unet_state_dict
from torch_port_helpers import TINY_KW, normal, random_params, setup_torch, tensor


# ---------------------------------------------------------------------------
# collectives and sharded attention sites
# ---------------------------------------------------------------------------

COLLECTIVES = ["prev_frames", "first_frame", "all_frames", "temporal_conv", "group_norm",
               "group_norm_fused"]
SITES = [f"{site}_{n}" for n in ("1024", "6") for site in (
    "spatial_sparse_causal", "spatial_motion_frame", "spatial_dense", "temporal", "injection")]


@pytest.fixture(scope="module", params=[2, 4], ids=["fp2", "fp4"])
def collective_results(request, tmp_path_factory):
    setup_torch()
    rng = np.random.default_rng(11)
    t = lambda *shape: torch.from_numpy(normal(rng, shape))  # noqa: E731
    inputs = dict(
        x=t(2, 8, 6, 16), w=t(2, 8, 6, 16), x4=t(4, 8, 6, 16), w4=t(4, 8, 6, 16),
        video=t(2, 8, 3, 3, 16), wv=t(2, 8, 3, 3, 16),
        tok=t(1, 4, 1024, 16), wt=t(1, 4, 1024, 16),
        tok4=t(4, 4, 1024, 16), wt4=t(4, 4, 1024, 16),
        mask6=torch.from_numpy((rng.random((8, 6, 1)) > 0.5).astype(np.float32)),
        mask1024=torch.from_numpy((rng.random((4, 1024, 1)) > 0.5).astype(np.float32)),
    )
    tmp = tmp_path_factory.mktemp(f"collectives{request.param}")
    spawn(workers.collectives, (1, request.param), tmp, inputs)
    return torch.load(tmp / "results.pt")


@pytest.mark.parametrize("name", COLLECTIVES + SITES)
def test_collective_matches_one_process(collective_results, name):
    fwd, bwd = collective_results[name]
    assert fwd < 1e-5 and bwd < 1e-5, (name, fwd, bwd)


# ---------------------------------------------------------------------------
# the UNet forward against JAX
# ---------------------------------------------------------------------------

ST_KW = dict(TINY_KW, use_st_attn=True, st_attn_idx=0)  # down block 0's first attn1 is dense


@pytest.fixture(scope="module")
def unet_case():
    """The tiny UNet (dense attention in one block) at 4 frames of 32x32
    latents, where level-0 attention (N = 1024) reaches the kernels' sharded
    route, and JAX's unsharded forward."""
    setup_torch()
    config = JaxUNetConfig(**ST_KW)
    tree = random_params(lambda: init_unet(jax.random.PRNGKey(0), config), seed=31)
    rng = np.random.default_rng(32)
    x, enc = normal(rng, (1, 4, 32, 32, 4)), normal(rng, (1, 7, 16))
    ref = jax.jit(lambda p, x, enc: jax_unet_apply(p, config, x, jnp.asarray(100), enc,
                                                   use_flash=False))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), jnp.asarray(enc))
    inputs = dict(config=ST_KW, unet=unet_state_dict(tree), x=tensor(x), enc=tensor(enc), t=100)
    return inputs, np.asarray(ref)


@pytest.mark.parametrize("fp", [2, 4])
def test_sharded_unet_forward_matches_jax(unet_case, tmp_path, fp):
    inputs, ref = unet_case
    spawn(workers.unet_forward, (1, fp), tmp_path, inputs)
    out = torch.load(tmp_path / "out.pt")
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4)


# ---------------------------------------------------------------------------
# no silent switch of device or backend
# ---------------------------------------------------------------------------


def test_cuda_sharding_needs_a_cuda_device():
    from motioneditor_tpu_torch.parallel.mesh import backend_for

    assert backend_for(torch.device("cpu")) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            backend_for(torch.device("cuda"))
