"""The port's temporal attention (ops/temporal_flash.py, ops/attention.py)
against the JAX Pallas kernel in interpret mode and the JAX plain path.

fp32, atol 2e-5: the kernel tolerance of tests/test_video_flash.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.ops.attention import init_attention
from motioneditor_tpu.ops.attention import (
    temporal_self_attention_video as jax_temporal_self_attention_video,
)
from motioneditor_tpu.ops.temporal_flash import (
    temporal_flash_attention as jax_temporal_flash_attention,
)

from motioneditor_tpu_torch.control.injection import injected_temporal_kv
from motioneditor_tpu_torch.models.from_jax import module_state_dict
from motioneditor_tpu_torch.ops.attention import Attention, temporal_self_attention_video
from motioneditor_tpu_torch.ops.temporal_flash import (
    temporal_flash_attention,
    temporal_flash_supported,
)

from torch_port_helpers import assert_close, normal, random_params, setup_torch, to_jax


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


@pytest.mark.parametrize("n,c,heads", [(256, 32, 4), (256, 320, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_temporal_flash_matches_jax(causal, n, c, heads):
    rng = np.random.default_rng(0)
    q, k, v = (normal(rng, (2, 5, n, c)) for _ in range(3))
    scale = (c // heads) ** -0.5
    ref = jax_temporal_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       scale, heads, causal=causal)
    out = temporal_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), scale, heads, causal=causal)
    assert_close(out, ref, atol=2e-5)


@pytest.mark.parametrize("override", [False, True])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_temporal_attention_video_matches_jax(use_kernel, override):
    """The attention module at the kernel's call site (n >= 512) and on the
    plain -1e4-bias path, with and without the injected K/V override."""
    n, c, heads = 512, 64, 8
    tree = random_params(lambda: init_attention(jax.random.PRNGKey(0), c, heads=heads), seed=3)
    module = Attention(c, heads=heads)
    module.load_state_dict(module_state_dict("attention", tree))
    rng = np.random.default_rng(4)
    x = normal(rng, (4, 3, n, c))
    kv = x[[0, 0, 2, 2]] if override else None
    ref = jax_temporal_self_attention_video(
        to_jax(tree), jnp.asarray(x), heads, causal=True,
        kv_override=None if kv is None else jnp.asarray(kv), use_kernel=use_kernel)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = temporal_self_attention_video(
            module, xt, heads, causal=True,
            kv_override=injected_temporal_kv(xt) if override else None,
            use_kernel=use_kernel)
    assert_close(out, ref, atol=2e-5)


def test_supported_gate():
    assert temporal_flash_supported(8, 320, 8)
    assert temporal_flash_supported(24, 1280, 8)
    assert not temporal_flash_supported(33, 320, 8)  # F > 32
    assert not temporal_flash_supported(8, 100, 8)  # c % heads
