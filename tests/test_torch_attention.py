"""The port's attention functions (ops/attention.py) against the JAX
package, fp32 on the CPU. At n >= 1024 the spatial call sites route to
the kernels' wrappers, which on CPU tensors take their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.ops import attention as JA

from motioneditor_tpu_torch.models.from_jax import module_state_dict
from motioneditor_tpu_torch.ops import attention as TA

from torch_port_helpers import assert_close, normal, random_params, setup_torch, to_jax

MODES = ["normal", "sparse_causal", "motion_frame", "dense"]


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _attention(c, heads, cross_dim=None, seed=0):
    tree = random_params(lambda: JA.init_attention(jax.random.PRNGKey(0), c,
                                                   cross_dim=cross_dim, heads=heads),
                         seed=seed)
    module = TA.Attention(c, cross_dim=cross_dim, heads=heads)
    module.load_state_dict(module_state_dict("attention", tree))
    return tree, module


@pytest.mark.parametrize("mode", MODES)
def test_select_kv(mode):
    x = normal(np.random.default_rng(0), (2, 4, 5, 8))
    out = TA.select_kv(torch.from_numpy(x), mode)
    assert_close(out, JA.select_kv(jnp.asarray(x), mode), atol=0)


def test_sdpa_with_bias_and_heads_roundtrip():
    rng = np.random.default_rng(1)
    q, k, v = (normal(rng, (2, 3, 4, 6, 8)) for _ in range(3))
    bias = JA.causal_temporal_bias(6)
    out = TA.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), 0.3,
                  bias=TA.causal_temporal_bias(6))
    assert_close(out, JA.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3,
                              bias=bias, use_flash=False), atol=1e-6)
    x = torch.from_numpy(normal(rng, (2, 3, 6, 32)))
    assert torch.equal(TA.merge_heads(TA.split_heads(x, 4)), x)


@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("mode", MODES)
def test_spatial_self_attention(mode, n):
    """Both sides of the _FLASH_MIN_Q gate: n = 64 runs the select_kv path,
    n = 1024 the kernel call site."""
    tree, module = _attention(32, 4, seed=2)
    x = normal(np.random.default_rng(2), (2, 3, n, 32))
    with torch.no_grad():
        out = TA.spatial_self_attention(module, torch.from_numpy(x), mode, 4)
    ref = JA.spatial_self_attention(to_jax(tree), jnp.asarray(x), mode, 4, use_flash=False)
    assert_close(out, ref, atol=2e-5)


def test_cross_attention():
    tree, module = _attention(32, 4, cross_dim=16, seed=3)
    rng = np.random.default_rng(3)
    x, enc = normal(rng, (2, 3, 20, 32)), normal(rng, (2, 7, 16))
    with torch.no_grad():
        out = TA.cross_attention(module, torch.from_numpy(x), torch.from_numpy(enc), 4)
    ref = JA.cross_attention(to_jax(tree), jnp.asarray(x), jnp.asarray(enc), 4)
    assert_close(out, ref, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_temporal_self_attention(causal):
    """[B, N, F, C] form with the -1e4 causal bias and a K/V override."""
    tree, module = _attention(32, 4, seed=4)
    rng = np.random.default_rng(4)
    x, kv = normal(rng, (2, 10, 5, 32)), normal(rng, (2, 10, 5, 32))
    with torch.no_grad():
        out = TA.temporal_self_attention(module, torch.from_numpy(x), 4, causal=causal,
                                         kv_override=torch.from_numpy(kv))
    ref = JA.temporal_self_attention(to_jax(tree), jnp.asarray(x), 4, causal=causal,
                                     kv_override=jnp.asarray(kv))
    assert_close(out, ref, atol=1e-5)
