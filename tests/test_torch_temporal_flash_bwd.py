"""Gradients of the port's temporal attention (ops/temporal_flash.py)
against the JAX package.

The JAX side is ``jax.grad`` of its ``temporal_flash_attention``, whose
custom VJP reaches the fused Pallas backward ``_temporal_4d_bwd`` in
interpret mode. The port's side is the plain version under autograd and
``TemporalFlashAttentionFn``, the autograd Function the CUDA path takes,
which on CPU tensors runs the plain forward and the plain backward (the
function kernel K7 is held to on the card). fp32, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.ops.temporal_flash import (
    temporal_flash_attention as jax_temporal_flash_attention,
)

from motioneditor_tpu_torch.ops.temporal_flash import (
    TemporalFlashAttentionFn,
    temporal_flash_attention,
    temporal_flash_attention_bwd_plain,
    temporal_flash_attention_plain,
)

from torch_port_helpers import assert_close, normal, setup_torch

SHAPE, HEADS = (1, 3, 64, 32), 4
SCALE = (SHAPE[3] // HEADS) ** -0.5


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _inputs(seed, count=3):
    rng = np.random.default_rng(seed)
    return [normal(rng, SHAPE) for _ in range(count)]


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    arrays = _inputs(0)

    def jax_loss(q, k, v):
        return jnp.sum(jax_temporal_flash_attention(q, k, v, SCALE, HEADS, causal=causal) ** 2)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    for fn in (temporal_flash_attention, TemporalFlashAttentionFn.apply):
        xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
        out = fn(*xs, SCALE, HEADS, causal)
        got = torch.autograd.grad(out.pow(2).sum(), xs)
        for a, b in zip(got, ref):
            assert_close(a, b, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_autograd(causal):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, count=4))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(temporal_flash_attention_plain(*xs, SCALE, HEADS, causal), xs, do)
    got = temporal_flash_attention_bwd_plain(q, k, v, do, SCALE, HEADS, causal)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_function_skips_inputs_without_grad():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2))
    k.requires_grad_()
    TemporalFlashAttentionFn.apply(q, k, v, SCALE, HEADS, True).sum().backward()
    assert q.grad is None and v.grad is None
    assert k.grad is not None and k.grad.shape == k.shape
