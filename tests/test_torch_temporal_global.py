"""The port's frame-sharded temporal attention (K14,
``temporal_flash_attention_global``, ops/temporal_flash.py) against JAX's
``temporal_flash_attention_global``, whose Pallas kernel runs in interpret
mode on the CPU: Fq = 2 local query frames of an 8-frame clip at global
offsets 0, 2, 4 and 6 over all Fk = 8 frames, causal and not, at
[2, *, 128, 64], 8 heads.

On CPU tensors the port's wrapper takes its plain PyTorch version, the
function the CUDA kernel is held to on the card. Forward fp32 atol 2e-5, as
tests/test_temporal_flash.py; gradients (the plain version's VJP against
``jax.grad`` through JAX's oracle VJP) atol 1e-4, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.ops.temporal_flash import (
    temporal_flash_attention_global as jax_temporal_global,
)

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops.temporal_flash import (
    temporal_flash_attention,
    temporal_flash_attention_global,
)

from torch_port_helpers import assert_close, normal, setup_torch

B, FQ, FK, N, C, HEADS = 2, 2, 8, 128, 64, 8
SCALE = (C // HEADS) ** -0.5


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (normal(rng, (B, FQ, N, C)), normal(rng, (B, FK, N, C)), normal(rng, (B, FK, N, C)),
            normal(rng, (B, FQ, N, C)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("offset", [0, 2, 4, 6])
def test_temporal_global_matches_jax(causal, offset):
    q, k, v, _ = _inputs(offset)
    ref = jax_temporal_global(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE, HEADS,
                              causal, jnp.asarray(offset))
    out = temporal_flash_attention_global(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), SCALE, HEADS, causal, offset)
    assert out.shape == q.shape
    assert_close(out, ref, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_temporal_global_vjp_matches_jax(causal):
    q, k, v, w = _inputs(10)
    offset = 4
    jax_grads = jax.grad(
        lambda q, k, v: jnp.sum(jax_temporal_global(q, k, v, SCALE, HEADS, causal,
                                                    jnp.asarray(offset)) * w),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = temporal_flash_attention_global(*xs, SCALE, HEADS, causal, offset)
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((x.grad for x in xs), jax_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_shards_together_equal_the_unsharded_attention():
    """The four 2-frame shards of an 8-frame clip, each at its offset, give
    the unsharded causal temporal attention (K3's plain version)."""
    rng = np.random.default_rng(20)
    q, k, v = (torch.from_numpy(normal(rng, (B, FK, N, C))) for _ in range(3))
    _build.reset_launch_counts()  # another file's launches in this process do not count
    whole = temporal_flash_attention(q, k, v, SCALE, HEADS, causal=True)
    parts = [temporal_flash_attention_global(q[:, o:o + FQ], k, v, SCALE, HEADS, True, o)
             for o in range(0, FK, FQ)]
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, atol=1e-6, rtol=1e-6)
    assert not _build.launch_counts["temporal_flash_attention_global"]
