"""The port's split-head flash attention (ops/flash_attention.py, K8)
against the JAX Pallas kernel, which runs in interpret mode on the CPU as
tests/test_flash_attention.py runs it, and its jax.grad.

On CPU tensors the wrapper takes its plain PyTorch version, the function the
CUDA kernel is held to on the card (chip_smoke.py,
tests/test_torch_kernels_cuda.py). fp32 atol 2e-5 as in
tests/test_flash_attention.py; bf16 atol 2e-2 as its bf16 case (inputs whose
logits stay far below the JAX bf16 clamp of 60); gradients of sum(out**2)
atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.ops.flash_attention import flash_attention as jax_flash_attention

from motioneditor_tpu_torch.ops.attention import merge_heads, sdpa, split_heads
from motioneditor_tpu_torch.ops.flash_attention import (
    _rows,
    _strides,
    flash_attention,
    flash_attention_plain,
)

from torch_port_helpers import assert_close, normal, setup_torch


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


CASES = [  # (q lead, kv lead, heads, nq, nk, d)
    ((2, 3), (2, 3), 2, 128, 256, 40),
    ((2,), (2,), 4, 200, 300, 9),      # ragged lengths, a head dim the packed kernels decline
    ((2, 3), (2, 1), 2, 130, 77, 16),  # K/V broadcast over frames
]


@pytest.mark.parametrize("lead,kv_lead,h,nq,nk,d", CASES)
def test_flash_attention_matches_jax(lead, kv_lead, h, nq, nk, d):
    rng = np.random.default_rng(0)
    q = normal(rng, (*lead, h, nq, d))
    k, v = (normal(rng, (*kv_lead, h, nk, d)) for _ in range(2))
    scale = d ** -0.5
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    out = flash_attention(*args, scale)
    assert out.shape == q.shape
    assert_close(out, ref, atol=2e-5)
    assert_close(flash_attention_plain(*args, scale), ref, atol=2e-5)


def test_flash_attention_bf16_matches_jax():
    rng = np.random.default_rng(1)
    q, k, v = (normal(rng, (1, 2, 256, 64)) for _ in range(3))
    scale = 0.125
    ref = jax_flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale)
    out = flash_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), scale)
    assert out.dtype == torch.bfloat16
    assert_close(out, ref, atol=2e-2)


def test_flash_attention_gradients_match_jax():
    rng = np.random.default_rng(2)
    q = normal(rng, (2, 2, 2, 100, 24))
    k, v = (normal(rng, (2, 2, 2, 150, 24)) for _ in range(2))
    scale = 24 ** -0.5

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, scale) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*xs, scale).pow(2).sum(), xs)
    for g, r in zip(got, ref):
        assert_close(g, r, atol=1e-4)


def test_kernel_addressing_reads_split_views_in_place():
    """The strides the wrapper hands the kernel address the same elements as
    the [G, H, N, D] operand, a head-split view reads its packed tensor in
    place, and the packed output buffer seen through its strides is the
    [..., H, N, D] result (what csrc/split_attention.cu indexes)."""
    x = torch.arange(2 * 3 * 10 * 12, dtype=torch.float32).reshape(2, 3, 10, 12)
    q = split_heads(x, 4)  # [2, 3, 4, 10, 3], a view of x
    q4 = _rows(q)
    assert q4.data_ptr() == x.data_ptr() and q4.shape == (6, 4, 10, 3)
    strides = list(_strides(q4, q4, q4, q4, q4, q4))
    seen = torch.as_strided(x, q4.shape, (*strides[:3], 1), q4.storage_offset())
    assert torch.equal(seen, q.reshape(6, 4, 10, 3))
    out = torch.arange(2 * 3 * 10 * 4 * 3, dtype=torch.float32).reshape(2, 3, 10, 4, 3)
    out4 = out.view(-1, 10, 4, 3).transpose(1, 2)
    assert torch.equal(merge_heads(out.movedim(-2, -3)), out.reshape(2, 3, 10, 12))
    out4.copy_(q4)
    assert torch.equal(out.movedim(-2, -3), q)
    kb = _rows(torch.zeros(2, 1, 4, 5, 3).expand(2, 3, 4, 5, 3))
    assert kb.shape == (6, 4, 5, 3) and kb.stride(-1) == 1


def test_sdpa_routes_to_flash_only_when_asked():
    """sdpa(use_flash=True) takes the flash path at q.shape[-2] >= 1024 with
    no bias; the result equals the plain form either way on the CPU."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(normal(rng, (1, 2, 1024, 8))) for _ in range(3))
    plain = sdpa(q, k, v, 0.3)
    torch.testing.assert_close(sdpa(q, k, v, 0.3, use_flash=True), plain, atol=1e-6, rtol=0)
    bias = torch.zeros(1024, 1024)
    torch.testing.assert_close(sdpa(q, k, v, 0.3, bias=bias, use_flash=True), plain,
                               atol=1e-6, rtol=0)
