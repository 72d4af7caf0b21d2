"""The port's explicit-K/V attention (K12) and injection attention (K13) of
the frame-sharded path (ops/video_flash.py) against the JAX Pallas kernels
``video_flash_attention_kv`` / ``video_injection_attention_kv``, which run
in interpret mode on the CPU, at [2, 3, 128, 64], 8 heads.

On CPU tensors the port's wrappers take their plain PyTorch versions, the
functions the CUDA kernels are held to on the card (chip_smoke.py,
tests/test_torch_kernels_cuda.py). Forward fp32 atol 2e-5, as
tests/test_video_flash.py; gradients (the plain versions' VJP against
``jax.grad`` through JAX's oracle VJP) atol 1e-4, rtol 1e-4, inside the
gradient tolerance of tests/test_video_flash_bwd.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.ops.video_flash import (
    video_flash_attention_kv as jax_video_flash_attention_kv,
    video_injection_attention_kv as jax_video_injection_attention_kv,
)

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops.video_flash import (
    video_flash_attention_kv,
    video_flash_attention_kv_plain,
    video_flash_kv_supported,
    video_injection_attention_kv,
)

from torch_port_helpers import assert_close, normal, setup_torch

B, F, N, C, HEADS = 2, 3, 128, 64, 8
SCALE = (C // HEADS) ** -0.5
# (Fk, M): per-frame K/V over 2N tokens (the halo-built modes), one shared
# K/V over all F*N tokens (dense)
KV_CASES = {"per_frame": (F, 2 * N), "shared": (1, F * N)}


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _kv_inputs(seed, fk, m):
    rng = np.random.default_rng(seed)
    return (normal(rng, (B, F, N, C)), normal(rng, (B, fk, m, C)), normal(rng, (B, fk, m, C)),
            normal(rng, (B, F, N, C)))


def _injection_inputs(seed):
    rng = np.random.default_rng(seed)
    q, kt, vt, w = (normal(rng, (B, F, N, C)) for _ in range(4))
    ks, vs = normal(rng, (B, F, 2 * N, C)), normal(rng, (B, F, 2 * N, C))
    mask = (rng.random((F, 2 * N)) > 0.5).astype(np.float32)
    return (q, ks, vs, kt, vt, mask), w


@pytest.mark.parametrize("case", KV_CASES)
def test_video_flash_kv_matches_jax(case):
    q, k, v, _ = _kv_inputs(0, *KV_CASES[case])
    ref = jax_video_flash_attention_kv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE,
                                       HEADS)
    out = video_flash_attention_kv(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), SCALE, HEADS)
    assert out.shape == q.shape
    assert_close(out, ref, atol=2e-5)


def test_video_injection_kv_matches_jax():
    args, _ = _injection_inputs(1)
    ref = jax_video_injection_attention_kv(*(jnp.asarray(a) for a in args), SCALE, HEADS)
    out = video_injection_attention_kv(*(torch.from_numpy(a) for a in args), SCALE, HEADS)
    assert out.shape == args[0].shape
    assert_close(out, ref, atol=2e-5)


def _grads_close(port_grads, jax_grads):
    for got, want in zip(port_grads, jax_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", KV_CASES)
def test_video_flash_kv_vjp_matches_jax(case):
    q, k, v, w = _kv_inputs(2, *KV_CASES[case])
    jax_grads = jax.grad(
        lambda q, k, v: jnp.sum(jax_video_flash_attention_kv(q, k, v, SCALE, HEADS) * w),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (video_flash_attention_kv(*xs, SCALE, HEADS) * torch.from_numpy(w)).sum().backward()
    _grads_close([x.grad for x in xs], jax_grads)


def test_video_injection_kv_vjp_matches_jax():
    args, w = _injection_inputs(3)
    jax_grads = jax.grad(
        lambda *a: jnp.sum(jax_video_injection_attention_kv(*a, args[5], SCALE, HEADS) * w),
        argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in args[:5]))
    xs = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
    out = video_injection_attention_kv(*xs, torch.from_numpy(args[5]), SCALE, HEADS)
    (out * torch.from_numpy(w)).sum().backward()
    _grads_close([x.grad for x in xs], jax_grads)


def test_kv_plain_reads_the_clamped_frame():
    """Fk = 1: every query frame reads K/V frame 0 (JAX's min(f, Fk - 1))."""
    q, k, v, _ = (torch.from_numpy(a) for a in _kv_inputs(4, 1, N))
    out = video_flash_attention_kv_plain(q, k, v, SCALE, HEADS)
    again = video_flash_attention_kv_plain(q, k.expand(B, F, N, C), v.expand(B, F, N, C),
                                           SCALE, HEADS)
    torch.testing.assert_close(out, again, atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_versions():
    _build.reset_launch_counts()
    q, k, v, _ = (torch.from_numpy(a) for a in _kv_inputs(5, F, 2 * N))
    video_flash_attention_kv(q, k, v, SCALE, HEADS)
    args, _ = _injection_inputs(6)
    video_injection_attention_kv(*(torch.from_numpy(a) for a in args), SCALE, HEADS)
    assert not _build.launch_counts
    assert _build.kernels.cache_info().currsize == 0
    assert video_flash_kv_supported(320, 8) and not video_flash_kv_supported(36, 4)
