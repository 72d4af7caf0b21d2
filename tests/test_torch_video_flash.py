"""The port's video attention and injection attention (ops/video_flash.py)
against the JAX Pallas kernels, which run in interpret mode on the CPU.

On CPU tensors the port's wrappers take their plain PyTorch versions, the
functions the CUDA kernels are held to on the card (chip_smoke.py,
tests/test_torch_kernels_cuda.py). fp32, atol 2e-5 as in
tests/test_video_flash.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.ops.video_flash import (
    video_flash_attention as jax_video_flash_attention,
    video_injection_attention as jax_video_injection_attention,
)

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops.video_flash import (
    video_flash_attention,
    video_flash_supported,
    video_injection_attention,
)

from torch_port_helpers import assert_close, normal, setup_torch

SHAPES = [(256, 32, 4), (256, 320, 8)]  # (n, c, heads): d = 8 and d = 40
B, F = 2, 3


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _qkv(rng, n, c, count=3):
    return [normal(rng, (B, F, n, c)) for _ in range(count)]


@pytest.mark.parametrize("n,c,heads", SHAPES)
@pytest.mark.parametrize("mode", ["normal", "sparse_causal", "motion_frame", "dense"])
def test_video_flash_matches_jax(mode, n, c, heads):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, n, c)
    scale = (c // heads) ** -0.5
    ref = jax_video_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mode,
                                    scale, heads)
    out = video_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), mode, scale, heads)
    assert out.shape == q.shape
    assert_close(out, ref, atol=2e-5)


@pytest.mark.parametrize("n,c,heads", SHAPES)
def test_video_injection_matches_jax(n, c, heads):
    rng = np.random.default_rng(1)
    q, ks, vs, kt, vt = _qkv(rng, n, c, count=5)
    mask = (rng.random((F, n)) > 0.5).astype(np.float32)
    scale = (c // heads) ** -0.5
    ref = jax_video_injection_attention(*(jnp.asarray(a) for a in (q, ks, vs, kt, vt, mask)),
                                        scale, heads)
    out = video_injection_attention(*(torch.from_numpy(a) for a in (q, ks, vs, kt, vt, mask)),
                                    scale, heads)
    assert_close(out, ref, atol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernel library or its launch count."""
    _build.reset_launch_counts()
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 64, 32))
    video_flash_attention(q, k, v, "motion_frame", 0.35, 4)
    assert _build.launch_counts["video_flash_attention"] == 0
    assert _build.kernels.cache_info().currsize == 0


def test_supported_gate():
    assert video_flash_supported(320, 8)  # d = 40
    assert video_flash_supported(640, 8)  # d = 80
    assert video_flash_supported(1280, 8)  # d = 160
    assert not video_flash_supported(320, 7)  # c % heads
    assert not video_flash_supported(96, 8)  # d = 12
    assert not video_flash_supported(1536, 8)  # d = 192 > 160
