"""The port's split-head fg/bg injection attention (ops/injection_flash.py,
K9) against the JAX Pallas kernel in interpret mode on the CPU, and the
split-head branch of ``injected_spatial_attention`` (the branch that runs
K8 and K9, taken for head dims the packed kernels decline) against JAX's.

On CPU tensors the wrappers take their plain PyTorch versions. fp32, atol
2e-5 as in tests/test_injection_flash.py for the kernel; gradients atol
1e-4; the whole attention module atol 2e-5 as tests/test_torch_injection.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.control.injection import (
    injected_spatial_attention as jax_injected_spatial_attention,
)
from motioneditor_tpu.ops.attention import init_attention
from motioneditor_tpu.ops.injection_flash import (
    fused_injection_attention as jax_fused_injection_attention,
)

from motioneditor_tpu_torch.control.injection import injected_spatial_attention
from motioneditor_tpu_torch.models.from_jax import module_state_dict
from motioneditor_tpu_torch.ops.attention import Attention
from motioneditor_tpu_torch.ops.injection_flash import (
    fused_injection_attention,
    fused_injection_attention_plain,
)
from motioneditor_tpu_torch.ops.video_flash import video_flash_supported

from torch_port_helpers import assert_close, normal, random_params, setup_torch, to_jax


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _inputs(rng, b, f, h, nq, d, mask=None):
    ns, nt = 2 * nq, nq
    q = normal(rng, (b, f, h, nq, d))
    ks, vs = (normal(rng, (b, f, h, ns, d)) for _ in range(2))
    kt, vt = (normal(rng, (b, f, h, nt, d)) for _ in range(2))
    if mask is None:
        mask = (rng.random((f, ns)) > 0.5).astype(np.float32)
    return q, ks, vs, mask, kt, vt


@pytest.mark.parametrize("b,f,h,nq,d", [(2, 3, 2, 128, 16), (1, 2, 3, 64, 9)])
def test_fused_injection_matches_jax(b, f, h, nq, d):
    args = _inputs(np.random.default_rng(0), b, f, h, nq, d)
    scale = d ** -0.5
    ref = jax_fused_injection_attention(*(jnp.asarray(x) for x in args), scale)
    targs = [torch.from_numpy(x) for x in args]
    out = fused_injection_attention(*targs, scale)
    assert out.shape == args[0].shape
    assert_close(out, ref, atol=2e-5)
    assert_close(fused_injection_attention_plain(*targs, scale), ref, atol=2e-5)


def test_fused_injection_per_frame_masks():
    """Each frame reads its own mask row: all-fg in frame 0, all-bg in 1."""
    mask = np.stack([np.ones(256, np.float32), np.zeros(256, np.float32)])
    args = _inputs(np.random.default_rng(1), 1, 2, 1, 128, 8, mask=mask)
    ref = jax_fused_injection_attention(*(jnp.asarray(x) for x in args), 8 ** -0.5)
    assert_close(fused_injection_attention(*(torch.from_numpy(x) for x in args), 8 ** -0.5),
                 ref, atol=2e-5)


def test_fused_injection_gradients_match_jax():
    q, ks, vs, mask, kt, vt = _inputs(np.random.default_rng(2), 1, 2, 2, 64, 8)
    scale = 8 ** -0.5

    def loss(q, ks, vs, kt, vt):
        return jnp.sum(jax_fused_injection_attention(q, ks, vs, jnp.asarray(mask), kt, vt,
                                                     scale) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in (q, ks, vs, kt, vt)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, ks, vs, kt, vt)]
    out = fused_injection_attention(xs[0], xs[1], xs[2], torch.from_numpy(mask), xs[3], xs[4],
                                    scale)
    got = torch.autograd.grad(out.pow(2).sum(), xs)
    for g, r in zip(got, ref):
        assert_close(g, r, atol=1e-4)


@pytest.mark.parametrize("mask_fgbg", [True, False])
def test_split_head_branch_matches_jax(mask_fgbg):
    """C = 36 with 4 heads (d = 9): the packed kernels decline, so at
    N = 1024 the port's branch runs the K8 wrapper for the source rows and
    the K9 wrapper for the masked edit rows (their plain versions here),
    against JAX's split-head branch with its Pallas kernels interpreted."""
    c, heads, f, n = 36, 4, 2, 1024
    assert not video_flash_supported(c, heads)
    tree = random_params(lambda: init_attention(jax.random.PRNGKey(0), c, heads=heads), seed=3)
    module = Attention(c, heads=heads)
    module.load_state_dict(module_state_dict("attention", tree))
    rng = np.random.default_rng(4)
    x = normal(rng, (4, f, n, c), 0.5)
    mask = (rng.random((f, n, 1)) > 0.5).astype(np.float32)
    with torch.no_grad():
        out = injected_spatial_attention(module, torch.from_numpy(x), heads,
                                         torch.from_numpy(mask), mask_fgbg)
    ref = jax_injected_spatial_attention(to_jax(tree), jnp.asarray(x), heads, jnp.asarray(mask),
                                         mask_fgbg, use_flash=True)
    assert_close(out, ref, atol=2e-5)
