"""Gradients of the port's video attention (ops/video_flash.py,
ops/video_flash_bwd.py) against the JAX package.

On CPU tensors the port's wrappers take their plain versions: the forward
under autograd, and for ``VideoFlashAttentionFn`` the plain residual-saving
forward and the plain flash backward, the functions the CUDA kernels K4-K6
are held to on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
The JAX side is ``jax.grad`` of its ``video_flash_attention``, which reaches
the Pallas flash backward (``flash_vjp_attention``) in interpret mode, or
its XLA-oracle VJP in dense mode. fp32, rtol 1e-4 and atol 1e-3 as in
tests/test_video_flash_bwd.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motioneditor_tpu.ops.video_flash import _pick_blocks
from motioneditor_tpu.ops.video_flash import video_flash_attention as jax_video_flash_attention
from motioneditor_tpu.ops.video_flash_bwd import _combine_partials as jax_combine_partials
from motioneditor_tpu.ops.video_flash_bwd import video_flash_fwd_res as jax_video_flash_fwd_res

from motioneditor_tpu_torch.ops.video_flash import (
    KernelWithPlainVJP,
    video_flash_attention,
    video_flash_attention_plain,
)
from motioneditor_tpu_torch.ops.video_flash_bwd import (
    VideoFlashAttentionFn,
    combine_partials,
    video_flash_bwd_plain,
    video_flash_fwd_res_plain,
)

from torch_port_helpers import assert_close, normal, setup_torch

B, F, N = 1, 3, 128
SHAPES = [(32, 4), (320, 8)]  # (c, heads): d = 8 and the real head dim 40
BWD_MODES = ["normal", "sparse_causal", "motion_frame"]


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _inputs(seed, c, count=3):
    rng = np.random.default_rng(seed)
    return [normal(rng, (B, F, N, c)) for _ in range(count)]


def _port_grads(fn, arrays):
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*xs)
    return torch.autograd.grad(out.pow(2).sum(), xs)


@pytest.mark.parametrize("c,heads", SHAPES)
@pytest.mark.parametrize("mode", BWD_MODES + ["dense"])
def test_gradients_match_jax(mode, c, heads):
    """sum(out**2) gradients: the plain version under autograd, and the
    autograd Function the CUDA path takes, both against jax.grad."""
    arrays = _inputs(0, c)
    scale = (c // heads) ** -0.5

    def jax_loss(q, k, v):
        return jnp.sum(jax_video_flash_attention(q, k, v, mode, scale, heads) ** 2)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    plain = _port_grads(lambda *t: video_flash_attention(*t, mode, scale, heads), arrays)
    if mode == "dense":
        fn = lambda *t: KernelWithPlainVJP.apply(  # noqa: E731
            lambda *u: video_flash_attention_plain(*u, mode, scale, heads),
            lambda *u: video_flash_attention_plain(*u, mode, scale, heads), *t)
    else:
        fn = lambda *t: VideoFlashAttentionFn.apply(*t, mode, scale, heads)  # noqa: E731
    via_fn = _port_grads(fn, arrays)
    for got in (plain, via_fn):
        for a, b in zip(got, ref):
            assert_close(a, b, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("mode", BWD_MODES)
def test_fwd_res_lse_matches_jax(mode):
    """The plain residual-saving forward: out, and lse [B, F, N, H] against
    the first H lanes of JAX's [B, F, N, 128] fp32 buffer."""
    c, heads = 320, 8
    q, k, v = _inputs(1, c)
    scale = (c // heads) ** -0.5
    bq, bk = _pick_blocks(N, c, 4, kv_streams=2, heads=heads)
    out_ref, lse_ref = jax_video_flash_fwd_res(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mode, scale, heads, bq, bk, True)
    out, lse = video_flash_fwd_res_plain(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), mode, scale, heads)
    assert lse.shape == (B, F, N, heads) and lse.dtype == torch.float32
    assert_close(out, out_ref, atol=2e-5)
    assert_close(lse, np.asarray(lse_ref)[..., :heads], atol=1e-5)


@pytest.mark.parametrize("mode", BWD_MODES)
def test_combine_partials_matches_jax(mode):
    """The frame scatter of per-(target, slot) partials, with F = 4 so the
    first, middle and last frames all take part (the off-by-one-frame trap
    of tests/test_video_flash_bwd.py::test_bwd_memory_shape_invariants)."""
    rng = np.random.default_rng(2)
    slots = 1 if mode == "normal" else 2
    parts = normal(rng, (2, 4, slots, 16, 8))
    ref = jax_combine_partials(jnp.asarray(parts), mode)
    out = combine_partials(torch.from_numpy(parts), mode)
    assert out.shape == (2, 4, 16, 8)
    assert_close(out, ref, atol=1e-6)


@pytest.mark.parametrize("mode", BWD_MODES)
def test_bwd_plain_matches_autograd(mode):
    """video_flash_bwd_plain, the flash-backward formulas written out, against
    torch.autograd.grad of the forward's plain version, for an arbitrary
    output gradient."""
    c, heads = 64, 4
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, c, count=4))
    scale = (c // heads) ** -0.5
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(video_flash_attention_plain(*xs, mode, scale, heads), xs, do)
    out, lse = video_flash_fwd_res_plain(q, k, v, mode, scale, heads)
    got = video_flash_bwd_plain(q, k, v, out, lse, do, mode, scale, heads)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_function_skips_inputs_without_grad():
    """Inputs that need no gradient get None from the Function's backward."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 32))
    v.requires_grad_()
    VideoFlashAttentionFn.apply(q, k, v, "motion_frame", 0.5, 4).sum().backward()
    assert q.grad is None and k.grad is None
    assert v.grad is not None and v.grad.shape == v.shape
