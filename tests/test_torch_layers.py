"""The port's NN primitives, blocks and scheduler against their JAX
counterparts, fp32 on the CPU, on the same seeded numpy inputs and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from motioneditor_tpu import schedulers as JS
from motioneditor_tpu.models import layers as JL
from motioneditor_tpu.models import unet as JU

from motioneditor_tpu_torch import schedulers as TS
from motioneditor_tpu_torch.models import layers as TL
from motioneditor_tpu_torch.models import unet as TU
from motioneditor_tpu_torch.models.from_jax import module_state_dict

from torch_port_helpers import assert_close, normal, random_params, setup_torch, to_jax


@pytest.fixture(autouse=True)
def _torch_threads():
    setup_torch()


def _load(module: nn.Module, kind: str, tree) -> nn.Module:
    module.load_state_dict(module_state_dict(kind, tree))
    return module.eval()


def _run(fn, *args, **kw):
    with torch.no_grad():
        return fn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args), **kw)


def test_linear():
    tree = random_params(lambda: JL.init_linear(jax.random.PRNGKey(0), 8, 16), seed=0)
    x = normal(np.random.default_rng(0), (2, 3, 8))
    out = _run(TL.linear, _load(nn.Linear(8, 16), "linear", tree), x)
    assert_close(out, JL.linear(to_jax(tree), jnp.asarray(x)), atol=1e-5)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0), (1, "SAME")])
def test_conv2d(stride, padding):
    k = 1 if padding == 0 else 3
    tree = random_params(lambda: JL.init_conv2d(jax.random.PRNGKey(0), 6, 10, k), seed=1)
    x = normal(np.random.default_rng(1), (2, 12, 12, 6))
    conv = _load(nn.Conv2d(6, 10, k), "conv", tree)
    out = _run(TL.conv2d, conv, x, stride=stride, padding=padding)
    ref = JL.conv2d(to_jax(tree), jnp.asarray(x), stride=stride, padding=padding)
    assert_close(out, ref, atol=1e-5)


def test_inflated_conv3d():
    tree = random_params(lambda: JL.init_conv2d(jax.random.PRNGKey(0), 4, 8, 3), seed=2)
    x = normal(np.random.default_rng(2), (2, 3, 8, 8, 4))
    out = _run(TL.inflated_conv3d, _load(nn.Conv2d(4, 8, 3), "conv", tree), x, padding=1)
    assert_close(out, JL.inflated_conv3d(to_jax(tree), jnp.asarray(x), padding=1), atol=1e-5)


@pytest.mark.parametrize("ksize,padding", [(3, "SAME"), (1, "VALID")])
def test_temporal_conv(ksize, padding):
    """The conv form JAX runs off-TPU (layers.py:155-166)."""
    rng = np.random.default_rng(3)
    tree = {"kernel": normal(rng, (ksize, 8, 8), 0.2), "bias": normal(rng, (8,), 0.1)}
    x = normal(rng, (2, 5, 4, 4, 8))
    conv = _load(nn.Conv1d(8, 8, ksize), "temporal_conv", tree)
    out = _run(TL.temporal_conv, conv, x, padding=padding)
    assert_close(out, JL.temporal_conv(to_jax(tree), jnp.asarray(x), padding=padding),
                 atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 16), (2, 5, 4, 16)])
def test_group_norm_pools_interior_axes(shape):
    rng = np.random.default_rng(4)
    tree = {"scale": 1 + normal(rng, (16,), 0.1), "bias": normal(rng, (16,), 0.1)}
    x = normal(rng, shape) * 3 + 1
    out = _run(TL.group_norm, _load(nn.GroupNorm(4, 16), "norm", tree), x, 4, 1e-5)
    assert_close(out, JL.group_norm(to_jax(tree), jnp.asarray(x), 4, 1e-5), atol=2e-5)


def test_layer_norm():
    rng = np.random.default_rng(5)
    tree = {"scale": 1 + normal(rng, (24,), 0.1), "bias": normal(rng, (24,), 0.1)}
    x = normal(rng, (2, 3, 7, 24)) * 2 + 0.5
    out = _run(TL.layer_norm, _load(nn.LayerNorm(24), "norm", tree), x)
    assert_close(out, JL.layer_norm(to_jax(tree), jnp.asarray(x)), atol=2e-5)


def test_feed_forward_geglu():
    tree = random_params(lambda: JL.init_feed_forward(jax.random.PRNGKey(0), 16), seed=6)
    x = normal(np.random.default_rng(6), (2, 3, 5, 16))
    out = _run(TL.feed_forward, _load(TL.FeedForward(16), "feed_forward", tree), x)
    assert_close(out, JL.feed_forward(to_jax(tree), jnp.asarray(x)), atol=1e-5)


def test_timestep_embedding():
    ts = np.array([1, 21, 321, 981], np.int64)
    emb = TL.sinusoidal_timestep_embedding(torch.from_numpy(ts), 32)
    ref = JL.sinusoidal_timestep_embedding(jnp.asarray(ts), 32)
    assert_close(emb, ref, atol=1e-5)
    tree = random_params(
        lambda: JL.init_timestep_embedding_mlp(jax.random.PRNGKey(0), 32, 128), seed=7)
    mlp = TL.TimestepEmbedding(32, 128)
    mlp.load_state_dict({
        f"{name}.{k}": v for name in ("linear_1", "linear_2")
        for k, v in module_state_dict("linear", tree[name]).items()})
    out = _run(TL.timestep_embedding_mlp, mlp, emb)
    assert_close(out, JL.timestep_embedding_mlp(to_jax(tree), ref), atol=1e-5)


def test_upsample_conv():
    """Nearest-2x + 3x3 conv (the two-op form JAX runs off-TPU)."""
    tree = random_params(lambda: JL.init_conv2d(jax.random.PRNGKey(0), 8, 8, 3), seed=8)
    x = normal(np.random.default_rng(8), (2, 3, 4, 5, 8))
    out = _run(TL.upsample_conv3d_2x, _load(nn.Conv2d(8, 8, 3), "conv", tree), x)
    assert out.shape == (2, 3, 8, 10, 8)
    assert_close(out, JL.upsample_conv3d_2x(to_jax(tree), jnp.asarray(x)), atol=1e-5)


@pytest.mark.parametrize("size", [(8, 8), (5, 3), (16, 24)])
def test_nearest_resize(size):
    x = normal(np.random.default_rng(9), (3, 16, 12, 2))
    out = TL.nearest_resize(torch.from_numpy(x), size)
    assert_close(out, JL.nearest_resize(jnp.asarray(x), size), atol=0)


@pytest.mark.parametrize("per_frame_gn", [False, True])
def test_resnet_block(per_frame_gn):
    """GN across frames (UNet) or per frame (ControlNet), temporal convs,
    time embedding and the 1x1 shortcut."""
    tree = random_params(
        lambda: JU._init_resnet(jax.random.PRNGKey(0), 16, 32, 64, video=True), seed=10)
    rng = np.random.default_rng(10)
    x = normal(rng, (2, 3, 6, 6, 16))
    temb = normal(rng, (2, 64))
    block = _load(TU.ResnetBlock(16, 32, 64, 8, 1e-5, video=True), "resnet", tree)
    out = _run(TU.resnet_block, block, x, temb, groups=8, eps=1e-5,
               per_frame_gn=per_frame_gn)
    ref = JU.resnet_block(to_jax(tree), jnp.asarray(x), jnp.asarray(temb), groups=8,
                          eps=1e-5, per_frame_gn=per_frame_gn)
    assert_close(out, ref, atol=1e-4, rtol=1e-4)


def test_ddim_step_and_timesteps():
    js, ts = JS.DiffusionSchedule(), TS.DiffusionSchedule()
    np.testing.assert_array_equal(ts.inference_timesteps(50), js.inference_timesteps(50))
    assert_close(ts.alphas_cumprod, js.alphas_cumprod, atol=0)
    rng = np.random.default_rng(11)
    x, eps = normal(rng, (2, 3, 4, 4, 4)), normal(rng, (2, 3, 4, 4, 4))
    for t in (981, 501, 21, 1):
        out = TS.ddim_step(ts, torch.from_numpy(eps), t, torch.from_numpy(x), 50)
        ref = JS.ddim_step(js, jnp.asarray(eps), jnp.asarray(t), jnp.asarray(x), 50)
        assert_close(out, ref, atol=1e-6, rtol=1e-6)


def test_init_params_follows_the_jax_rules():
    """Uniform +-1/sqrt(fan_in), norms 1/0, temporal convs and marked
    modules zero (a seeded torch.Generator, no JAX)."""
    block = TU.BasicTransformerBlock(32, 16, 4, video=True)
    res = TU.ResnetBlock(32, 32, 64, 8, 1e-5, video=True)
    gen = torch.Generator().manual_seed(0)
    TL.init_params(block, gen)
    TL.init_params(res, gen)
    assert torch.count_nonzero(block.attn_temp.to_out[0].weight) == 0
    assert torch.count_nonzero(res.temp_conv1.weight) == 0
    assert block.attn1.to_q.weight.abs().max() <= 32 ** -0.5
    assert block.attn1.to_q.weight.abs().max() > 0.9 * 32 ** -0.5
    assert torch.all(block.norm1.weight == 1) and torch.all(block.norm1.bias == 0)
