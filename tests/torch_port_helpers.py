"""Shared helpers for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py).

Both packages get the same numbers: inputs and parameters are drawn with
numpy from a seed, handed to JAX as jnp arrays and to the port as torch
tensors (parameters through motioneditor_tpu_torch.models.from_jax).
Parameters are fully random, zero-init modules included, so the temporal
convs, temporal attention outputs and ControlNet zero convs take part in
every comparison.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from motioneditor_tpu.models.unet import UNetConfig as JaxUNetConfig
from motioneditor_tpu.models.unet import init_unet

TINY_KW = dict(
    block_out_channels=(32, 64, 64, 64),
    norm_num_groups=8,
    attention_heads=4,
    cross_attention_dim=16,
    use_sc_attn=True,
)
JAX_TINY = JaxUNetConfig(**TINY_KW)


def setup_torch():
    torch.set_num_threads(1)


def random_params(init_fn, *args, seed: int):
    """A JAX parameter tree with the structure ``init_fn(*args)`` builds
    (traced for shapes only) and seeded numpy leaves: norm scales near 1,
    biases ~0.1, kernels uniform in +-1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        shape = tuple(x.shape)
        name = getattr(path[-1], "key", None)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        bound = 1.0 / math.sqrt(max(1, int(np.prod(shape[:-1]))))
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    shapes = jax.eval_shape(init_fn, *args)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def assert_close(port_out, jax_out, atol, rtol=0.0):
    np.testing.assert_allclose(
        port_out.detach().float().numpy(), np.asarray(jax_out, np.float32),
        atol=atol, rtol=rtol,
    )


def tensor(a):
    """A float32 torch tensor holding a copy of the numpy or JAX array ``a``."""
    return torch.from_numpy(np.array(a, np.float32))


def tiny_unet(seed: int = 1):
    """The tiny video UNet with seeded random weights, as a JAX parameter
    tree and as the port's module (eval mode, fp32)."""
    from motioneditor_tpu_torch.models.from_jax import unet_state_dict
    from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig

    tree = random_params(lambda: init_unet(jax.random.PRNGKey(0), JAX_TINY), seed=seed)
    unet = UNet3DConditionModel(UNetConfig(**TINY_KW)).eval()
    unet.load_state_dict(unet_state_dict(tree))
    return to_jax(tree), unet
