"""The port's blockwise 8-bit AdamW (training/adam8bit.py) against the JAX
package's (motioneditor_tpu/training/adam8bit.py), fp32 on the CPU.

The codes and scales of one quantization must equal JAX's exactly (the
same fp32 operations in the same order); a 5-step trajectory on the same
gradients, through make_optimizer(use_8bit=True) (global-norm clip, then
8-bit AdamW) on both sides, must match to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from motioneditor_tpu.training import adam8bit as JA
from motioneditor_tpu.training.common import make_optimizer as jax_make_optimizer

from motioneditor_tpu_torch.training.adam8bit import AdamW8bit, dequantize, quantize
from motioneditor_tpu_torch.training.common import make_optimizer

from torch_port_helpers import normal, setup_torch, tensor

SHAPES = {"w": (40, 30), "b": (7,), "k": (3, 3, 8, 16)}  # ragged, short and 4D leaves


@pytest.fixture(autouse=True)
def _threads():
    setup_torch()


@pytest.mark.parametrize("signed", [True, False])
def test_codes_equal_jax(signed):
    rng = np.random.default_rng(61)
    x = normal(rng, (1000,), 0.01)
    if not signed:
        x = x * x  # second moments are non-negative
    x[256:512] = 0.0  # an all-zero block
    q, scale = quantize(tensor(x), signed)
    ref = JA._quantize(jnp.asarray(x), signed)
    assert q.dtype == (torch.int8 if signed else torch.uint8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(dequantize(q, scale, tensor(x)).numpy(),
                                  np.asarray(JA._dequantize(ref, x.shape)))


def test_five_steps_match_jax():
    rng = np.random.default_rng(62)
    params = {k: normal(rng, s, 0.5) for k, s in SHAPES.items()}
    grads = [{k: normal(rng, s, 0.3) for k, s in SHAPES.items()} for _ in range(5)]
    kw = dict(learning_rate=1e-2, weight_decay=1e-2, max_grad_norm=1.0, use_8bit=True)
    ps = {k: torch.nn.Parameter(tensor(v)) for k, v in params.items()}
    opt = make_optimizer(**kw)(ps.values())
    assert isinstance(opt.inner, AdamW8bit)
    jopt = jax_make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    for g in grads:
        for k, p in ps.items():
            p.grad = tensor(g[k])
        opt.step()
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in ps.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       err_msg=k)
    # the stored codes are the quantized moments of the last step
    jm = jstate[1][0].m
    for k, p in ps.items():
        np.testing.assert_array_equal(opt.inner.state[p]["m"].numpy(), np.asarray(jm[k].q))


def test_state_survives_a_state_dict_round_trip():
    """The base Optimizer casts state tensors to the parameter's dtype on
    load; the 8-bit codes come back as 8-bit codes and the next step is
    the step an uninterrupted optimizer takes."""
    rng = np.random.default_rng(63)
    p0, g1, g2 = (normal(rng, (300,)) for _ in range(3))
    runs = []
    for reload in (False, True):
        p = torch.nn.Parameter(tensor(p0))
        opt = AdamW8bit([p], lr=1e-2)
        p.grad = tensor(g1)
        opt.step()
        if reload:
            sd = opt.state_dict()
            opt = AdamW8bit([p], lr=1e-2)
            opt.load_state_dict(sd)
            assert opt.state[p]["m"].dtype == torch.int8
            assert opt.state[p]["v"].dtype == torch.uint8
        p.grad = tensor(g2)
        opt.step()
        runs.append(p.detach().clone())
    torch.testing.assert_close(runs[0], runs[1], atol=0, rtol=0)
