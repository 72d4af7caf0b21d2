"""The port's fused residual add + LayerNorm (ops/fused_norm.py, K11's
module) against the JAX package's (motioneditor_tpu/ops/fused_norm.py, its
Pallas kernel in interpret mode), fp32 on the CPU, where the port's
wrapper takes the kernel's plain version. Also the call-site gate of the
transformer block (flash on, N >= 512) and the MOTIONEDITOR_FUSED_LN knob.

Tolerances: outputs and gradients to 1e-5 (fp32, one LayerNorm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from motioneditor_tpu.ops import fused_norm as JF

from motioneditor_tpu_torch.models import unet as U
from motioneditor_tpu_torch.ops import fused_norm

from torch_port_helpers import normal, setup_torch, tensor

SHAPE = (1, 2, 512, 64)
EPS = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    setup_torch()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    t, d = normal(rng, SHAPE), normal(rng, SHAPE, 0.5) + 0.2
    norm = nn.LayerNorm(SHAPE[-1])
    with torch.no_grad():
        norm.weight.copy_(tensor(1.0 + normal(rng, (SHAPE[-1],), 0.3)))
        norm.bias.copy_(tensor(normal(rng, (SHAPE[-1],), 0.2)))
    return t, d, norm


def _jax_params(norm):
    return {"scale": jnp.asarray(norm.weight.detach().numpy()),
            "bias": jnp.asarray(norm.bias.detach().numpy())}


def test_add_layer_norm_matches_jax_kernel():
    t, d, norm = _inputs(51)
    jp = _jax_params(norm)
    bn = JF._pick_bn(SHAPE[2], SHAPE[3], 4)
    ref_s, ref_n = JF._add_ln(jnp.asarray(t), jnp.asarray(d), jp["scale"], jp["bias"], EPS, bn,
                              True)
    s, n = fused_norm.add_layer_norm(norm, tensor(t), tensor(d), EPS)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(ref_s), atol=1e-5)
    np.testing.assert_allclose(n.detach().numpy(), np.asarray(ref_n), atol=1e-5)


def test_add_layer_norm_grads_match_jax(monkeypatch):
    """Gradients of a weighted sum of both outputs with respect to tokens,
    delta, weight and bias, against jax.grad through JAX's add_layer_norm
    with the knob on (its kernel_with_xla_vjp takes the oracle's VJP)."""
    monkeypatch.setenv("MOTIONEDITOR_FUSED_LN", "1")
    t, d, norm = _inputs(52)
    rng = np.random.default_rng(53)
    ws, wn = normal(rng, SHAPE), normal(rng, SHAPE)

    def jax_loss(t, d, params):
        s, n = JF.add_layer_norm(params, t, d, EPS)
        return jnp.sum(s * ws) + jnp.sum(n * wn)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(t), jnp.asarray(d),
                                                _jax_params(norm))
    tt, td = tensor(t).requires_grad_(), tensor(d).requires_grad_()
    s, n = fused_norm.add_layer_norm(norm, tt, td, EPS)
    ((s * tensor(ws)).sum() + (n * tensor(wn)).sum()).backward()
    for got, want in ((tt.grad, ref[0]), (td.grad, ref[1]), (norm.weight.grad, ref[2]["scale"]),
                      (norm.bias.grad, ref[2]["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _block(c, seed):
    """A transformer block with random weights (zero-init output included)."""
    gen = torch.Generator().manual_seed(seed)
    block = U.BasicTransformerBlock(c, 16, 4, video=True)
    with torch.no_grad():
        for prm in block.parameters():
            prm.uniform_(-c ** -0.5, c ** -0.5, generator=gen)
    return block


@pytest.mark.parametrize("n,use_flash,knob,fused_sites", [
    (512, True, "1", 3),    # at the gate: norm2, norm3, norm_temp
    (256, True, "1", 0),    # N < 512: plain add + LN
    (512, False, "1", 0),   # flash off: plain
    (512, True, "0", 0),    # knob off (the default): plain
])
def test_block_call_site_gate(monkeypatch, n, use_flash, knob, fused_sites):
    """The block's three add + LN sites take add_layer_norm exactly under
    JAX's gate, and the block's output and gradient do not depend on the
    route."""
    monkeypatch.setenv("MOTIONEDITOR_FUSED_LN", knob)
    calls = []
    real = fused_norm.add_layer_norm
    monkeypatch.setattr(fused_norm, "add_layer_norm",
                        lambda *a, **k: calls.append(a[1].shape) or real(*a, **k))
    c = 32
    block = _block(c, 54)
    rng = np.random.default_rng(55)
    tokens = tensor(normal(rng, (1, 2, n, c))).requires_grad_()
    ctx = U.AttnContext(encoder_hidden_states=tensor(normal(rng, (1, 7, 16))), heads=4,
                        use_flash=use_flash)
    hw = (n // 16, 16)
    out = U.basic_transformer_block(block, tokens, ctx, 0, hw, "motion_frame")
    out.pow(2).sum().backward()
    assert len(calls) == fused_sites
    monkeypatch.setenv("MOTIONEDITOR_FUSED_LN", "0")
    ref_tokens = tokens.detach().clone().requires_grad_()
    ref = U.basic_transformer_block(block, ref_tokens, ctx, 0, hw, "motion_frame")
    ref.pow(2).sum().backward()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(tokens.grad, ref_tokens.grad, atol=1e-5, rtol=1e-5)


def test_knob_default_is_off(monkeypatch):
    monkeypatch.delenv("MOTIONEDITOR_FUSED_LN", raising=False)
    assert fused_norm.enabled() is False
    for val in ("0", "off", "False"):
        monkeypatch.setenv("MOTIONEDITOR_FUSED_LN", val)
        assert fused_norm.enabled() is False
    monkeypatch.setenv("MOTIONEDITOR_FUSED_LN", "1")
    assert fused_norm.enabled() is True
