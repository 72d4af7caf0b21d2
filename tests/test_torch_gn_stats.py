"""The port's pair statistics and fused GroupNorm (ops/gn_stats.py, K10's
module) against the JAX package's (motioneditor_tpu/ops/gn_stats.py, its
Pallas kernel in interpret mode), fp32 on the CPU, where the port's
wrapper takes the kernel's plain version. Also the MOTIONEDITOR_FUSED_GN
knob and ``group_norm``'s routing.

Tolerances: the statistics to 1e-5 relative (fp32 sums of 512 terms in
two orders); the GroupNorm output to 1e-5 and its gradients (dx, dscale,
dbias) to 1e-4 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from motioneditor_tpu.ops import gn_stats as JG

from motioneditor_tpu_torch.models.layers import group_norm
from motioneditor_tpu_torch.ops import gn_stats
from motioneditor_tpu_torch.utils.runtime import env_flag

from torch_port_helpers import normal, setup_torch, tensor

EPS = 1e-6


@pytest.fixture(autouse=True)
def _threads():
    setup_torch()


@pytest.mark.parametrize("same", [True, False])
def test_pair_stats_match_jax_kernel(same):
    rng = np.random.default_rng(41)
    a = normal(rng, (3, 512, 64)) + 0.5
    b = a if same else normal(rng, (3, 512, 64))
    rows = JG._pick_rows(512, 64, 4)
    ref = JG._pair_stats(jnp.asarray(a), jnp.asarray(b), rows, True)
    ta = tensor(a)
    got = gn_stats.channel_pair_stats(ta, ta if same else tensor(b))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (3, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def _norm_params(rng, c):
    p = nn.GroupNorm(8, c)
    with torch.no_grad():
        p.weight.copy_(tensor(1.0 + normal(rng, (c,), 0.3)))
        p.bias.copy_(tensor(normal(rng, (c,), 0.2)))
    return p


@pytest.mark.parametrize("shape", [(1, 2, 8, 8, 64), (4, 8, 8, 64)])
def test_group_norm_fused_matches_jax_vjp(monkeypatch, shape):
    """Forward and (dscale, dbias, dx) of sum(GN(x) * w) against JAX's
    custom VJP, both with the knob on: the pooled video GroupNorm (5D) and
    the per-frame one (4D)."""
    monkeypatch.setenv("MOTIONEDITOR_FUSED_GN", "1")
    rng = np.random.default_rng(42)
    x = normal(rng, shape, 1.5) + 0.7
    w = normal(rng, shape)
    p = _norm_params(rng, shape[-1])
    jp = {"scale": jnp.asarray(p.weight.detach().numpy()),
          "bias": jnp.asarray(p.bias.detach().numpy())}

    def jax_loss(params, x):
        y = JG.group_norm_fused(params, x, 8, EPS)
        return jnp.sum(y * jnp.asarray(w)), y

    (_, ref_y), (ref_dp, ref_dx) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                      has_aux=True)(jp, jnp.asarray(x))
    tx = tensor(x).requires_grad_()
    y = group_norm(p, tx, 8, EPS)
    (y * tensor(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), atol=1e-5)
    for got, ref in ((tx.grad, ref_dx), (p.weight.grad, ref_dp["scale"]),
                     (p.bias.grad, ref_dp["bias"])):
        ref = np.asarray(ref)
        top = np.abs(ref).max()
        np.testing.assert_allclose(got.numpy() / top, ref / top, atol=1e-4)


def test_group_norm_fused_equals_plain_group_norm(monkeypatch):
    """The Function's forward and gradient against autograd of the port's
    plain ``group_norm``, the two routes of ``layers.group_norm``."""
    rng = np.random.default_rng(43)
    x = tensor(normal(rng, (2, 3, 4, 4, 32), 2.0) - 1.0)
    p = _norm_params(rng, 32)
    outs = {}
    for knob in ("0", "1"):
        monkeypatch.setenv("MOTIONEDITOR_FUSED_GN", knob)
        xi = x.clone().requires_grad_()
        p.zero_grad()
        y = group_norm(p, xi, 8, EPS)
        (y ** 2).sum().backward()
        outs[knob] = [y.detach(), xi.grad, p.weight.grad.clone(), p.bias.grad.clone()]
    for a, b in zip(outs["1"], outs["0"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("val", ["0", "false", "False", "no", "off", "OFF", " 0 ", ""])
def test_knob_falsy_spellings_route_to_plain(monkeypatch, val):
    monkeypatch.setenv("MOTIONEDITOR_FUSED_GN", val)
    assert env_flag("MOTIONEDITOR_FUSED_GN", True) is False
    calls = []
    monkeypatch.setattr(gn_stats.GroupNormFn, "apply", lambda *a: calls.append(a))
    x = tensor(normal(np.random.default_rng(44), (2, 4, 4, 32)))
    y = group_norm(_norm_params(np.random.default_rng(45), 32), x, 8, EPS)
    assert not calls and y.shape == x.shape


@pytest.mark.parametrize("val", ["1", "true", "on", "yes"])
def test_knob_truthy_spellings_route_to_the_kernel(monkeypatch, val):
    monkeypatch.setenv("MOTIONEDITOR_FUSED_GN", val)
    calls = []
    monkeypatch.setattr(gn_stats, "channel_pair_stats",
                        lambda a, b: calls.append(a.shape) or gn_stats.channel_pair_stats_plain(a, b))
    x = tensor(normal(np.random.default_rng(46), (2, 4, 4, 32)))
    group_norm(_norm_params(np.random.default_rng(47), 32), x, 8, EPS)
    assert calls == [(2, 16, 32)]


def test_knob_default_is_off(monkeypatch):
    monkeypatch.delenv("MOTIONEDITOR_FUSED_GN", raising=False)
    assert gn_stats.enabled() is False
    monkeypatch.setenv("MOTIONEDITOR_FUSED_GN", "1")
    assert gn_stats.enabled() is True
