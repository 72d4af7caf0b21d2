"""The port's stage-2 adapter training (training/stage2.py) against the JAX
package, fp32 on the CPU: the tiny UNet with its adapter and the tiny
ControlNet of tests/torch_port_helpers.py (F = 2, 8x8 latents, 64x64
skeleton frames).

As in tests/test_torch_training.py, JAX's noise and timesteps are drawn
as ``train_step_stage2`` draws them (stage2.py:53-56) and handed to the
port's step, and JAX's reference is one compiled ``value_and_grad`` of
stage2.py's loss (the frozen ControlNet on the source skeleton under
stop_gradient, then the UNet's adapter branch), followed by JAX's own
``make_optimizer`` update. Tolerances as there: the loss to 1e-5
relative, the adapter's gradients to 1e-4 of their largest magnitude, the
parameters after one step to 1e-6 (Adam eps 1e-4, see that file).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from motioneditor_tpu.models.controlnet import controlnet_apply as jax_controlnet_apply
from motioneditor_tpu.models.controlnet import init_controlnet
from motioneditor_tpu.models.unet import unet_apply as jax_unet_apply
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule
from motioneditor_tpu.schedulers import ddpm_add_noise as jax_add_noise
from motioneditor_tpu.training import common as JT

from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config
from motioneditor_tpu_torch.models.from_jax import controlnet_state_dict, unet_state_dict
from motioneditor_tpu_torch.models.unet import UNetConfig
from motioneditor_tpu_torch.training import stage2
from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state
from motioneditor_tpu_torch.training.stage2 import TRAINABLE_MODULES, stage2_loss

from torch_port_helpers import (
    JAX_TINY,
    TINY_KW,
    normal,
    random_params,
    setup_torch,
    tensor,
    tiny_unet,
    to_jax,
)

TINY = UNetConfig(**TINY_KW)
JAX_CN = dataclasses.replace(JAX_TINY, video=False, use_sc_attn=False)
F, HW, L = 2, 8, 7
LR, ADAM_EPS = 1e-3, 1e-4


@pytest.fixture(scope="module")
def weights():
    setup_torch()
    unet_tree, unet = tiny_unet(seed=31)
    cn_tree = random_params(lambda: init_controlnet(jax.random.PRNGKey(1), JAX_CN), seed=32)
    cn = ControlNetModel(controlnet_config(TINY)).eval()
    cn.load_state_dict(controlnet_state_dict(cn_tree))
    cn.requires_grad_(False)
    return unet_tree, unet, to_jax(cn_tree), cn


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(33)
    return dict(latents=normal(rng, (1, F, HW, HW, 4), 0.5), enc=normal(rng, (1, L, 16), 0.5),
                skel=rng.uniform(0.0, 1.0, (1, F, 8 * HW, 8 * HW, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_ref(weights, inputs):
    params, _, cn_params, _ = weights
    trainable, frozen = JT.partition_params(
        params, JT.trainable_mask(params, ("controlnet_adapter",)))

    @jax.jit
    def value_and_grad(trainable, frozen, cn_params, noisy, t, enc, skel, target):
        down, mid = jax_controlnet_apply(cn_params, JAX_CN, noisy, t, enc, skel,
                                         conditioning_scale=1.0)
        down = [jax.lax.stop_gradient(d) for d in down]
        mid = jax.lax.stop_gradient(mid)

        def loss_fn(trainable):
            pred = jax_unet_apply(JT.combine_params(trainable, frozen), JAX_TINY, noisy, t, enc,
                                  down_block_additional_residuals=down,
                                  mid_block_additional_residual=mid)
            return jnp.mean((pred.astype(jnp.float32) - target) ** 2)

        return jax.value_and_grad(loss_fn)(trainable)

    lat = jnp.asarray(inputs["latents"])
    rng_noise, rng_t = jax.random.split(jax.random.PRNGKey(7))
    noise = jax.random.normal(rng_noise, lat.shape, jnp.float32)
    t = jax.random.randint(rng_t, (1,), 0, 1000)
    noisy = jax_add_noise(JaxSchedule(), lat, noise, t)
    loss, grads = value_and_grad(trainable, frozen, cn_params, noisy, t, jnp.asarray(inputs["enc"]),
                                 jnp.asarray(inputs["skel"]), noise)
    opt = JT.make_optimizer(learning_rate=LR, eps=ADAM_EPS)

    @jax.jit
    def step(trainable, grads):
        updates, _ = opt.update(grads, opt.init(trainable), trainable)
        return optax.apply_updates(trainable, updates)

    zeros = jax.tree_util.tree_map(jnp.zeros_like, frozen)
    return dict(loss=float(loss), noise=np.asarray(noise), t=np.asarray(t),
                grads=unet_state_dict(JT.combine_params(grads, zeros)),
                stepped=unet_state_dict(JT.combine_params(step(trainable, grads), zeros)))


def fresh_state(unet):
    return make_train_state(copy.deepcopy(unet), TRAINABLE_MODULES,
                            make_optimizer(learning_rate=LR, eps=ADAM_EPS))


def test_stage2_loss_and_adapter_grads_match_jax(weights, inputs, jax_ref):
    _, unet, _, cn = weights
    state = fresh_state(unet)
    assert state.trainable and all(n.startswith("controlnet_adapter.") for n in state.trainable)
    loss = stage2_loss(state.model, cn, TINY, controlnet_config(TINY), tensor(inputs["latents"]),
                       tensor(inputs["skel"]), tensor(inputs["enc"]), tensor(jax_ref["noise"]),
                       torch.from_numpy(jax_ref["t"].copy()), remat=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_ref["loss"], rtol=1e-5)
    ref = jax_ref["grads"]
    top = max(float(ref[n].abs().max()) for n in state.trainable)
    assert top > 1e-4
    for name, p in state.trainable.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy() / top, ref[name].numpy() / top, atol=1e-4,
                                   err_msg=name)
    assert all(p.grad is None for p in cn.parameters())


def test_stage2_train_step_matches_jax_and_moves_only_the_adapter(weights, inputs, jax_ref,
                                                                  monkeypatch):
    _, unet, _, cn = weights
    draw = (torch.from_numpy(jax_ref["noise"].copy()), torch.from_numpy(jax_ref["t"].copy()))
    monkeypatch.setattr(stage2, "draw_noise", lambda *a: draw)
    state = fresh_state(unet)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    cn_before = {n: p.detach().clone() for n, p in cn.named_parameters()}
    state, metrics = stage2.train_step_stage2(
        state, cn, tensor(inputs["latents"]), tensor(inputs["skel"]), tensor(inputs["enc"]),
        torch.Generator(), unet_config=TINY, controlnet_config=controlnet_config(TINY))
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), jax_ref["loss"], rtol=1e-5)
    for name, p in state.model.named_parameters():
        if name.startswith("controlnet_adapter."):
            np.testing.assert_allclose(p.detach().numpy(), jax_ref["stepped"][name].numpy(),
                                       atol=1e-6, err_msg=name)
            assert not torch.equal(p, before[name]), name
        else:
            assert torch.equal(p, before[name]), name
    assert all(torch.equal(p, cn_before[n]) for n, p in cn.named_parameters())


def test_stage2_remat_equals_no_remat(weights, inputs, jax_ref):
    _, unet, _, cn = weights
    out = {}
    for remat in (False, True):
        state = fresh_state(unet)
        loss = stage2_loss(state.model, cn, TINY, controlnet_config(TINY),
                           tensor(inputs["latents"]), tensor(inputs["skel"]),
                           tensor(inputs["enc"]), tensor(jax_ref["noise"]),
                           torch.from_numpy(jax_ref["t"].copy()), remat=remat)
        loss.backward()
        out[remat] = (loss.item(), {n: p.grad for n, p in state.trainable.items()})
    assert out[True][0] == pytest.approx(out[False][0], abs=1e-7)
    for name, g in out[True][1].items():
        torch.testing.assert_close(g, out[False][1][name], atol=1e-7, rtol=0)
