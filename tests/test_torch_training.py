"""The port's stage-1 training (training/common.py, training/stage1.py)
against the JAX package, fp32 on the CPU, on the tiny UNet of
tests/torch_port_helpers.py (F = 2, 16x16 latents).

The port draws its noise from a torch.Generator, which cannot reproduce
jax.random; each parity test draws JAX's noise and timesteps as
``train_step_stage1`` does (stage1.py:59-61, after the split) and hands
them to the port's step in place of its own draw. JAX's reference is one
compiled ``value_and_grad`` of stage1.py's micro-batch loss with the target
as an input (so epsilon, velocity and each accumulated micro-batch share
the compile), followed by JAX's own ``make_optimizer`` update, as
``train_step_stage1`` does after its ``value_and_grad``.

Tolerances: the loss to 1e-5 relative; gradients to 1e-4 of their largest
magnitude; parameters after one train step to 1e-6. Adam's first update
g / (|g| + eps) is about lr per element whatever the gradient's size, so
with the default eps of 1e-8 a rounding-level gradient near zero can flip
its element's update. The train-step tests take eps = 1e-4, which bounds
the update's change by lr * |dg| / eps and makes the parameters' agreement
follow from the gradients'. The optimizer alone, on identical gradients
and the default eps, agrees with optax to a few float32 ulps (rtol 1e-6,
atol 1e-7).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from motioneditor_tpu.models.unet import unet_apply as jax_unet_apply
from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule
from motioneditor_tpu.schedulers import ddpm_add_noise as jax_add_noise
from motioneditor_tpu.schedulers import ddpm_velocity as jax_velocity
from motioneditor_tpu.training import common as JT
from motioneditor_tpu.training.stage1 import TRAINABLE_MODULES as JAX_MODULES

from motioneditor_tpu_torch.models.from_jax import trainable_names, unet_state_dict
from motioneditor_tpu_torch.models.unet import UNetConfig
from motioneditor_tpu_torch.training import stage1
from motioneditor_tpu_torch.training.common import (
    make_optimizer,
    make_train_state,
    trainable_mask,
)
from motioneditor_tpu_torch.training.stage1 import TRAINABLE_MODULES, stage1_loss

from torch_port_helpers import JAX_TINY, TINY_KW, normal, setup_torch, tensor, tiny_unet

TINY = UNetConfig(**TINY_KW)
F, HW, L = 2, 16, 7
LR = 1e-3
ADAM_EPS = 1e-4


@pytest.fixture(scope="module")
def weights():
    setup_torch()
    return tiny_unet(seed=21)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(22)
    return dict(latents=normal(rng, (1, F, HW, HW, 4), 0.5), enc=normal(rng, (1, L, 16), 0.5))


def jax_noise(key: int, latents):
    """The noise and timesteps ``train_step_stage1`` draws from PRNGKey(key)."""
    rng_noise, rng_t = jax.random.split(jax.random.PRNGKey(key))
    noise = jax.random.normal(rng_noise, latents.shape, jnp.float32)
    t = jax.random.randint(rng_t, (latents.shape[0],), 0, 1000)
    return np.asarray(noise), np.asarray(t)


@pytest.fixture(scope="module")
def jax_ref(weights, inputs):
    """JAX's loss and trainable gradients as a function of the noise key
    and the prediction type, through one compile."""
    params = weights[0]
    trainable, frozen = JT.partition_params(params, JT.trainable_mask(params, JAX_MODULES))

    @jax.jit
    def value_and_grad(trainable, frozen, noisy, t, enc, target):
        def loss_fn(trainable):
            pred = jax_unet_apply(JT.combine_params(trainable, frozen), JAX_TINY, noisy, t, enc)
            return jnp.mean((pred.astype(jnp.float32) - target) ** 2)

        return jax.value_and_grad(loss_fn)(trainable)

    def ref(key: int, prediction_type: str = "epsilon"):
        lat = jnp.asarray(inputs["latents"])
        noise, t = jax_noise(key, lat)
        noisy = jax_add_noise(JaxSchedule(), lat, jnp.asarray(noise), jnp.asarray(t))
        target = (noise if prediction_type == "epsilon"
                  else jax_velocity(JaxSchedule(), lat, jnp.asarray(noise), jnp.asarray(t)))
        loss, grads = value_and_grad(trainable, frozen, noisy, jnp.asarray(t),
                                     jnp.asarray(inputs["enc"]), jnp.asarray(target))
        return float(loss), grads, (noise, t)

    return trainable, frozen, ref


def port_names(tree_like_params, frozen):
    """A JAX tree over the trainables (None elsewhere) as {port name: tensor},
    filling the frozen leaves with zeros."""
    zeros = jax.tree_util.tree_map(jnp.zeros_like, frozen)
    return unet_state_dict(JT.combine_params(tree_like_params, zeros))


@jax.jit
def jax_step(trainable, grads):
    """JAX's make_optimizer update, as train_step_stage1 applies it."""
    opt = JT.make_optimizer(learning_rate=LR, eps=ADAM_EPS)
    updates, _ = opt.update(grads, opt.init(trainable), trainable)
    return optax.apply_updates(trainable, updates)


def use_noise(monkeypatch, draws):
    """Make the port's step take ``draws`` [(noise, t), ...] in order."""
    it = iter(draws)
    monkeypatch.setattr(stage1, "draw_noise",
                        lambda *a: tuple(torch.from_numpy(np.array(x)) for x in next(it)))


def fresh_state(unet, **opt):
    return make_train_state(copy.deepcopy(unet), TRAINABLE_MODULES,
                            make_optimizer(learning_rate=LR, eps=ADAM_EPS, **opt))


def assert_grads(state, ref_tree, frozen):
    ref = port_names(ref_tree, frozen)
    top = max(float(ref[n].abs().max()) for n in state.trainable)
    assert top > 1e-4  # the comparison is not vacuous
    for name, p in state.trainable.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad  # not reached by the loss
        np.testing.assert_allclose(got.numpy() / top, ref[name].numpy() / top, atol=1e-4,
                                   err_msg=name)


def test_trainable_sets_match_jax(weights):
    params, unet = weights
    for port_modules, jax_modules in ((TRAINABLE_MODULES, JAX_MODULES),
                                      (("controlnet_adapter",), ("controlnet_adapter",))):
        want = trainable_names(JT.trainable_mask(params, jax_modules), params)
        mask = trainable_mask(unet, port_modules)
        assert {n for n, on in mask.items() if on} == want
    on = {n for n, v in trainable_mask(unet, TRAINABLE_MODULES).items() if v}
    assert any(".attn_temp.to_k." in n for n in on)  # attn_temp unfreezes its subtree
    assert not any(".attn1.to_k." in n for n in on)
    assert any(n.endswith("attn_temp.to_out.0.bias") for n in on)


@pytest.mark.parametrize("knobs", ["off", "on"])
def test_stage1_loss_and_grads_match_jax(weights, inputs, jax_ref, monkeypatch, knobs):
    """With the kernels' knobs on, the port's GroupNorm runs through the
    pair-stats Function (plain statistics on the CPU) against JAX's plain
    reference: the same math."""
    if knobs == "on":
        monkeypatch.setenv("MOTIONEDITOR_FUSED_GN", "1")
        monkeypatch.setenv("MOTIONEDITOR_FUSED_LN", "1")
    _, frozen, ref = jax_ref
    ref_loss, ref_grads, (noise, t) = ref(3)
    state = fresh_state(weights[1])
    loss = stage1_loss(state.model, TINY, tensor(inputs["latents"]), tensor(inputs["enc"]),
                       tensor(noise), torch.from_numpy(t.copy()), remat=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    assert_grads(state, ref_grads, frozen)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_stage1_train_step_matches_jax(weights, inputs, jax_ref, monkeypatch, prediction_type):
    """One train_step_stage1 (global-norm clip + AdamW) against JAX's
    optimizer applied to JAX's gradients; only the trainables change."""
    trainable, frozen, ref = jax_ref
    ref_loss, ref_grads, draw = ref(4, prediction_type)
    use_noise(monkeypatch, [draw])
    state = fresh_state(weights[1])
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, metrics = stage1.train_step_stage1(
        state, tensor(inputs["latents"]), tensor(inputs["enc"]), torch.Generator(),
        unet_config=TINY, prediction_type=prediction_type)
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), ref_loss, rtol=1e-5)
    want = port_names(jax_step(trainable, ref_grads), frozen)
    for name, p in state.model.named_parameters():
        if name in state.trainable:  # all move: the unreached ones by weight decay
            assert not torch.equal(p, before[name]), name
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                       err_msg=name)
        else:
            assert torch.equal(p, before[name]), name


def test_stage1_accumulation_matches_jax(weights, inputs, jax_ref, monkeypatch):
    """accum_steps = 2: the mean of two micro-batches' losses and gradients,
    then one optimizer step (stage1.py:79-103)."""
    trainable, frozen, ref = jax_ref
    (l1, g1, d1), (l2, g2, d2) = ref(5), ref(6)
    use_noise(monkeypatch, [d1, d2])
    state = fresh_state(weights[1])
    state, metrics = stage1.train_step_stage1(
        state, tensor(inputs["latents"]), tensor(inputs["enc"]), torch.Generator(),
        unet_config=TINY, accum_steps=2)
    np.testing.assert_allclose(float(metrics["loss"]), (l1 + l2) / 2, rtol=1e-5)
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, g1, g2)
    want = port_names(jax_step(trainable, mean), frozen)
    for name, p in state.trainable.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6,
                                   err_msg=name)


def test_remat_equals_no_remat(weights, inputs):
    """Gradient checkpointing recomputes the same activations: the loss and
    the gradients agree to 1e-7 with it on and off."""
    rng = np.random.default_rng(23)
    noise, t = tensor(normal(rng, (1, F, HW, HW, 4))), torch.tensor([617])
    grads = {}
    for remat in (False, True):
        state = fresh_state(weights[1])
        loss = stage1_loss(state.model, TINY, tensor(inputs["latents"]), tensor(inputs["enc"]),
                           noise, t, remat=remat)
        loss.backward()
        grads[remat] = (loss.item(), {n: p.grad.clone() for n, p in state.trainable.items()
                                      if p.grad is not None})
    assert grads[True][0] == pytest.approx(grads[False][0], abs=1e-7)
    for name, g in grads[True][1].items():
        torch.testing.assert_close(g, grads[False][1][name], atol=1e-7, rtol=0)


def test_mixed_precision_reaches_fp32_masters(weights, inputs):
    """bf16 frozen weights and compute, fp32 masters: the gradients reach
    the fp32 trainables through the casts at use, and a step moves them."""
    state = make_train_state(copy.deepcopy(weights[1]), TRAINABLE_MODULES,
                             make_optimizer(learning_rate=LR), frozen_dtype=torch.bfloat16)
    dtypes = {n: p.dtype for n, p in state.model.named_parameters()}
    assert all(dtypes[n] == torch.float32 for n in state.trainable)
    assert {d for n, d in dtypes.items() if n not in state.trainable} == {torch.bfloat16}
    before = {n: p.detach().clone() for n, p in state.trainable.items()}
    state, metrics = stage1.train_step_stage1(
        state, tensor(inputs["latents"]), tensor(inputs["enc"]), torch.Generator().manual_seed(0),
        unet_config=TINY, compute_dtype=torch.bfloat16)
    assert np.isfinite(float(metrics["loss"]))
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in state.trainable.values())
    assert any(not torch.equal(p, before[n]) for n, p in state.trainable.items())


def test_optimizer_matches_optax_on_the_same_gradients():
    """Three steps of make_optimizer (clip + AdamW, weight decay on every
    trainable, biases included) on identical gradients, against optax's."""
    rng = np.random.default_rng(25)
    shapes = {"w": (6, 4), "b": (4,)}
    params = {k: normal(rng, s) for k, s in shapes.items()}
    grads = [{k: normal(rng, s, 0.7) for k, s in shapes.items()} for _ in range(3)]
    ps = {k: torch.nn.Parameter(tensor(v)) for k, v in params.items()}
    opt = make_optimizer(learning_rate=1e-3, max_grad_norm=1.0)(ps.values())
    jopt = JT.make_optimizer(learning_rate=1e-3, max_grad_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    for g in grads:
        for k, p in ps.items():
            p.grad = tensor(g[k])
        opt.step()
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
    for k, p in ps.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_clip_matches_optax():
    """Global-norm clipping as optax does it: scaled by max / norm once the
    norm reaches max, untouched below."""
    from motioneditor_tpu_torch.training.common import clip_by_global_norm_

    rng = np.random.default_rng(24)
    gs = [normal(rng, (5, 3)), normal(rng, (7,))]
    for max_norm in (0.5, 100.0):
        ps = [torch.zeros(g.shape, requires_grad=True) for g in gs]
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        norm = clip_by_global_norm_(ps, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in gs], None)
        assert float(norm) == pytest.approx(float(optax.global_norm(gs)), rel=1e-6)
        for p, w in zip(ps, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)
