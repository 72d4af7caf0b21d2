"""The shared parts of tests/test_torch_tp_training*.py: the training steps
under tensor parallelism against JAX and the unsharded port.

Each case runs two steps of a stage on noise and timesteps drawn here with
numpy (handed to the port's step in place of its own draw), with AdamW and
with 8-bit AdamW, lr 1e-3, Adam eps 1e-4 (tests/test_torch_training.py
gives the reason) and ``MAX_GRAD_NORM`` small enough that the global-norm
clip acts at every step. JAX's reference is one compiled ``value_and_grad``
of the stage's loss at the first draw, then JAX's ``make_optimizer`` update
with the same settings, each optimizer: the parameters after one step. The
second step is held to the port's unsharded run: 8-bit moments enter an
update from the second step on, and the port stores its weights as
[out, in] where JAX stores [in, out], so the two packages' 8-bit blocks
differ there.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from motioneditor_tpu.schedulers import DiffusionSchedule as JaxSchedule
from motioneditor_tpu.schedulers import ddpm_add_noise as jax_add_noise
from motioneditor_tpu.training import common as JT

from motioneditor_tpu_torch.models.from_jax import unet_state_dict
from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state
from torch_port_helpers import normal

LR, ADAM_EPS, MAX_GRAD_NORM = 1e-3, 1e-4, 1e-3
OPTIMIZERS = {"adamw": dict(learning_rate=LR, eps=ADAM_EPS, max_grad_norm=MAX_GRAD_NORM),
              "8bit": dict(learning_rate=LR, eps=ADAM_EPS, max_grad_norm=MAX_GRAD_NORM,
                           use_8bit=True)}
LAYOUTS = [(1, 1, 2), (1, 2, 2)]


def draws(rng, shape, n: int = 2):
    """``n`` (noise, timesteps) pairs at the global latents' ``shape``."""
    return [(torch.from_numpy(normal(rng, shape)),
             torch.from_numpy(rng.integers(0, 1000, (shape[0],)).astype(np.int64)))
            for _ in range(n)]


def jax_first_step(params, modules, loss_fn, draw, lat):
    """{optimizer: the trainables after one JAX step, as the port's names}
    and JAX's loss, at ``draw``; ``loss_fn(trainable, frozen, noisy, t,
    noise)`` is the stage's loss."""
    trainable, frozen = JT.partition_params(params, JT.trainable_mask(params, modules))
    noise, t = (jnp.asarray(x.numpy()) for x in draw)
    noisy = jax_add_noise(JaxSchedule(), jnp.asarray(lat), noise, t)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable, frozen, noisy, t, noise)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, frozen)
    out = {}
    for name, kw in OPTIMIZERS.items():
        opt = JT.make_optimizer(**kw)

        @jax.jit
        def step(trainable, grads):
            updates, _ = opt.update(grads, opt.init(trainable), trainable)
            return optax.apply_updates(trainable, updates)

        out[name] = unet_state_dict(JT.combine_params(step(trainable, grads), zeros))
    return out, float(loss)


def port_steps(unet, module, step, draw_list, out_dir=None):
    """The unsharded port: two steps per optimizer; {optimizer: (losses,
    trainables after each step, the checkpoint's path)}."""
    from motioneditor_tpu_torch.training.checkpoint import save_train_state

    out, draw_noise = {}, module.draw_noise
    try:
        for name, kw in OPTIMIZERS.items():
            state = make_train_state(copy.deepcopy(unet), module.TRAINABLE_MODULES,
                                     make_optimizer(**kw))
            it = iter(draw_list)
            module.draw_noise = lambda *a: next(it)
            losses, params = [], []
            for _ in draw_list:
                state, metrics = step(state)
                losses.append(float(metrics["loss"]))
                params.append({n: p.detach().clone() for n, p in state.trainable.items()})
            path = None if out_dir is None else save_train_state(
                str(out_dir / f"ckpt_{name}"), 2, state)
            out[name] = (losses, params, path)
    finally:
        module.draw_noise = draw_noise
    return out


def check_first_step(rank_out, jax_out, jax_loss):
    """One step against JAX: the loss to 1e-5 relative, every trainable to
    1e-6 (tests/test_torch_training.py's)."""
    for name, got in rank_out.items():
        first = got["steps"][0]
        np.testing.assert_allclose(first["loss"], jax_loss, rtol=1e-5)
        for n, p in first["trainable"].items():
            np.testing.assert_allclose(p.numpy(), jax_out[name][n].numpy(), atol=1e-6,
                                       err_msg=f"{name}: {n}")


def check_against_unsharded(rank_out, port):
    """Both steps against the unsharded port: losses to 1e-5 relative,
    trainables to 1e-6, with the clip acting."""
    for name, got in rank_out.items():
        losses, params, _ = port[name]
        for i, step in enumerate(got["steps"]):
            np.testing.assert_allclose(step["loss"], losses[i], rtol=1e-5)
            assert step["trainable"].keys() == params[i].keys()
            for n, p in params[i].items():
                np.testing.assert_allclose(step["trainable"][n].numpy(), p.numpy(), atol=1e-6,
                                           err_msg=f"{name} step {i + 1}: {n}")


def check_same_bits(ranks):
    """Every rank ends each step with the same full trainables, bit for bit."""
    for rank in ranks[1:]:
        for name, got in rank.items():
            for i, step in enumerate(got["steps"]):
                for n, p in step["trainable"].items():
                    assert torch.equal(p, ranks[0][name]["steps"][i]["trainable"][n]), (name, n)


def check_split(ranks, layout):
    """The model ranks hold blocks of the split trainables: model rank m's
    block is its slice of the full tensor, and the replicated ones whole."""
    tp = layout[2]
    for r, rank in enumerate(ranks):
        m = r % tp
        for name, got in rank.items():
            full = got["steps"][-1]["trainable"]
            split = 0
            for n, block in got["blocks"].items():
                if block.shape == full[n].shape:
                    assert torch.equal(block, full[n]), n
                    continue
                split += 1
                dim = [a != b for a, b in zip(block.shape, full[n].shape)].index(True)
                step = block.shape[dim]
                assert torch.equal(block, full[n].narrow(dim, m * step, step)), n
            assert split > 0 and math.prod(layout) == len(ranks)
