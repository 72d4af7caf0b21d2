"""Shared training machinery: trainable-parameter selection, the optimizer,
the train state (port of motioneditor_tpu/training/common.py).

The reference freezes everything and re-enables the modules whose name ends
with an entry of ``trainable_modules`` (stage 1: attn1.to_q, attn2.to_q,
attn_temp) or contains "controlnet_adapter" (stage 2). Here the same
selection runs over ``named_parameters()``: a parameter's module path is
its name less the leaf.

The optimizer is the JAX package's ``optax.chain(clip_by_global_norm,
adamw)``: gradients are clipped to a global norm as optax does (scaled by
max_norm / norm when norm >= max_norm, with no epsilon), then stepped by
``torch.optim.AdamW``, whose weight decay is decoupled and applies to every
trainable parameter, biases included, as optax's does; or by the 8-bit
AdamW of training/adam8bit.py.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn


def module_path(name: str) -> str:
    """Drop the leaf parameter name (weight / bias) -> module path."""
    return name.rsplit(".", 1)[0] if "." in name else name


def matches(name: str, trainable_modules: Sequence[str]) -> bool:
    """True when the parameter's module path ends with a pattern or contains
    it as a dotted segment ('attn_temp' unfreezes the whole attn_temp
    subtree)."""
    mp = module_path(name)
    return any(mp.endswith(pat) or ("." + pat + ".") in ("." + mp + ".")
               for pat in trainable_modules)


def trainable_mask(model: nn.Module, trainable_modules: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: trainable} over ``model.named_parameters()``."""
    return {name: matches(name, trainable_modules) for name, _ in model.named_parameters()}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place as ``optax.clip_by_global_norm`` does:
    unchanged when their global norm is below ``max_norm``, else each
    ``g / norm * max_norm``. Returns the norm before clipping. Runs on the
    device without a host synchronization."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(grads)
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


class ClippedOptimizer:
    """Global-norm clipping, then the inner optimizer's step: the port of
    ``optax.chain(clip_by_global_norm(max_grad_norm), inner)``."""

    def __init__(self, inner: torch.optim.Optimizer, max_grad_norm: float):
        self.inner = inner
        self.max_grad_norm = max_grad_norm

    def params(self) -> List[torch.Tensor]:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def step(self) -> torch.Tensor:
        """Clip and step; returns the gradients' global norm before clipping.
        A trainable that the loss does not reach gets a zero gradient, so it
        still takes the weight decay, as every leaf of an optax update does
        (e.g. the adapter's ``attn_temp`` in stage 1)."""
        for p in self.params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_(self.params(), self.max_grad_norm)
        self.inner.step()
        return norm

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state) -> None:
        self.inner.load_state_dict(state)


def _build_optimizer(params, learning_rate, beta1, beta2, eps, weight_decay, max_grad_norm,
                     use_8bit) -> ClippedOptimizer:
    params = list(params)
    if use_8bit:
        from motioneditor_tpu_torch.training.adam8bit import AdamW8bit

        inner = AdamW8bit(params, lr=learning_rate, betas=(beta1, beta2), eps=eps,
                          weight_decay=weight_decay)
    else:
        inner = torch.optim.AdamW(params, lr=learning_rate, betas=(beta1, beta2), eps=eps,
                                  weight_decay=weight_decay)
    return ClippedOptimizer(inner, max_grad_norm)


def make_optimizer(
    learning_rate: float = 3e-5,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-2,
    max_grad_norm: float = 1.0,
    use_8bit: bool = False,
) -> Callable[[Iterable[torch.Tensor]], ClippedOptimizer]:
    """AdamW + global-norm clipping (train_bg.py:202-208, :347-352), as a
    function of the parameters it will step (the port of the optax
    transformation, which ``make_train_state`` initializes). ``use_8bit``
    takes the blockwise 8-bit moments of training/adam8bit.py."""
    return functools.partial(
        _build_optimizer, learning_rate=learning_rate, beta1=beta1, beta2=beta2, eps=eps,
        weight_decay=weight_decay, max_grad_norm=max_grad_norm, use_8bit=use_8bit)


@dataclasses.dataclass
class TrainState:
    """The model (trainables fp32 with ``requires_grad``, the rest frozen),
    its optimizer over the trainables, and the number of steps taken. The
    train steps update it in place."""

    step: int
    model: nn.Module
    optimizer: ClippedOptimizer
    trainable: Dict[str, nn.Parameter]


def make_train_state(model: nn.Module, trainable_modules: Sequence[str],
                     optimizer: Callable[[Iterable[torch.Tensor]], ClippedOptimizer],
                     frozen_dtype: Optional[torch.dtype] = None) -> TrainState:
    """Freeze every parameter but the trainables, keep the trainables as fp32
    masters, store the frozen ones in ``frozen_dtype`` (e.g. bf16: the
    memory half of mixed-precision training), and build the optimizer over
    the trainables. The layers cast parameters to the activation dtype at
    use, so gradients reach the fp32 masters through those casts."""
    mask = trainable_mask(model, trainable_modules)
    trainable = {}
    for name, p in model.named_parameters():
        if mask[name]:
            p.data = p.data.float()
            trainable[name] = p
        elif frozen_dtype is not None:
            p.data = p.data.to(frozen_dtype)
        p.requires_grad_(mask[name])
    return TrainState(step=0, model=model, optimizer=optimizer(trainable.values()),
                      trainable=trainable)


def draw_noise(latents: torch.Tensor, generator: torch.Generator, num_train_timesteps: int):
    """The noise (latents' shape and dtype) and one timestep per batch row in
    [0, num_train_timesteps) of one training step, drawn from ``generator``."""
    noise = torch.randn(latents.shape, generator=generator, device=latents.device,
                        dtype=latents.dtype)
    t = torch.randint(0, num_train_timesteps, (latents.shape[0],), generator=generator,
                      device=latents.device)
    return noise, t


def diffusion_target(schedule, latents, noise, timesteps, prediction_type: str):
    """The regression target of the denoising loss."""
    from motioneditor_tpu_torch.schedulers import ddpm_velocity

    if prediction_type == "epsilon":
        return noise
    if prediction_type == "v_prediction":
        return ddpm_velocity(schedule, latents, noise, timesteps)
    raise ValueError(prediction_type)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred.float() - target.float()) ** 2).mean()
