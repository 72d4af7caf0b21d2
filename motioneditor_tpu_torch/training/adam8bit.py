"""Blockwise 8-bit AdamW (port of motioneditor_tpu/training/adam8bit.py).

The reference's ``use_8bit_adam`` (bitsandbytes) keeps the Adam moments in
8 bits. Here, as in the JAX package, each moment is stored in blocks of 256
elements with one fp32 scale per block and dequantized for the update:

  m (signed)    int8 codes, linear max-abs: round(x / (max|x| / 127))
  v (>= 0)      uint8 codes in the sqrt domain, rounded up:
                ceil(255 * sqrt(x / max x)), decoded as (q / 255)^2 * max x

The sqrt code keeps resolution near zero and rounding up biases v high,
so quantization can only shrink an update. Plain PyTorch, no bitsandbytes.
The update is ``optax.chain(scale_by_adam8bit, add_decayed_weights,
scale(-lr))``: decoupled weight decay on every parameter.

A parameter split over a model group (parallel/tp.py) holds one block of
a full tensor, and JAX quantizes the logical array: its blocks of 256 are
those of the full row-major tensor, which a column split cuts across. So
a split moment takes the full layout's scales: each rank reduces its own
elements into the full tensor's blocks (``full_blocks``), one all-reduce
with MAX over the model group gives every rank the full tensor's scales,
and the codes, stored in the parameter's local shape, are the full
tensor's codes of this rank's elements, bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK)


def quantize(x: torch.Tensor, signed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes [nblocks, 256], scales [nblocks, 1] fp32) of ``x``: int8
    max-abs codes when ``signed``, else sqrt-domain uint8 codes rounded up."""
    blocks = _blocks(x)
    if signed:
        scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
        q = torch.round(blocks / torch.clamp(scale, min=1e-30))
        return q.to(torch.int8), scale
    vmax = blocks.amax(dim=-1, keepdim=True)
    u = torch.sqrt(blocks / torch.clamp(vmax, min=1e-30))
    q = torch.clamp(torch.ceil(u * 255.0), 0.0, 255.0)
    return q.to(torch.uint8), vmax


def dequantize(q: torch.Tensor, scale: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The fp32 tensor of ``like``'s shape that the codes stand for."""
    if q.dtype == torch.int8:
        blocks = q.float() * scale
    else:
        u = q.float() / 255.0
        blocks = u * u * scale
    return blocks.reshape(-1)[: like.numel()].reshape(like.shape)


def full_blocks(shape, dim: int, tp: int, index: int, device=None) -> torch.Tensor:
    """The block of the full row-major tensor (``shape`` with dim ``dim``
    times ``tp``) that each element of its block ``index`` along ``dim``
    falls in, in the block's own row-major order: int64 [prod(shape)]."""
    full = list(shape)
    full[dim] *= tp
    flat = torch.arange(math.prod(full), device=device).reshape(full)
    return (flat.narrow(dim, index * shape[dim], shape[dim]).reshape(-1) // BLOCK)


def quantize_split(x: torch.Tensor, signed: bool, blocks: torch.Tensor, nblocks: int,
                   group) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize`` of the full tensor, restricted to this rank's block
    ``x``: (codes of ``x``'s shape, the full tensor's scales [nblocks, 1]).
    ``blocks``: ``full_blocks`` of ``x``; ``group``: the model group."""
    from motioneditor_tpu_torch.parallel.tp import max_over_model

    flat = x.reshape(-1).float()
    mine = torch.zeros(nblocks, device=x.device).scatter_reduce(
        0, blocks, flat.abs() if signed else flat, "amax")
    top = max_over_model(mine, group)[:, None]
    if signed:
        scale = top / 127.0
        q = torch.round(flat / torch.clamp(scale[blocks, 0], min=1e-30))
        return q.to(torch.int8).reshape(x.shape), scale
    u = torch.sqrt(flat / torch.clamp(top[blocks, 0], min=1e-30))
    q = torch.clamp(torch.ceil(u * 255.0), 0.0, 255.0)
    return q.to(torch.uint8).reshape(x.shape), top


def dequantize_split(q: torch.Tensor, scale: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """``quantize_split``'s inverse: fp32 of ``q``'s shape."""
    s = scale[blocks, 0].reshape(q.shape)
    if q.dtype == torch.int8:
        return q.float() * s
    u = q.float() / 255.0
    return u * u * s


def codes_to_full(q: torch.Tensor) -> torch.Tensor:
    """Full-tensor codes ``q`` (the shape of the full tensor) in the
    unsplit state's [nblocks, 256] layout, zero-padded."""
    flat = q.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    return torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, BLOCK)


def codes_from_full(q: torch.Tensor, full_shape) -> torch.Tensor:
    """``codes_to_full``'s inverse: [nblocks, 256] -> ``full_shape``."""
    return q.reshape(-1)[: math.prod(full_shape)].reshape(full_shape)


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with blockwise 8-bit moment state; the step count is shared by
    every parameter, as optax's ``count`` is. ``layout``: {parameter: (split
    dim, model group size, model rank, model group)} of the parameters that
    hold a block of a split tensor, set before each step by
    training/common.py ``ClippedOptimizer.step``; their moments take the
    full tensor's block scales."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.layout = {}
        self._blocks = {}

    def _split_blocks(self, p: torch.Tensor):
        """(``full_blocks`` of ``p``, the full tensor's block count), cached."""
        dim, tp, index, _ = self.layout[p]
        key = (tuple(p.shape), dim, tp, index, p.device)
        if key not in self._blocks:
            self._blocks[key] = (full_blocks(p.shape, dim, tp, index, p.device),
                                 -(-p.numel() * tp // BLOCK))
        return self._blocks[key]

    def load_state_dict(self, state_dict) -> None:
        # the base class casts every state tensor to its parameter's dtype;
        # the codes are integers, exact in fp32, and go back to 8 bits here
        super().load_state_dict(state_dict)
        for st in self.state.values():
            st["m"], st["v"] = st["m"].to(torch.int8), st["v"].to(torch.uint8)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                split = self._split_blocks(p) if p in self.layout else None
                if not st:
                    st["step"] = 0
                    zeros = torch.zeros_like(p, dtype=torch.float32)
                    if split is None:
                        st["m"], st["m_scale"] = quantize(zeros, signed=True)
                        st["v"], st["v_scale"] = quantize(zeros, signed=False)
                    else:  # what quantize_split gives for zeros, without collectives
                        scale = zeros.new_zeros((split[1], 1))
                        st["m"], st["m_scale"] = zeros.to(torch.int8), scale
                        st["v"], st["v_scale"] = zeros.to(torch.uint8), scale.clone()
                st["step"] += 1
                count = st["step"]
                g = p.grad.float()
                if split is None:
                    m_old = dequantize(st["m"], st["m_scale"], g)
                    v_old = dequantize(st["v"], st["v_scale"], g)
                else:
                    m_old = dequantize_split(st["m"], st["m_scale"], split[0])
                    v_old = dequantize_split(st["v"], st["v_scale"], split[0])
                m = b1 * m_old + (1 - b1) * g
                v = b2 * v_old + (1 - b2) * g * g
                mhat = m / (1 - b1 ** count)
                vhat = v / (1 - b2 ** count)
                update = mhat / (torch.sqrt(vhat) + group["eps"]) + group["weight_decay"] * p
                p.add_(update.to(p.dtype), alpha=-group["lr"])
                if split is None:
                    st["m"], st["m_scale"] = quantize(m, signed=True)
                    st["v"], st["v_scale"] = quantize(v, signed=False)
                else:
                    model_group = self.layout[p][3]
                    st["m"], st["m_scale"] = quantize_split(m, True, *split, model_group)
                    st["v"], st["v_scale"] = quantize_split(v, False, *split, model_group)
