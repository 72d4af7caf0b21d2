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
"""

from __future__ import annotations

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


class AdamW8bit(torch.optim.Optimizer):
    """AdamW with blockwise 8-bit moment state; the step count is shared by
    every parameter, as optax's ``count`` is."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

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
                if not st:
                    st["step"] = 0
                    zeros = torch.zeros_like(p, dtype=torch.float32)
                    st["m"], st["m_scale"] = quantize(zeros, signed=True)
                    st["v"], st["v_scale"] = quantize(zeros, signed=False)
                st["step"] += 1
                count = st["step"]
                g = p.grad.float()
                m = b1 * dequantize(st["m"], st["m_scale"], g) + (1 - b1) * g
                v = b2 * dequantize(st["v"], st["v_scale"], g) + (1 - b2) * g * g
                mhat = m / (1 - b1 ** count)
                vhat = v / (1 - b2 ** count)
                update = mhat / (torch.sqrt(vhat) + group["eps"]) + group["weight_decay"] * p
                p.add_(update.to(p.dtype), alpha=-group["lr"])
                st["m"], st["m_scale"] = quantize(m, signed=True)
                st["v"], st["v_scale"] = quantize(v, signed=False)
