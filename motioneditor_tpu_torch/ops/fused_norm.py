"""Fused residual add + LayerNorm (port of motioneditor_tpu/ops/fused_norm.py).

Kernel (CUDA C++, ``csrc/add_layer_norm.cu``):

  add_layer_norm   replaces _add_ln   (fused_norm.py:73)

``(summed, normed) = (tokens + delta, LayerNorm(tokens + delta))`` over the
channel axis of [B, F, N, C], the transformer block's residual add and the
norm that follows it, in one pass. The kernel normalizes the fp32 sum; the
plain version re-reads the sum rounded to the input dtype, as the JAX
package's unfused path does, so the two differ by that rounding in bf16.

Off by default, as in the JAX package: ``MOTIONEDITOR_FUSED_LN=1`` turns it
on, read at each call. Under autograd the kernel's forward runs with the
plain version's VJP (``KernelWithPlainVJP``, the port of JAX's
``kernel_with_xla_vjp``). The wrapper takes the plain version only for CPU
tensors; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.models.layers import layer_norm_affine
from motioneditor_tpu_torch.ops.video_flash import KernelWithPlainVJP, needs_grad
from motioneditor_tpu_torch.utils.runtime import env_flag

MAX_CHANNELS = 1280


def enabled() -> bool:
    return env_flag("MOTIONEDITOR_FUSED_LN", False)


def add_layer_norm_plain(tokens, delta, weight, bias, eps: float = 1e-5):
    """Plain PyTorch version: the add, then ``layer_norm`` of the sum."""
    summed = tokens + delta
    return summed, layer_norm_affine(summed, weight, bias, eps)


def add_layer_norm(norm, tokens: torch.Tensor, delta: torch.Tensor, eps: float = 1e-5):
    """(tokens + delta, LayerNorm(tokens + delta)) over [B, F, N, C], with the
    LayerNorm module ``norm``'s weight and bias; differentiable."""
    w, b = norm.weight, norm.bias
    if tokens.device.type == "cpu":
        return add_layer_norm_plain(tokens, delta, w, b, eps)
    name = "add_layer_norm"
    if tokens.dim() != 4 or delta.shape != tokens.shape:
        raise ValueError(f"{name}: expected two [B, F, N, C] tensors, got "
                         f"{tuple(tokens.shape)}, {tuple(delta.shape)}")
    if tokens.shape[-1] > MAX_CHANNELS or w.shape != (tokens.shape[-1],):
        raise ValueError(f"{name}: unsupported C={tokens.shape[-1]} or weight "
                         f"{tuple(w.shape)}")
    tokens, delta = tokens.contiguous(), delta.contiguous()
    _build.check_operands(name, (tokens, delta))
    if needs_grad(tokens, delta, w, b):
        return KernelWithPlainVJP.apply(
            lambda *t: _add_layer_norm_kernel(*t, eps),
            lambda *t: add_layer_norm_plain(*t, eps), tokens, delta, w, b)
    return _add_layer_norm_kernel(tokens, delta, w, b, eps)


def _add_layer_norm_kernel(tokens, delta, w, b, eps):
    name = "add_layer_norm"
    wf, bf = w.float().contiguous(), b.float().contiguous()
    _build.check_operands(name, (wf, bf), dtype=torch.float32)
    summed, normed = torch.empty_like(tokens), torch.empty_like(tokens)
    c = tokens.shape[-1]
    code = _build.kernels().me_add_layer_norm(
        tokens.data_ptr(), delta.data_ptr(), wf.data_ptr(), bf.data_ptr(), summed.data_ptr(),
        normed.data_ptr(), tokens.numel() // c, c, float(eps),
        _build.DTYPE_CODES[tokens.dtype], _build.stream_handle(tokens.device))
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return summed, normed
