"""Split-head flash attention on [..., H, N, D]
(port of motioneditor_tpu/ops/flash_attention.py).

Kernel (CUDA C++), two bodies chosen by ``tensor_core_body`` from the
dtype, the head dim and the operands' alignment:

  flash_attention   replaces _flash_3d (flash_attention.py:222)
    bf16, d % 8 == 0, d <= 160, every row 16-byte aligned: the tensor-core
    body ``csrc/attention_tc.cu`` (also counted as ``flash_attention.tc``);
    else ``csrc/split_attention.cu`` (fp32, d = 9, d up to 256).

``launch_split_attention`` also launches the split-head injection kernel of
ops/injection_flash.py (K9) by the same rule, where no K/V view is
broadcast over the lead dims: its tensor-core body is the injection
instantiation of ``csrc/attention_tc.cu`` (``me_split_injection_tc``, also
counted as ``fused_injection_attention.tc``), its other body
``csrc/split_attention.cu``.

It is reached through ``sdpa(..., use_flash=True)`` at ``q.shape[-2] >=
_FLASH_MIN_Q`` with no bias (ops/attention.py), as in JAX: on the main path
by the auto-mask injection (control/injection.py), else at the split-head
fallbacks of the packed-head call sites, which run only for head dims the
packed kernels decline.

The kernel reads every operand through its strides, so the head-split views
of a packed [..., N, H*D] tensor go in without a copy, and it writes its
result in the packed order: the [..., H, N, D] tensor it returns is a view
of a contiguous [..., N, H, D] one, so ``merge_heads`` of it copies nothing.
Head dims up to 256; exact online softmax for both dtypes (the JAX bf16
kernel clamps scores at 60 with no running max; the two agree whenever
every |logit| < 60, which the on-card bf16 checks assert).

The wrapper takes the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises. Under autograd the kernel forward is
paired with the plain version's VJP, as JAX pairs it through
``kernel_with_xla_vjp`` (flash_attention.py:308).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops import flop_count
from motioneditor_tpu_torch.ops.attention import sdpa
from motioneditor_tpu_torch.ops.video_flash import (
    KernelWithPlainVJP,
    needs_grad,
    rows_aligned,
    tensor_core_body,
)

MAX_HEAD_DIM = 256
_FLASH_CODE, _INJECTION_CODE = 0, 1


def flash_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores and softmax, then P.V in the value
    dtype (``sdpa``'s plain form)."""
    return sdpa(q, k, v, scale)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., H, N, D] as a [G, H, N, D] tensor whose rows are
    contiguous; a view of ``x`` where its strides allow, else a copy."""
    x = x.reshape(-1, *x.shape[-3:])
    return x if x.stride(-1) == 1 else x.contiguous()


def _strides(*views) -> ctypes.Array:
    return (ctypes.c_longlong * (3 * len(views)))(*(s for x in views for s in x.stride()[:3]))


def launch_split_attention(name: str, mode: int, q, k, v, scale: float, k2=None, v2=None,
                           mask: Optional[torch.Tensor] = None, frames: int = 1):
    """Launch K8 or K9 on [..., H, N, D] operands (K/V may broadcast over q's
    lead dims) and count the launch under ``name``: on the tensor-core body
    where ``tensor_core_body`` says so and, for K9, no K/V view has a lead
    stride of 0 (its injection instantiation reads K/V group g for query
    group g), counted again under ``name + ".tc"``; else
    csrc/split_attention.cu. The whole rule: a failed launch raises and is
    never retried on the other body. Returns q's shape and dtype."""
    *lead, h, nq, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM}")
    kv = [t.expand(*lead, *t.shape[-3:]) for t in (k, v, k2, v2) if t is not None]
    for t in kv:
        if t.shape[-3] != h or t.shape[-1] != d:
            raise ValueError(f"{name}: K/V shape {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    q4, *kv4 = (_rows(t) for t in (q, *kv))
    _build.check_operands(name, (q4, *kv4), contiguous=False)
    if kv4[0].shape[-2] != kv4[1].shape[-2] or (k2 is not None
                                                and kv4[2].shape[-2] != kv4[3].shape[-2]):
        raise ValueError(f"{name}: keys and values differ in length")
    out = torch.empty((*lead, nq, h, d), dtype=q.dtype, device=q.device)
    out4 = out.view(-1, nq, h, d).transpose(1, 2)  # [G, H, N, D] over the packed order
    lib, stream = _build.kernels(), _build.stream_handle(q.device)
    tc = (tensor_core_body(q.dtype, d, rows_aligned(q4, *kv4, out4))
          and (mode == _FLASH_CODE or all(t.stride(0) != 0 for t in kv4)))
    if tc and mode == _INJECTION_CODE:
        code = lib.me_split_injection_tc(
            q4.data_ptr(), *(t.data_ptr() for t in kv4), mask.data_ptr(), out.data_ptr(),
            _strides(q4, *kv4, out4), q4.shape[0], h, nq, kv4[0].shape[-2], kv4[2].shape[-2],
            frames, d, float(scale), stream)
    elif tc:
        code = lib.me_split_attention_tc(
            q4.data_ptr(), kv4[0].data_ptr(), kv4[1].data_ptr(), out.data_ptr(),
            _strides(q4, kv4[0], kv4[1], out4), q4.shape[0], h, nq, kv4[0].shape[-2], d,
            float(scale), stream)
    else:
        k2_4, v2_4 = (kv4[0], kv4[0]) if k2 is None else (kv4[2], kv4[3])
        code = lib.me_split_attention(
            q4.data_ptr(), kv4[0].data_ptr(), kv4[1].data_ptr(), k2_4.data_ptr(), v2_4.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            _strides(q4, kv4[0], kv4[1], k2_4, v2_4, out4),
            q4.shape[0], h, nq, kv4[0].shape[-2], 0 if k2 is None else k2_4.shape[-2], frames,
            d, float(scale), mode, _build.DTYPE_CODES[q.dtype], stream,
        )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    if tc:
        _build.launch_counts[name + ".tc"] += 1
    return out.movedim(-2, -3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over [..., H, N, D]; K/V [..., H, Nk, D] may broadcast
    over q's lead dims. Returns q's shape and dtype; differentiable."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # 4 prod(lead) nq kv_len d
    flop_count.add_kernel_flops(4 * q.numel() * k.shape[-2], "flash_attention")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if needs_grad(q, k, v):
        return KernelWithPlainVJP.apply(
            lambda *t: _flash_kernel(*t, scale),
            lambda *t: flash_attention_plain(*t, scale), q, k, v)
    return _flash_kernel(q, k, v, scale)


def _flash_kernel(q, k, v, scale):
    return launch_split_attention("flash_attention", _FLASH_CODE, q, k, v, scale)
