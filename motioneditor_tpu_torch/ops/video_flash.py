"""Packed-head video attention and fg/bg injection attention on [B, F, N, C]
(port of motioneditor_tpu/ops/video_flash.py).

Kernels (CUDA C++, ``csrc/video_attention.cu``, one body for both):

  video_flash_attention      replaces _video_flash       (video_flash.py:248)
  video_injection_attention  replaces _video_injection   (video_flash.py:591)

Each takes q/k/v in the native token layout with heads as channel strides
and selects the K/V source frames from its own block index:
normal [f], sparse_causal [0 | f-1], motion_frame [f-1 | f], dense [all],
with f-1 clamped to 0 (frame 0 reads frame 0 twice, keeping the doubled
weight of the reference's concatenated keys).

Softmax: both dtypes use an exact online softmax (running max, fp32). The
JAX bf16 kernels instead clamp scores at 60 with no running max; the two
agree whenever every |logit| < 60, which the on-card bf16 checks assert on
their inputs. Bound on the H100 and design notes: see the .cu source.

Each wrapper takes the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.

Gradients, chosen as the JAX package chooses its VJPs: under autograd the
frame-selection modes go through ``VideoFlashAttentionFn``
(ops/video_flash_bwd.py: the residual-saving forward K4 and the backward
kernels K5/K6, as JAX's ``flash_vjp_attention``); dense mode and the
injection attention run their kernel forward and take the VJP of their
plain version, recomputed in the backward (JAX's ``kernel_with_xla_vjp``,
ops/diffable.py). The kernel's residual-saving forward is taken only when a
gradient is needed: grad mode on and some input requiring grad.
"""

from __future__ import annotations

import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops.attention import (
    DENSE,
    MOTION_FRAME,
    NORMAL,
    SPARSE_CAUSAL,
    merge_heads,
    sdpa,
    split_heads,
)

_MODE_CODES = {NORMAL: 0, SPARSE_CAUSAL: 1, MOTION_FRAME: 2, DENSE: 3}
_INJECTION_CODE = 4
MAX_HEAD_DIM = 160


def video_flash_supported(c: int, heads: int) -> bool:
    """Shapes the kernels take: any token count; head dim a multiple of 8,
    at most 160."""
    if c % heads:
        return False
    d = c // heads
    return d % 8 == 0 and d <= MAX_HEAD_DIM


def _source_frames(mode: str, f: int, num_frames: int):
    prev = max(f - 1, 0)
    if mode == NORMAL:
        return [f]
    if mode == SPARSE_CAUSAL:
        return [0, prev]
    if mode == MOTION_FRAME:
        return [prev, f]
    if mode == DENSE:
        return list(range(num_frames))
    raise ValueError(f"unknown attention mode {mode}")


def video_flash_attention_plain(q, k, v, mode: str, scale: float, heads: int):
    """Plain PyTorch version: per query frame, concatenate the source frames'
    K/V and run ``sdpa`` (one frame's score matrix at a time)."""
    nf = q.shape[1]
    outs = []
    for f in range(nf):
        src = _source_frames(mode, f, nf)
        kf = torch.cat([k[:, g] for g in src], dim=1)
        vf = torch.cat([v[:, g] for g in src], dim=1)
        out = sdpa(split_heads(q[:, f], heads), split_heads(kf, heads),
                   split_heads(vf, heads), scale)
        outs.append(merge_heads(out))
    return torch.stack(outs, dim=1)


def _check_shapes(name, q, heads, *others):
    if q.dim() != 4:
        raise ValueError(f"{name}: expected [B, F, N, C], got {tuple(q.shape)}")
    if not video_flash_supported(q.shape[3], heads):
        raise ValueError(f"{name}: unsupported C={q.shape[3]} with {heads} heads")
    for t in others:
        if t.shape != q.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(q.shape)}")


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class KernelWithPlainVJP(torch.autograd.Function):
    """``kernel_fn(*tensors)`` forward (one tensor or a tuple); the backward
    recomputes ``plain_fn(*tensors)`` under autograd and returns its VJP
    (the port of JAX's ``kernel_with_xla_vjp``, ops/diffable.py)."""

    @staticmethod
    def forward(ctx, kernel_fn, plain_fn, *tensors):
        ctx.plain_fn = plain_fn
        ctx.save_for_backward(*tensors)
        return kernel_fn(*tensors)

    @staticmethod
    def backward(ctx, *douts):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain_fn(*xs)
            outs = out if isinstance(out, tuple) else (out,)
            wrt = [x for x in xs if x.requires_grad]
            grads = iter(torch.autograd.grad(outs, wrt, douts))
        return (None, None, *(next(grads) if n else None for n in need))


def video_flash_attention(q, k, v, mode: str, scale: float, heads: int) -> torch.Tensor:
    """Spatial video attention on [B, F, N, C] with in-kernel head packing
    and frame-selected K/V. Returns q's shape and dtype; differentiable."""
    if q.device.type == "cpu":
        return video_flash_attention_plain(q, k, v, mode, scale, heads)
    name = "video_flash_attention"
    _check_shapes(name, q, heads, k, v)
    _build.check_operands(name, (q, k, v))
    if mode not in _MODE_CODES:
        raise ValueError(f"{name}: unknown mode {mode}")
    if needs_grad(q, k, v):
        if mode == DENSE:
            return KernelWithPlainVJP.apply(
                lambda *t: _video_flash_kernel(*t, mode, scale, heads),
                lambda *t: video_flash_attention_plain(*t, mode, scale, heads), q, k, v)
        from motioneditor_tpu_torch.ops.video_flash_bwd import VideoFlashAttentionFn

        return VideoFlashAttentionFn.apply(q, k, v, mode, scale, heads)
    return _video_flash_kernel(q, k, v, mode, scale, heads)


def _video_flash_kernel(q, k, v, mode, scale, heads):
    name = "video_flash_attention"
    b, f, n, c = q.shape
    out = torch.empty_like(q)
    code = _build.kernels().me_video_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None, out.data_ptr(),
        b, f, n, heads, c // heads, float(scale), _MODE_CODES[mode],
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return out


def video_injection_attention_plain(q_tgt, k_src, v_src, k_tgt, v_tgt, mask, scale: float,
                                    heads: int):
    """Plain PyTorch version: per frame, softmax over the concatenated keys
    [K_src[f-1,f]*m, K_src[f-1,f]*(1-m), K_tgt[f]] with values
    [V_src, V_src, V_tgt]; m is the fg mask of the key's frame."""
    nf = q_tgt.shape[1]
    outs = []
    for f in range(nf):
        src = _source_frames(MOTION_FRAME, f, nf)
        ks = torch.cat([k_src[:, g] for g in src], dim=1)  # [B, 2N, C]
        vs = torch.cat([v_src[:, g] for g in src], dim=1)
        m = torch.cat([mask[g] for g in src], dim=0)[None, :, None].to(ks.dtype)
        k_inj = torch.cat([ks * m, ks * (1.0 - m), k_tgt[:, f]], dim=1)
        v_inj = torch.cat([vs, vs, v_tgt[:, f]], dim=1)
        out = sdpa(split_heads(q_tgt[:, f], heads), split_heads(k_inj, heads),
                   split_heads(v_inj, heads), scale)
        outs.append(merge_heads(out))
    return torch.stack(outs, dim=1)


def video_injection_attention(q_tgt, k_src, v_src, k_tgt, v_tgt, mask, scale: float,
                              heads: int) -> torch.Tensor:
    """Fused fg/bg injection attention of the edit rows on [B, F, N, C];
    ``mask`` is the [F, N] fg mask, indexed by the key's frame.
    Differentiable through the plain version's VJP."""
    if q_tgt.device.type == "cpu":
        return video_injection_attention_plain(
            q_tgt, k_src, v_src, k_tgt, v_tgt, mask, scale, heads)
    name = "video_injection_attention"
    _check_shapes(name, q_tgt, heads, k_src, v_src, k_tgt, v_tgt)
    _build.check_operands(name, (q_tgt, k_src, v_src, k_tgt, v_tgt))
    f, n = q_tgt.shape[1:3]
    if mask.shape != (f, n):
        raise ValueError(f"{name}: mask shape {tuple(mask.shape)} != {(f, n)}")
    mask = mask.to(torch.float32).contiguous()
    _build.check_operands(name, (mask,), dtype=torch.float32)
    args = (q_tgt, k_src, v_src, k_tgt, v_tgt, mask)
    if needs_grad(*args):
        return KernelWithPlainVJP.apply(
            lambda *t: _video_injection_kernel(*t, scale, heads),
            lambda *t: video_injection_attention_plain(*t, scale, heads), *args)
    return _video_injection_kernel(*args, scale, heads)


def _video_injection_kernel(q_tgt, k_src, v_src, k_tgt, v_tgt, mask, scale, heads):
    name = "video_injection_attention"
    b, f, n, c = q_tgt.shape
    out = torch.empty_like(q_tgt)
    code = _build.kernels().me_video_attention(
        q_tgt.data_ptr(), k_src.data_ptr(), v_src.data_ptr(), k_tgt.data_ptr(),
        v_tgt.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, f, n, heads, c // heads, float(scale), _INJECTION_CODE,
        _build.DTYPE_CODES[q_tgt.dtype], _build.stream_handle(q_tgt.device),
    )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return out
