"""Temporal self-attention over the frame axis on [B, F, N, C]
(port of motioneditor_tpu/ops/temporal_flash.py).

Kernels (CUDA C++):

  temporal_flash_attention      replaces _temporal_4d      (temporal_flash.py:208)
                                csrc/temporal_attention.cu
  temporal_flash_attention_bwd  replaces _temporal_4d_bwd  (temporal_flash.py:190)
                                csrc/temporal_attention_bwd.cu
  temporal_flash_attention_global
                                replaces _temporal_4d_bias (temporal_flash.py:361)
                                csrc/temporal_attention.cu (K3's body)

Every spatial site and head is an independent length-F sequence; the
kernel keeps the native layout (no transpose, no head split, no [.., F, F]
score tensor in device memory), computes the softmax in fp32 for any input
dtype, and never computes the causal pairs g > f. Bound on the H100 and
design notes: see the .cu source.

Under autograd a CUDA call goes through ``TemporalFlashAttentionFn``, the
port of JAX's custom VJP (temporal_flash.py:286-305): the forward kernel
saves only (q, k, v) and the fused backward kernel recomputes the scores.

``temporal_flash_attention_global`` is the frame-sharded variant: q holds
the Fq local frames [q_offset, q_offset + Fq) of a shard, K/V all Fk
gathered frames, and the causal mask holds at global frame indices. It
takes the VJP of its plain version, as JAX's does (``kernel_with_xla_vjp``).

Each wrapper takes the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from motioneditor_tpu_torch import _build

MAX_FRAMES = 32
MAX_HEAD_DIM = 160


def temporal_flash_supported(f: int, c: int, heads: int) -> bool:
    if c % heads:
        return False
    d = c // heads
    return d % 8 == 0 and d <= MAX_HEAD_DIM and 1 <= f <= MAX_FRAMES


def temporal_flash_attention_plain(q, k, v, scale: float, heads: int, causal: bool = True):
    """Plain PyTorch version: fp32 scores over frame pairs, -inf above the
    diagonal when causal, fp32 softmax, P.V in the value dtype."""
    b, f, n, c = q.shape
    d = c // heads
    q5 = q.reshape(b, f, n, heads, d).float()
    k5 = k.reshape(b, f, n, heads, d).float()
    v5 = v.reshape(b, f, n, heads, d)
    s = torch.einsum("bfnhd,bgnhd->bnhfg", q5, k5) * scale
    if causal:
        keep = torch.tril(torch.ones((f, f), dtype=torch.bool, device=q.device))
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bnhfg,bgnhd->bfnhd", p, v5)
    return out.reshape(b, f, n, c)


def temporal_flash_attention_bwd_plain(q, k, v, do, scale: float, heads: int,
                                       causal: bool = True):
    """Plain PyTorch version of the backward, in fp32: P the softmax of the
    forward, dS = P o (dP - rowsum(P o dP)), dP = dO V^T; returns
    (dq, dk, dv) = (scale dS K, scale dS^T Q, P^T dO) in the input dtypes."""
    b, f, n, c = q.shape
    d = c // heads
    q5, k5, v5, g5 = (t.reshape(b, f, n, heads, d).float() for t in (q, k, v, do))
    s = torch.einsum("bfnhd,bgnhd->bnhfg", q5, k5) * scale
    if causal:
        keep = torch.tril(torch.ones((f, f), dtype=torch.bool, device=q.device))
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bfnhd,bgnhd->bnhfg", g5, v5)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bnhfg,bgnhd->bfnhd", ds, k5)
    dk = torch.einsum("bnhfg,bfnhd->bgnhd", ds, q5)
    dv = torch.einsum("bnhfg,bfnhd->bgnhd", p, g5)
    return tuple(t.reshape(b, f, n, c).to(x.dtype) for t, x in ((dq, q), (dk, k), (dv, v)))


def _check(name, q, heads, *others):
    if q.dim() != 4 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{name}: operands must share one [B, F, N, C] shape")
    b, f, n, c = q.shape
    if not temporal_flash_supported(f, c, heads):
        raise ValueError(f"{name}: unsupported F={f}, C={c}, heads={heads}")
    _build.check_operands(name, (q, *others))


def temporal_flash_attention(q, k, v, scale: float, heads: int,
                             causal: bool = True) -> torch.Tensor:
    """Temporal attention over [B, F, N, C] in the native token layout;
    differentiable."""
    if q.device.type == "cpu":
        return temporal_flash_attention_plain(q, k, v, scale, heads, causal)
    _check("temporal_flash_attention", q, heads, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return TemporalFlashAttentionFn.apply(q, k, v, scale, heads, causal)
    return _temporal_kernel(q, k, v, scale, heads, causal)


def _temporal_kernel(q, k, v, scale, heads, causal):
    name = "temporal_flash_attention"
    b, f, n, c = q.shape
    out = torch.empty_like(q)
    code = _build.kernels().me_temporal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, f, n, heads, c // heads, float(scale), int(causal),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return out


def temporal_flash_attention_bwd(q, k, v, do, scale: float, heads: int, causal: bool = True):
    """(dq, dk, dv) of temporal_flash_attention for the output gradient
    ``do``, recomputing the scores from (q, k, v)."""
    if q.device.type == "cpu":
        return temporal_flash_attention_bwd_plain(q, k, v, do, scale, heads, causal)
    name = "temporal_flash_attention_bwd"
    _check(name, q, heads, k, v, do)
    b, f, n, c = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    code = _build.kernels().me_temporal_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, f, n, heads, c // heads, float(scale), int(causal),
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return dq, dk, dv


class TemporalFlashAttentionFn(torch.autograd.Function):
    """temporal_flash_attention with its fused backward: the forward saves
    (q, k, v) only. CUDA tensors launch the kernels; CPU tensors take their
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, heads: int, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, heads, causal)
        if q.device.type == "cpu":
            return temporal_flash_attention_plain(q, k, v, scale, heads, causal)
        return _temporal_kernel(q, k, v, scale, heads, causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        grads = temporal_flash_attention_bwd(q, k, v, dout.to(q.dtype).contiguous(), *ctx.args)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None)


def temporal_flash_attention_global_plain(q, k, v, scale: float, heads: int, causal: bool,
                                          q_offset: int):
    """Plain PyTorch version: fp32 scores of the Fq local query frames
    against all Fk frames, pair (f, g) kept iff g <= f + q_offset when
    causal, fp32 softmax, P.V in the value dtype."""
    b, fq, n, c = q.shape
    fk = k.shape[1]
    d = c // heads
    q5 = q.reshape(b, fq, n, heads, d).float()
    k5 = k.reshape(b, fk, n, heads, d).float()
    v5 = v.reshape(b, fk, n, heads, d)
    s = torch.einsum("bfnhd,bgnhd->bnhfg", q5, k5) * scale
    if causal:
        g = torch.arange(fk, device=q.device)
        f = torch.arange(fq, device=q.device) + q_offset
        s = s.masked_fill(g[None, :] > f[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bnhfg,bgnhd->bfnhd", p, v5)
    return out.reshape(b, fq, n, c)


def temporal_flash_attention_global(q, k, v, scale: float, heads: int, causal: bool,
                                    q_offset: int) -> torch.Tensor:
    """Temporal attention of the local frames q [B, Fq, N, C], global frames
    [q_offset, q_offset + Fq), over all frames k, v [B, Fk, N, C]; causal at
    global frame indices. Differentiable through the plain version's VJP."""
    from motioneditor_tpu_torch.ops.video_flash import KernelWithPlainVJP, needs_grad

    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return temporal_flash_attention_global_plain(q, k, v, scale, heads, causal, q_offset)
    name = "temporal_flash_attention_global"
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and K/V {tuple(k.shape)} do not fit")
    if not temporal_flash_supported(k.shape[1], q.shape[3], heads) or q_offset < 0:
        raise ValueError(f"{name}: unsupported Fk={k.shape[1]}, C={q.shape[3]}, heads={heads}, "
                         f"q_offset={q_offset}")
    _build.check_operands(name, (q, k, v))
    if needs_grad(q, k, v):
        return KernelWithPlainVJP.apply(
            lambda *t: _temporal_global_kernel(*t, scale, heads, causal, q_offset),
            lambda *t: temporal_flash_attention_global_plain(*t, scale, heads, causal,
                                                             q_offset), q, k, v)
    return _temporal_global_kernel(q, k, v, scale, heads, causal, q_offset)


def _temporal_global_kernel(q, k, v, scale, heads, causal, q_offset):
    name = "temporal_flash_attention_global"
    b, fq, n, c = q.shape
    out = torch.empty_like(q)
    code = _build.kernels().me_temporal_attention_global(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, fq, k.shape[1], n, heads, c // heads, float(scale), int(causal), q_offset,
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return out
