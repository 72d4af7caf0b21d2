"""Backward of the packed-head video attention for the frame-selection modes
(port of motioneditor_tpu/ops/video_flash_bwd.py).

Kernels (CUDA C++):

  video_flash_fwd_res      replaces video_flash_fwd_res  (video_flash_bwd.py:229)
                           csrc/video_attention.cu: K1's body, also writing
                           the log-sum-exp per (query row, head)
  video_flash_bwd  dq      replaces _dq_kernel           (video_flash_bwd.py:403)
  video_flash_bwd  dk/dv   replaces _dkv_kernel          (video_flash_bwd.py:437)
                           csrc/video_attention_bwd.cu

``VideoFlashAttentionFn`` is the autograd Function that
``video_flash_attention`` takes under autograd for the modes normal,
sparse_causal and motion_frame (JAX's ``flash_vjp_attention``): its forward
saves (q, k, v, out, lse), its backward recomputes the probabilities from
lse. dK/dV come from the kernel as per-(target frame, source slot) fp32
partials [B, F, S, N, C]; ``combine_partials`` scatters them onto the source
frames with a few index adds, as JAX's ``_combine_partials`` does outside
its kernels.

The softmax is K1's exact one (no CAP = 60 clamp indicator), so the
gradients are those of the plain version's softmax.

Each wrapper takes the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops.attention import MOTION_FRAME, NORMAL, SPARSE_CAUSAL
from motioneditor_tpu_torch.ops.video_flash import (
    _MODE_CODES,
    _check_shapes,
    _source_frames,
    video_flash_attention_plain,
)

BWD_MODES = (NORMAL, SPARSE_CAUSAL, MOTION_FRAME)


def num_slots(mode: str) -> int:
    """Source frames per target frame: 1 for normal, 2 otherwise."""
    return 1 if mode == NORMAL else 2


def _check_mode(name: str, mode: str) -> None:
    if mode not in BWD_MODES:
        raise ValueError(f"{name}: mode must be one of {BWD_MODES}, got {mode}")


def _per_frame(q, k, v, f: int, mode: str, heads: int):
    """fp32 per-head q [B, H, N, d] and the concatenated source K/V
    [B, H, S*N, d] of target frame ``f``."""
    b, nf, n, c = q.shape
    src = _source_frames(mode, f, nf)

    def heads_of(x):
        return x.float().reshape(b, -1, heads, c // heads).transpose(1, 2)

    kf = torch.cat([k[:, g] for g in src], dim=1)
    vf = torch.cat([v[:, g] for g in src], dim=1)
    return src, heads_of(q[:, f]), heads_of(kf), heads_of(vf)


def _merge(x):
    """[B, H, N, d] -> [B, N, H*d]"""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def video_flash_fwd_res_plain(q, k, v, mode: str, scale: float, heads: int):
    """Plain PyTorch version: (out, lse), lse the fp32 natural-log
    log-sum-exp of the scaled scores, [B, F, N, H]."""
    _check_mode("video_flash_fwd_res_plain", mode)
    lses = []
    for f in range(q.shape[1]):
        _, qh, kh, _ = _per_frame(q, k, v, f, mode, heads)
        s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
        lses.append(torch.logsumexp(s, dim=-1).transpose(1, 2))  # [B, N, H]
    out = video_flash_attention_plain(q, k, v, mode, scale, heads)
    return out, torch.stack(lses, dim=1)


def video_flash_bwd_plain(q, k, v, out, lse, do, mode: str, scale: float, heads: int):
    """Plain PyTorch version of the flash backward, frame by frame in fp32:
    P = exp(S - lse), D = rowsum(dO o O), dS = P o (dO V^T - D),
    dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO, with each source
    frame's share of dK/dV added onto that frame. Returns (dq, dk, dv) in
    the dtypes of q, k, v."""
    _check_mode("video_flash_bwd_plain", mode)
    b, nf, n, c = q.shape
    d = c // heads
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for f in range(nf):
        src, qh, kh, vh = _per_frame(q, k, v, f, mode, heads)
        gh = do[:, f].float().reshape(b, n, heads, d).transpose(1, 2)
        oh = out[:, f].float().reshape(b, n, heads, d).transpose(1, 2)
        p = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale
                      - lse[:, f].transpose(1, 2)[..., None])
        delta = (gh * oh).sum(-1, keepdim=True)
        ds = p * (torch.matmul(gh, vh.transpose(-1, -2)) - delta)
        dq[:, f] = _merge(scale * torch.matmul(ds, kh))
        dk_f = _merge(scale * torch.matmul(ds.transpose(-1, -2), qh))
        dv_f = _merge(torch.matmul(p.transpose(-1, -2), gh))
        for slot, g in enumerate(src):
            dk[:, g] += dk_f[:, slot * n:(slot + 1) * n]
            dv[:, g] += dv_f[:, slot * n:(slot + 1) * n]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def combine_partials(p: torch.Tensor, mode: str) -> torch.Tensor:
    """Scatter per-(target frame, source slot) partials [B, F, S, N, C] onto
    the source frames [B, F, N, C] (the inverse of the forward's K/V frame
    selection; JAX ``_combine_partials``, video_flash_bwd.py:510-527)."""
    if mode == NORMAL:
        return p[:, :, 0]
    if mode == MOTION_FRAME:
        # slot 1 = the target frame itself; slot 0 = prev: f -> max(f-1, 0)
        g = p[:, :, 1].clone()
        g[:, 0] += p[:, 0, 0]
        g[:, :-1] += p[:, 1:, 0]
        return g
    if mode == SPARSE_CAUSAL:
        # slot 0 = frame 0 for every target; slot 1 = prev
        g = torch.zeros_like(p[:, :, 0])
        g[:, 0] += p[:, :, 0].sum(dim=1)
        g[:, 0] += p[:, 0, 1]
        g[:, :-1] += p[:, 1:, 1]
        return g
    raise ValueError(f"combine_partials: unknown mode {mode}")


def video_flash_fwd_res(q, k, v, mode: str, scale: float, heads: int):
    """K1's forward plus the fp32 log-sum-exp [B, F, N, H] of every
    (query row, head): the residuals of the backward."""
    if q.device.type == "cpu":
        return video_flash_fwd_res_plain(q, k, v, mode, scale, heads)
    name = "video_flash_fwd_res"
    _check_mode(name, mode)
    _check_shapes(name, q, heads, k, v)
    _build.check_operands(name, (q, k, v))
    b, f, n, c = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, f, n, heads), dtype=torch.float32, device=q.device)
    code = _build.kernels().me_video_attention_fwd_res(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, f, n, heads, c // heads, float(scale), _MODE_CODES[mode],
        _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device),
    )
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return out, lse


def _bwd_args(name, q, k, v, lse, heads, mode, scale, *others):
    _check_mode(name, mode)
    _check_shapes(name, q, heads, k, v, *others)
    _build.check_operands(name, (q, k, v, *others))
    b, f, n, c = q.shape
    if lse.shape != (b, f, n, heads):
        raise ValueError(f"{name}: lse shape {tuple(lse.shape)} != {(b, f, n, heads)}")
    _build.check_operands(name, (lse,), dtype=torch.float32)
    return (b, f, n, heads, c // heads, float(scale), _MODE_CODES[mode],
            _build.DTYPE_CODES[q.dtype], _build.stream_handle(q.device))


def video_flash_bwd_dq(q, k, v, out, lse, do, mode: str, scale: float, heads: int):
    """The dq kernel (CUDA tensors only): returns dq and
    delta = rowsum(dO o O) [B, F, N, H] fp32, which the dk/dv kernel reads."""
    name = "video_flash_bwd_dq"
    args = _bwd_args(name, q, k, v, lse, heads, mode, scale, out, do)
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q)
    code = _build.kernels().me_video_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *args)
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return dq, delta


def video_flash_bwd_dkv(q, k, v, lse, delta, do, mode: str, scale: float, heads: int):
    """The dk/dv kernel (CUDA tensors only): fp32 partials [B, F, S, N, C]
    of dk and dv per (target frame, source slot), for combine_partials."""
    name = "video_flash_bwd_dkv"
    args = _bwd_args(name, q, k, v, lse, heads, mode, scale, do)
    _build.check_operands(name, (delta,), dtype=torch.float32)
    if delta.shape != lse.shape:
        raise ValueError(f"{name}: delta shape {tuple(delta.shape)} != {tuple(lse.shape)}")
    b, f, n, c = q.shape
    dkp = torch.empty((b, f, num_slots(mode), n, c), dtype=torch.float32, device=q.device)
    dvp = torch.empty_like(dkp)
    code = _build.kernels().me_video_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dkp.data_ptr(), dvp.data_ptr(), *args)
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    return dkp, dvp


def video_flash_bwd(q, k, v, out, lse, do, mode: str, scale: float, heads: int):
    """(dq, dk, dv) of ``video_flash_attention`` from the forward's
    residuals (out, lse) and the output gradient ``do``: dq from the dq
    kernel, dk/dv from the dk/dv kernel's partials and combine_partials."""
    if q.device.type == "cpu":
        return video_flash_bwd_plain(q, k, v, out, lse, do, mode, scale, heads)
    dq, delta = video_flash_bwd_dq(q, k, v, out, lse, do, mode, scale, heads)
    dkp, dvp = video_flash_bwd_dkv(q, k, v, lse, delta, do, mode, scale, heads)
    dk = combine_partials(dkp, mode).to(k.dtype)
    del dkp
    return dq, dk, combine_partials(dvp, mode).to(v.dtype)


class VideoFlashAttentionFn(torch.autograd.Function):
    """video_flash_attention with the flash backward: the forward saves
    (q, k, v, out, lse) from ``video_flash_fwd_res``, the backward runs
    ``video_flash_bwd``. CUDA tensors launch the kernels; CPU tensors take
    their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, mode: str, scale: float, heads: int):
        out, lse = video_flash_fwd_res(q, k, v, mode, scale, heads)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mode, scale, heads)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = video_flash_bwd(q, k, v, out, lse, dout.to(q.dtype).contiguous(), *ctx.args)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None)
