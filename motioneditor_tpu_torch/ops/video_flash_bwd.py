"""Backward of the packed-head video attention for the frame-selection modes
(port of motioneditor_tpu/ops/video_flash_bwd.py).

Kernels (CUDA C++):

  video_flash_fwd_res      replaces video_flash_fwd_res  (video_flash_bwd.py:229)
                           K1's body, also writing the log-sum-exp per
                           (query row, head): csrc/video_attention.cu; in
                           bf16 csrc/attention_tc.cu (tensor cores)
  video_flash_bwd  dq      replaces _dq_kernel           (video_flash_bwd.py:403)
                           csrc/video_attention_bwd.cu; in bf16 with d <= 80
                           csrc/attention_dq_tc.cu (tensor cores)
  video_flash_bwd  dk/dv   replaces _dkv_kernel          (video_flash_bwd.py:437)
                           csrc/video_attention_bwd.cu; in bf16 with d <= 80
                           csrc/attention_bwd_tc.cu (tensor cores)

``VideoFlashAttentionFn`` is the autograd Function that
``video_flash_attention`` takes under autograd for the modes normal,
sparse_causal and motion_frame (JAX's ``flash_vjp_attention``): its forward
saves (q, k, v, out, lse), its backward recomputes the probabilities from
lse. dK/dV come from the kernel as per-(target frame, source slot) fp32
partials [B, F, S, N, C]; ``combine_partials`` scatters them onto the source
frames with a few index adds, as JAX's ``_combine_partials`` does outside
its kernels.

Each of the three kernels has two bodies, chosen by a pure function of
the dtype, the head dim and the rows' alignment: ``fwd_res_tensor_core_body``
(K1's rule: bf16 with d % 8 == 0, d <= 160), ``dq_tensor_core_body`` and
``dkv_tensor_core_body`` (the same with d <= 80). A tensor-core launch
counts also under ``<name>.tc``; the rest run the CUDA-core bodies. All
bodies load 16-byte vectors, so misaligned operands raise; a failed launch
raises and is never retried on the other body.

The softmax is K1's exact one (no CAP = 60 clamp indicator), so the
gradients are those of the plain version's softmax.

Each wrapper takes the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops.attention import (
    MOTION_FRAME,
    NORMAL,
    SPARSE_CAUSAL,
    split_heads,
)
from motioneditor_tpu_torch.ops.video_flash import (
    _MODE_CODES,
    _check_shapes,
    _source_frames,
    rows_aligned,
    tensor_core_body,
    video_flash_attention_plain,
)

BWD_MODES = (NORMAL, SPARSE_CAUSAL, MOTION_FRAME)
# the largest head dim of the dq and dk/dv kernels' tensor-core bodies
# (csrc/attention_dq_tc.cu DQ_MAX_D, csrc/attention_bwd_tc.cu DKV_MAX_D):
# their accumulators (dQ; dK and dV) take d / 2 and d fp32 registers a thread
DQ_TC_MAX_HEAD_DIM = 80
DKV_TC_MAX_HEAD_DIM = 80


# Which body a launch of K4 (video_flash_fwd_res) takes: K1's rule, since it
# runs K1's mainloop with an lse epilogue (csrc/attention_tc.cu); else the
# CUDA-core one (video_attention.cu)
fwd_res_tensor_core_body = tensor_core_body


def dq_tensor_core_body(dtype: torch.dtype, d: int, rows_aligned: bool) -> bool:
    """Which body a launch of K5 (video_flash_bwd_dq) takes: the bf16
    tensor-core one (csrc/attention_dq_tc.cu) where ``tensor_core_body``
    would take K1's and d <= 80, else the CUDA-core one
    (video_attention_bwd.cu). A function of its arguments alone."""
    return tensor_core_body(dtype, d, rows_aligned) and d <= DQ_TC_MAX_HEAD_DIM


def dkv_tensor_core_body(dtype: torch.dtype, d: int, rows_aligned: bool) -> bool:
    """Which body a launch of K6 (video_flash_bwd_dkv) takes: the bf16
    tensor-core one (csrc/attention_bwd_tc.cu) where ``tensor_core_body``
    would take K1's and d <= 80, else the CUDA-core one
    (video_attention_bwd.cu). A function of its arguments alone."""
    return tensor_core_body(dtype, d, rows_aligned) and d <= DKV_TC_MAX_HEAD_DIM


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
    return heads_of(q[:, f]), heads_of(kf), heads_of(vf)


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
        qh, kh, _ = _per_frame(q, k, v, f, mode, heads)
        s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
        lses.append(torch.logsumexp(s, dim=-1).transpose(1, 2))  # [B, N, H]
    out = video_flash_attention_plain(q, k, v, mode, scale, heads)
    return out, torch.stack(lses, dim=1)


def _frame_grads(q, k, v, lse, delta, do, f: int, mode: str, scale: float, heads: int):
    """fp32 dq [B, N, C] of target frame ``f`` and its dk / dv over the
    concatenated source frames [B, S*N, C]: P = exp(S - lse),
    dS = P o (dO V^T - delta), dQ = scale dS K, dK = scale dS^T Q,
    dV = P^T dO; ``delta`` [B, F, N, H] = rowsum(dO o O)."""
    b, _, n, c = q.shape
    qh, kh, vh = _per_frame(q, k, v, f, mode, heads)
    gh = do[:, f].float().reshape(b, n, heads, c // heads).transpose(1, 2)
    p = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale
                  - lse[:, f].transpose(1, 2)[..., None])
    ds = p * (torch.matmul(gh, vh.transpose(-1, -2)) - delta[:, f].transpose(1, 2)[..., None])
    return (_merge(scale * torch.matmul(ds, kh)),
            _merge(scale * torch.matmul(ds.transpose(-1, -2), qh)),
            _merge(torch.matmul(p.transpose(-1, -2), gh)))


def _delta(out, do, heads: int):
    """rowsum(dO o O) per (query row, head), [B, F, N, H] fp32."""
    b, f, n, c = out.shape
    return (do.float() * out.float()).reshape(b, f, n, heads, c // heads).sum(-1)


def video_flash_bwd_plain(q, k, v, out, lse, do, mode: str, scale: float, heads: int):
    """Plain PyTorch version of the flash backward, frame by frame in fp32
    (``_frame_grads``), with each source frame's share of dK/dV added onto
    that frame. Returns (dq, dk, dv) in the dtypes of q, k, v."""
    _check_mode("video_flash_bwd_plain", mode)
    b, nf, n, c = q.shape
    delta = _delta(out, do, heads)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for f in range(nf):
        dq[:, f], dk_f, dv_f = _frame_grads(q, k, v, lse, delta, do, f, mode, scale, heads)
        for slot, g in enumerate(_source_frames(mode, f, nf)):
            dk[:, g] += dk_f[:, slot * n:(slot + 1) * n]
            dv[:, g] += dv_f[:, slot * n:(slot + 1) * n]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def video_flash_bwd_dkv_plain(q, k, v, lse, delta, do, mode: str, scale: float, heads: int):
    """Plain PyTorch version of the dk/dv kernel: the fp32 partials
    [B, F, S, N, C] of dk and dv per (target frame, source slot), from the
    forward's lse and delta = rowsum(dO o O), both [B, F, N, H]."""
    _check_mode("video_flash_bwd_dkv_plain", mode)
    b, nf, n, c = q.shape
    parts = [_frame_grads(q, k, v, lse, delta, do, f, mode, scale, heads)[1:]
             for f in range(nf)]
    return tuple(torch.stack([p[i].reshape(b, -1, n, c) for p in parts], dim=1)
                 for i in range(2))


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


def _check_rows_aligned(name, heads, *tensors):
    """Every body loads 16-byte vectors: raise before any launch on an
    operand whose rows are off a 16-byte boundary."""
    if not rows_aligned(*(split_heads(t, heads).flatten(0, 1) for t in tensors)):
        raise ValueError(f"{name}: operands must start on a 16-byte boundary")


def _count(name: str, tc: bool) -> None:
    _build.launch_counts[name] += 1
    if tc:
        _build.launch_counts[name + ".tc"] += 1


def video_flash_fwd_res(q, k, v, mode: str, scale: float, heads: int):
    """K1's forward plus the fp32 log-sum-exp [B, F, N, H] of every
    (query row, head): the residuals of the backward."""
    if q.device.type == "cpu":
        return video_flash_fwd_res_plain(q, k, v, mode, scale, heads)
    name = "video_flash_fwd_res"
    _check_mode(name, mode)
    _check_shapes(name, q, heads, k, v)
    _build.check_operands(name, (q, k, v))
    return _fwd_res_kernel(q, k, v, mode, scale, heads)


def _fwd_res_kernel(q, k, v, mode, scale, heads):
    """K4's launch on the body ``fwd_res_tensor_core_body`` picks; a
    tensor-core launch also counts under ``video_flash_fwd_res.tc``."""
    name = "video_flash_fwd_res"
    b, f, n, c = q.shape
    d = c // heads
    out = torch.empty_like(q)
    _check_rows_aligned(name, heads, q, k, v, out)
    lse = torch.empty((b, f, n, heads), dtype=torch.float32, device=q.device)
    lib, stream = _build.kernels(), _build.stream_handle(q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    tc = fwd_res_tensor_core_body(q.dtype, d, rows_aligned=True)
    if tc:  # bf16 only: no dtype code
        code = lib.me_video_attention_fwd_res_tc(*ptrs, b, f, n, heads, d, float(scale),
                                                 _MODE_CODES[mode], stream)
    else:
        code = lib.me_video_attention_fwd_res(*ptrs, b, f, n, heads, d, float(scale),
                                              _MODE_CODES[mode], _build.DTYPE_CODES[q.dtype],
                                              stream)
    _build.check_status(name, code)
    _count(name, tc)
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
    delta = rowsum(dO o O) [B, F, N, H] fp32, which the dk/dv kernel reads,
    on the body ``dq_tensor_core_body`` picks (a tensor-core launch counts
    also under ``video_flash_bwd_dq.tc``)."""
    name = "video_flash_bwd_dq"
    args = _bwd_args(name, q, k, v, lse, heads, mode, scale, out, do)
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q)
    _check_rows_aligned(name, heads, q, k, v, out, do, dq)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    lib = _build.kernels()
    tc = dq_tensor_core_body(q.dtype, q.shape[3] // heads, rows_aligned=True)
    if tc:  # bf16 only: no dtype code
        *shape, _, stream = args
        code = lib.me_video_attention_bwd_dq_tc(*ptrs, *shape, stream)
    else:
        code = lib.me_video_attention_bwd_dq(*ptrs, *args)
    _build.check_status(name, code)
    _count(name, tc)
    return dq, delta


def video_flash_bwd_dkv(q, k, v, lse, delta, do, mode: str, scale: float, heads: int):
    """The dk/dv kernel (CUDA tensors only): fp32 partials [B, F, S, N, C]
    of dk and dv per (target frame, source slot), for combine_partials, on
    the body ``dkv_tensor_core_body`` picks (a tensor-core launch counts
    also under ``video_flash_bwd_dkv.tc``)."""
    name = "video_flash_bwd_dkv"
    args = _bwd_args(name, q, k, v, lse, heads, mode, scale, do)
    _build.check_operands(name, (delta,), dtype=torch.float32)
    if delta.shape != lse.shape:
        raise ValueError(f"{name}: delta shape {tuple(delta.shape)} != {tuple(lse.shape)}")
    b, f, n, c = q.shape
    d = c // heads
    _check_rows_aligned(name, heads, q, k, v, do)
    dkp = torch.empty((b, f, num_slots(mode), n, c), dtype=torch.float32, device=q.device)
    dvp = torch.empty_like(dkp)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dkp.data_ptr(), dvp.data_ptr())
    lib = _build.kernels()
    tc = dkv_tensor_core_body(q.dtype, d, rows_aligned=True)
    if tc:  # bf16 only: no dtype code
        *shape, _, stream = args
        code = lib.me_video_attention_bwd_dkv_tc(*ptrs, *shape, stream)
    else:
        code = lib.me_video_attention_bwd_dkv(*ptrs, *args)
    _build.check_status(name, code)
    _count(name, tc)
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
