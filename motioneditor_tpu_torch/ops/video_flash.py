"""Packed-head video attention and fg/bg injection attention on [B, F, N, C]
(port of motioneditor_tpu/ops/video_flash.py).

Kernels (CUDA C++, ``csrc/video_attention.cu``, one CUDA-core body for all
four; all four in bf16 on ``csrc/attention_tc.cu``):

  video_flash_attention         replaces _video_flash         (video_flash.py:248)
  video_injection_attention     replaces _video_injection     (video_flash.py:591)
  video_flash_attention_kv      replaces _video_flash_kv      (video_flash.py:726)
  video_injection_attention_kv  replaces _video_injection_kv  (video_flash.py:859)

The ``_kv`` twins are the frame-sharded path's (parallel/flash_sharding.py):
there the K/V source of every query frame is built outside the kernel with
collectives and handed over explicitly as [B, Fk, M, C], Fk in {1, F}.

Each takes q/k/v in the native token layout with heads as channel strides
and selects the K/V source frames from its own block index:
normal [f], sparse_causal [0 | f-1], motion_frame [f-1 | f], dense [all],
with f-1 clamped to 0 (frame 0 reads frame 0 twice, keeping the doubled
weight of the reference's concatenated keys).

Each has two bodies, chosen by ``tensor_core_body`` from the dtype, the head
dim and the rows' alignment: bf16 with d % 8 == 0, d <= 160 runs the
tensor-core body (``csrc/attention_tc.cu``; K2 and K13 its injection
instantiation), counted also under ``<name>.tc``; fp32 runs the CUDA-core
body of ``video_attention.cu``. Both bodies load 16-byte vectors, so all
four raise on operands whose rows are off a 16-byte boundary. The fg mask
is fp32 in any case, read one value at a time.

Softmax: both dtypes use an exact online softmax (running max, fp32). The
JAX bf16 kernels instead clamp scores at 60 with no running max; the two
agree whenever every |logit| < 60, which the on-card bf16 checks assert on
their inputs. Bound on the H100 and design notes: see the .cu sources.

Each wrapper takes the plain PyTorch version only for CPU tensors; a CUDA
tensor launches the kernel or raises.

Gradients, chosen as the JAX package chooses its VJPs: under autograd the
frame-selection modes go through ``VideoFlashAttentionFn``
(ops/video_flash_bwd.py: the residual-saving forward K4 and the backward
kernels K5/K6, as JAX's ``flash_vjp_attention``); dense mode and the
injection attention run their kernel forward and take the VJP of their
plain version, recomputed in the backward (JAX's ``kernel_with_xla_vjp``,
ops/diffable.py). The kernel's residual-saving forward is taken only when a
gradient is needed: grad mode on and some input requiring grad. The ``_kv``
twins take the VJP of their plain versions too, as JAX's do (its
``kernel_with_xla_vjp``, video_flash.py:804 and :927); their plain versions
recompute one frame at a time in the backward (JAX's ``jax.checkpoint`` per
frame), so no frame's score matrix outlives its own gradient.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops import flop_count
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
# the largest head dim of both K1 bodies: the last head-dim bucket of
# csrc/video_attention.cu's dispatch and MAX_D of csrc/attention_tc.cuh
MAX_HEAD_DIM = 160


def rows_aligned(*views) -> bool:
    """Every row of every [G, H, N, D] view starts on a 16-byte boundary:
    an aligned base and G, H, N strides that are whole 16-byte units."""
    return all(x.data_ptr() % 16 == 0 and all(s * x.element_size() % 16 == 0
                                              for s in x.stride()[:3]) for x in views)


def tensor_core_body(dtype: torch.dtype, d: int, rows_aligned: bool) -> bool:
    """Which body a launch of K1 (video_flash_attention), K2
    (video_injection_attention), K8 (flash_attention), K12
    (video_flash_attention_kv) or K13 (video_injection_attention_kv) takes:
    the bf16 tensor-core one (csrc/attention_tc.cu) for bf16 operands with
    d % 8 == 0, d <= 160 and every row on a 16-byte boundary
    (``rows_aligned`` of the operands' [G, H, N, D] views), else the
    CUDA-core one (video_attention.cu, split_attention.cu): fp32 (its checks
    need exact fp32), other head dims, misaligned views. The whole rule: the
    entry points' own checks only guard it. A function of its arguments
    alone: a failed launch raises, it is never retried on the other body."""
    return dtype == torch.bfloat16 and d % 8 == 0 and d <= MAX_HEAD_DIM and rows_aligned


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
    # score + P.V: 4 b f n kv c, kv = (F for dense, 2 for the frame-selection
    # modes, 1 for normal) x N keys
    kv = (q.shape[1] if mode == DENSE else 1 if mode == NORMAL else 2) * q.shape[2]
    flop_count.add_kernel_flops(4 * q.numel() * kv, "video_flash_attention")
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
    """K1's launch on the body ``tensor_core_body`` picks; a tensor-core
    launch also counts under ``video_flash_attention.tc``."""
    name = "video_flash_attention"
    b, f, n, c = q.shape
    d = c // heads
    out = torch.empty_like(q)
    if not rows_aligned(*(split_heads(t, heads).flatten(0, 1) for t in (q, k, v, out))):
        raise ValueError(f"{name}: operands must start on a 16-byte boundary")  # both bodies
    lib, stream = _build.kernels(), _build.stream_handle(q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    tc = tensor_core_body(q.dtype, d, rows_aligned=True)
    if tc:
        code = lib.me_video_attention_tc(*ptrs, out.data_ptr(), b, f, n, heads, d, float(scale),
                                         _MODE_CODES[mode], stream)
    else:
        code = lib.me_video_attention(*ptrs, None, None, None, out.data_ptr(), b, f, n, heads, d,
                                      float(scale), _MODE_CODES[mode],
                                      _build.DTYPE_CODES[q.dtype], stream)
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    if tc:
        _build.launch_counts[name + ".tc"] += 1
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
    # over the [2N fg/bg-src + N tgt] keys: 4 b f n 3n c
    flop_count.add_kernel_flops(4 * q_tgt.numel() * 3 * q_tgt.shape[2],
                                "video_injection_attention")
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
    """K2's launch on the body ``tensor_core_body`` picks; a tensor-core
    launch also counts under ``video_injection_attention.tc``."""
    name = "video_injection_attention"
    b, f, n, c = q_tgt.shape
    d = c // heads
    out = torch.empty_like(q_tgt)
    operands = (q_tgt, k_src, v_src, k_tgt, v_tgt, out)
    if not rows_aligned(*(split_heads(t, heads).flatten(0, 1) for t in operands)):
        raise ValueError(f"{name}: operands must start on a 16-byte boundary")  # both bodies
    lib, stream = _build.kernels(), _build.stream_handle(q_tgt.device)
    ptrs = tuple(t.data_ptr() for t in (q_tgt, k_src, v_src, k_tgt, v_tgt, mask, out))
    tc = tensor_core_body(q_tgt.dtype, d, rows_aligned=True)
    if tc:
        code = lib.me_video_injection_tc(*ptrs, b, f, n, heads, d, float(scale), stream)
    else:
        code = lib.me_video_attention(*ptrs, b, f, n, heads, d, float(scale), _INJECTION_CODE,
                                      _build.DTYPE_CODES[q_tgt.dtype], stream)
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    if tc:
        _build.launch_counts[name + ".tc"] += 1
    return out


# ---------------------------------------------------------------------------
# explicit-K/V twins (the frame-sharded path)
# ---------------------------------------------------------------------------


def video_flash_kv_supported(c: int, heads: int) -> bool:
    """Shapes the explicit-K/V kernels take: any query and key token counts;
    the head-dim rule of ``video_flash_supported``."""
    return video_flash_supported(c, heads)


def _per_frame(fn, *frames):
    """``fn(*frames)``, recomputed in the backward when a gradient is taken
    (JAX's ``jax.checkpoint`` around each frame of its oracle), so the plain
    versions keep one frame's scores alive at a time."""
    if needs_grad(*frames):
        return torch.utils.checkpoint.checkpoint(fn, *frames, use_reentrant=False)
    return fn(*frames)


def video_flash_attention_kv_plain(q, k, v, scale: float, heads: int):
    """Plain PyTorch version: query frame f attends over the M tokens of K/V
    frame min(f, Fk - 1) (JAX's oracle, video_flash.py:795-799)."""
    fk = k.shape[1]

    def frame(qf, kf, vf):
        return merge_heads(sdpa(split_heads(qf, heads), split_heads(kf, heads),
                                split_heads(vf, heads), scale))

    return torch.stack([_per_frame(frame, q[:, f], k[:, min(f, fk - 1)], v[:, min(f, fk - 1)])
                        for f in range(q.shape[1])], dim=1)


def _check_kv(name, q, heads, k, v):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: expected [B, F, N, C] and [B, Fk, M, C]")
    b, f, _, c = q.shape
    if not video_flash_kv_supported(c, heads):
        raise ValueError(f"{name}: unsupported C={c} with {heads} heads")
    if k.shape[0] != b or k.shape[1] not in (1, f) or k.shape[3] != c or v.shape != k.shape:
        raise ValueError(f"{name}: K/V {tuple(k.shape)}, {tuple(v.shape)} do not fit q "
                         f"{tuple(q.shape)} (Fk must be 1 or F)")


def video_flash_attention_kv(q, k, v, scale: float, heads: int) -> torch.Tensor:
    """Packed-head attention of q [B, F, N, C] over an explicit K/V source
    [B, Fk, M, C], Fk in {1, F}: query frame f reads K/V frame
    (Fk == 1 ? 0 : f). Returns q's shape and dtype; differentiable."""
    # 4 b f n m c
    flop_count.add_kernel_flops(4 * q.numel() * k.shape[2], "video_flash_attention_kv")
    if q.device.type == "cpu":
        return video_flash_attention_kv_plain(q, k, v, scale, heads)
    name = "video_flash_attention_kv"
    _check_kv(name, q, heads, k, v)
    _build.check_operands(name, (q, k, v))
    if needs_grad(q, k, v):
        return KernelWithPlainVJP.apply(
            lambda *t: _video_kv_kernel(*t, None, None, None, scale, heads),
            lambda *t: video_flash_attention_kv_plain(*t, scale, heads), q, k, v)
    return _video_kv_kernel(q, k, v, None, None, None, scale, heads)


def _video_kv_kernel(q, k, v, k_tgt, v_tgt, mask, scale, heads):
    """K12's launch (K13's with ``mask``) on the body ``tensor_core_body``
    picks; a tensor-core launch also counts under ``<name>.tc``."""
    injection = mask is not None
    name = "video_injection_attention_kv" if injection else "video_flash_attention_kv"
    b, f, n, c = q.shape
    fk, m = k.shape[1:3]
    d = c // heads
    out = torch.empty_like(q)
    operands = (q, k, v, out) + ((k_tgt, v_tgt) if injection else ())
    if not rows_aligned(*(split_heads(t, heads).flatten(0, 1) for t in operands)):
        raise ValueError(f"{name}: operands must start on a 16-byte boundary")  # both bodies
    lib, stream = _build.kernels(), _build.stream_handle(q.device)
    tc = tensor_core_body(q.dtype, d, rows_aligned=True)
    if tc and injection:
        code = lib.me_video_injection_kv_tc(
            *(t.data_ptr() for t in (q, k, v, k_tgt, v_tgt, mask, out)), b, f, n, fk, m, heads,
            d, float(scale), stream)
    elif tc:
        code = lib.me_video_attention_kv_tc(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                            out.data_ptr(), b, f, n, fk, m, heads, d,
                                            float(scale), stream)
    else:
        code = lib.me_video_attention_kv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(t.data_ptr() if injection else None for t in (k_tgt, v_tgt, mask)), out.data_ptr(),
            b, f, n, fk, m, heads, d, float(scale), int(injection),
            _build.DTYPE_CODES[q.dtype], stream)
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    if tc:
        _build.launch_counts[name + ".tc"] += 1
    return out


def video_injection_attention_kv_plain(q_tgt, k_src, v_src, k_tgt, v_tgt, mask, scale: float,
                                       heads: int):
    """Plain PyTorch version: per frame f, softmax over the concatenated keys
    [K_src[f]*m, K_src[f]*(1-m), K_tgt[f]] with values [V_src[f], V_src[f],
    V_tgt[f]]; m = mask[f], the fg mask of K_src[f]'s M tokens (JAX's oracle,
    video_flash.py:913-925)."""

    def frame(qf, ks, vs, kt, vt, m):
        m = m[None, :, None].to(ks.dtype)
        k_inj = torch.cat([ks * m, ks * (1.0 - m), kt], dim=1)
        v_inj = torch.cat([vs, vs, vt], dim=1)
        return merge_heads(sdpa(split_heads(qf, heads), split_heads(k_inj, heads),
                                split_heads(v_inj, heads), scale))

    return torch.stack([_per_frame(frame, q_tgt[:, f], k_src[:, f], v_src[:, f], k_tgt[:, f],
                                   v_tgt[:, f], mask[f]) for f in range(q_tgt.shape[1])], dim=1)


def video_injection_attention_kv(q_tgt, k_src, v_src, k_tgt, v_tgt, mask, scale: float,
                                 heads: int) -> torch.Tensor:
    """fg/bg injection attention of the edit rows q_tgt [B, F, N, C] over an
    explicit source K/V [B, F, M, C] whose fg mask ``mask`` [F, M] is aligned
    with the source tokens (the halo-built [prev | cur] of the frame-sharded
    path), then the target-row K/V [B, F, N, C] of the current frame.
    Differentiable through the plain version's VJP."""
    flop_count.add_kernel_flops(4 * q_tgt.numel() * (k_src.shape[2] + q_tgt.shape[2]),
                                "video_injection_attention_kv")  # JAX's 4 b f n (m_src + n) c
    if q_tgt.device.type == "cpu":
        return video_injection_attention_kv_plain(
            q_tgt, k_src, v_src, k_tgt, v_tgt, mask, scale, heads)
    name = "video_injection_attention_kv"
    _check_kv(name, q_tgt, heads, k_src, v_src)
    f = q_tgt.shape[1]
    if k_src.shape[1] != f:
        raise ValueError(f"{name}: the source K/V needs one frame per query frame")
    _check_shapes(name, q_tgt, heads, k_tgt, v_tgt)
    _build.check_operands(name, (q_tgt, k_src, v_src, k_tgt, v_tgt))
    if mask.shape != (f, k_src.shape[2]):
        raise ValueError(f"{name}: mask shape {tuple(mask.shape)} != {(f, k_src.shape[2])}")
    mask = mask.to(torch.float32).contiguous()
    _build.check_operands(name, (mask,), dtype=torch.float32)
    args = (q_tgt, k_src, v_src, k_tgt, v_tgt, mask)
    if needs_grad(*args):
        return KernelWithPlainVJP.apply(
            lambda q, ks, vs, kt, vt, m: _video_kv_kernel(q, ks, vs, kt, vt, m, scale, heads),
            lambda *t: video_injection_attention_kv_plain(*t, scale, heads), *args)
    return _video_kv_kernel(*args, scale, heads)
