"""GroupNorm, and the SiLU after it, in two hand-written launches, and its
gradient in two more.

Kernels (CUDA C++, ``csrc/group_norm.cu``, calls ``me_group_norm`` and
``me_group_norm_bwd``):

  K10's statistics kernel (csrc/norm_stats.cuh) with fp64 sums, then
  ``group_norm_apply_kernel``: replaces no Pallas kernel (XLA fused the
  JAX package's knob-off GroupNorm on the TPU); here it replaces the plain
  version's ~11 PyTorch kernels over fp32 copies (12 with the SiLU).
  The backward: K10's kernel on (dy, x), dy first multiplied by the
  SiLU's derivative, then ``group_norm_bwd_apply_kernel``; it replaces the
  ~25 kernels of autograd's backward of the plain version and F.silu.

``models/layers.py group_norm`` takes this entry (``takes``) for a tensor
off the CPU (CUDA, or the meta device of the launch-count tests) with
``C % num_groups == 0`` and 16-byte rows; every other call keeps
``group_norm_plain``, the chain the port has always run. Where autograd
records a gradient through x, the weight or the bias (``records``), the
call goes through ``GroupNormKernelFn``, whose backward is the second
pair. The kernels compute what the plain version does, rounded at the same
points, but for the statistics of the forward and of the gradient, which
stay in fp64 until the group's coefficients are formed.

Counts ``group_norm`` a forward call, ``group_norm.silu`` one that applies
the SiLU, ``group_norm.grad`` one that records a gradient and
``group_norm.bwd`` a backward call; the kernel flop counter counts
nothing, as JAX counts nothing for its knob-off GroupNorm
(ops/flop_count.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from motioneditor_tpu_torch import _build
from motioneditor_tpu_torch.ops import gn_stats

APPLY_THREADS = 256      # a block's threads, at least one column group of 16 bytes each
APPLY_MAX_THREADS = 512  # csrc/group_norm.cu: wider rows loop over their column groups
APPLY_ROWS = 4           # rows of a thread's loads in flight (csrc/group_norm.cu)
# the grid's blocks an SM at most: 74-101 registers a thread fit 2 blocks of
# 256, and one such wave beat 4 or 8 blocks an SM and a second wave's tail
# (a sweep on the H100; PERF.md §6)
APPLY_BLOCKS_PER_SM = 2
META_SMS = 132           # the meta device of the launch-count tests stands for an H100


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float) -> torch.Tensor:
    """Plain PyTorch version: fp32 statistics per (batch row, group) over
    every interior axis of [B, ..., C] and the group's channels, the affine
    in fp32, rounded to x's dtype."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out.reshape(x.shape) * weight.float() + bias.float()
    return out.to(x.dtype)


def takes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int) -> bool:
    """Whether the kernels take GroupNorm of ``x`` [B, ..., C]: off the CPU,
    fp32 or bf16 rows of C * itemsize bytes, a multiple of 16, on a 16-byte
    boundary (a strided ``x`` is copied to fresh rows first), C a multiple
    of ``num_groups``, an fp32 or bf16 weight and bias of one dtype."""
    c = x.shape[-1]
    return (x.device.type != "cpu" and x.dtype in _build.DTYPE_CODES
            and c % num_groups == 0 and c * x.element_size() % 16 == 0 and x.numel() > 0
            and (x.data_ptr() % 16 == 0 or not x.is_contiguous())
            and weight.dtype in _build.DTYPE_CODES and bias.dtype == weight.dtype)


def records(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether autograd records a gradient through x, the weight or the bias."""
    return torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                        or bias.requires_grad)


class ApplyPlan(NamedTuple):
    """The apply kernel's launch: grid (ctas, B) of ``threads`` each."""

    threads: int  # a multiple of 32: lanes x column groups, the rest idle
    ctas: int     # blocks per batch row; they take chunks of lanes x APPLY_ROWS rows in turn


@functools.lru_cache(maxsize=None)
def apply_plan(b: int, s: int, c: int, dtype: torch.dtype, sm_count: int) -> ApplyPlan:
    """The apply kernel's launch for [B, S, C]: a thread per 16-byte column
    group of a row (at most APPLY_MAX_THREADS), as many rows of lanes as
    fill APPLY_THREADS, and per batch row as many blocks as keep the grid
    within APPLY_BLOCKS_PER_SM an SM (at least one), no more than its
    chunks of rows."""
    cols = min(c * dtype.itemsize // 16, APPLY_MAX_THREADS)
    threads = min(-(-max(1, APPLY_THREADS // cols) * cols // 32) * 32, APPLY_MAX_THREADS)
    lanes = threads // cols
    chunks = -(-s // (lanes * APPLY_ROWS))
    return ApplyPlan(threads, max(1, min(chunks, sm_count * APPLY_BLOCKS_PER_SM // b)))


def _sm_count(device: torch.device) -> int:
    return gn_stats._sm_count(device.index) if device.type == "cuda" else META_SMS


# (device index, stream) -> a byte buffer for the sums and K10's partials; a
# stream's launches run in order, so one buffer serves each call in turn
_workspaces: dict = {}


def _workspace_ptr(device: torch.device, stream: int, nbytes: int) -> int:
    key = (device.index, stream)
    w = _workspaces.get(key)
    if w is None or w.numel() < nbytes:
        w = _workspaces[key] = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                                           device=device)
    return w.data_ptr()


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
             eps: float, silu: bool, stats: torch.Tensor = None) -> torch.Tensor:
    """One ``me_group_norm`` call on contiguous ``x``; ``stats`` [2, B, G]
    fp32, when given, receives the groups' mean and rstd."""
    name = "group_norm"
    _build.check_operands(name, (x,))
    _build.check_operands(name, (weight, bias), dtype=weight.dtype)
    bt, c = x.shape[0], x.shape[-1]
    if weight.device != x.device or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} on {weight.device} and bias "
                         f"{tuple(bias.shape)} for C = {c} on {x.device}")
    s = x.numel() // (bt * c)
    sms = _sm_count(x.device)
    plan = gn_stats.pair_stats_plan(bt, s, c, x.dtype, sms)
    apply = apply_plan(bt, s, c, x.dtype, sms)
    y = torch.empty_like(x)
    stream = _build.stream_handle(x.device)
    work = _workspace_ptr(x.device, stream, 16 * bt * c + 4 * plan.workspace_floats(bt, c))
    code = _build.kernels().me_group_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        None if stats is None else stats.data_ptr(), work,
        gn_stats._ticket_ptr(x.device, stream, plan.tickets(bt, c)), bt, s, c, num_groups,
        float(eps), int(silu), _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[weight.dtype],
        *plan, *apply, stream)
    _build.check_status(name, code)
    _build.launch_counts[name] += 1
    if silu:
        _build.launch_counts[f"{name}.silu"] += 1
    return y


class GroupNormKernelFn(torch.autograd.Function):
    """GroupNorm (+ SiLU) of contiguous ``x`` [B, ..., C] in the forward
    pair, its gradient in the backward pair. Saves x, the weight, the bias
    and the groups' fp32 mean and rstd, nothing of the activation's size
    but x; K10's fixed-order combine gives a checkpoint's recompute the
    same statistics bit for bit."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups: int, eps: float, silu: bool):
        stats = torch.empty((2, x.shape[0], num_groups), dtype=torch.float32, device=x.device)
        y = _forward(x, weight, bias, num_groups, eps, silu, stats)
        _build.launch_counts["group_norm.grad"] += 1
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.num_groups, ctx.silu = num_groups, silu
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        name = "group_norm.bwd"
        x, weight, bias, stats = ctx.saved_tensors
        dy = dy.contiguous()
        _build.check_operands(name, (dy, x))
        bt, c = x.shape[0], x.shape[-1]
        s = x.numel() // (bt * c)
        want_dx, want_dw, want_db = ctx.needs_input_grad[:3]
        dx = torch.empty_like(x) if want_dx else None
        dw = torch.empty_like(weight) if want_dw else None
        db = torch.empty_like(bias) if want_db else None
        sms = _sm_count(x.device)
        plan = gn_stats.pair_stats_plan(bt, s, c, x.dtype, sms, same=False)
        apply = apply_plan(bt, s, c, x.dtype, sms)
        stream = _build.stream_handle(x.device)
        work = _workspace_ptr(x.device, stream, 16 * bt * c + 4 * plan.workspace_floats(bt, c))
        code = _build.kernels().me_group_norm_bwd(
            dy.data_ptr(), x.data_ptr(), weight.data_ptr(), bias.data_ptr(), stats.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (dx, dw, db)), work,
            gn_stats._ticket_ptr(x.device, stream, plan.tickets(bt, c)), bt, s, c,
            ctx.num_groups, int(ctx.silu), _build.DTYPE_CODES[x.dtype],
            _build.DTYPE_CODES[weight.dtype], *plan, *apply, stream)
        _build.check_status(name, code)
        _build.launch_counts[name] += 1
        return dx, dw, db, None, None, None


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
               eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm of ``x`` [B, ..., C] (statistics over every interior axis
    and the channels of a group), then the SiLU when ``silu``, in one call
    of two kernels; through ``GroupNormKernelFn`` where autograd records a
    gradient; for a call that ``takes`` accepts (the caller checks)."""
    x = x.contiguous()
    if records(x, weight, bias):
        return GroupNormKernelFn.apply(x, weight, bias, num_groups, float(eps), bool(silu))
    return _forward(x, weight, bias, num_groups, eps, silu)
