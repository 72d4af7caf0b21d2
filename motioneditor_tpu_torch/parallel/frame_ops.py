"""The frame-mixing ops outside attention, on frame-sharded videos.

In the JAX package these are global-array code that GSPMD partitions over
the ``frames`` mesh axis (motioneditor_tpu/models/unet.py,
models/layers.py): XLA inserts the collectives. PyTorch has no GSPMD, so
each gets its own explicit collective here, over the frame group of
parallel/mesh.py:

  group_norm     the video GroupNorm's statistics pool over (C/G, F, H, W)
                 (JAX unet.py:256-288): the per-group sums for the mean are
                 all-reduced, then the sums of squared deviations, which
                 keeps the plain path's fp32 two-pass numerics. With
                 MOTIONEDITOR_FUSED_GN=1 K10's per-channel pair sums are
                 all-reduced inside the GroupNorm Function, forward and
                 backward (ops/gn_stats.py).
  temporal_conv  a SAME conv over the frame axis takes (K - 1) / 2 halo
                 frames from each neighbour, zeros at the global ends.

Per-frame GroupNorms (the transformer's, the 2D ControlNet's) and the
adapter's kernel-1 VALID conv are frame-local and need nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from motioneditor_tpu_torch.ops import gn_stats
from motioneditor_tpu_torch.parallel.flash_sharding import (
    all_reduce_sum,
    frames_from_next,
    frames_from_prev,
)
from motioneditor_tpu_torch.parallel.mesh import FrameShardingCtx


class _FrameSum:
    """Sum of a statistics tensor over the frame group (not differentiable:
    the GroupNorm Function that calls it writes its own backward)."""

    def __init__(self, ctx: FrameShardingCtx):
        self.group, self.parts = ctx.frame_group, ctx.fp

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=self.group)
        return t


def group_norm(p, x: torch.Tensor, num_groups: int, eps: float,
               ctx: FrameShardingCtx) -> torch.Tensor:
    """GroupNorm of the local frames x [B, Fl, ..., C] with statistics over
    every frame of the frame group."""
    ctx.check(x)
    b, c = x.shape[0], x.shape[-1]
    if gn_stats.enabled() and c % num_groups == 0:
        return gn_stats.group_norm_fused(p, x, num_groups, eps, reduce=_FrameSum(ctx))
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    n = xf.shape[1] * xf.shape[3] * ctx.fp
    mean = all_reduce_sum(xf.sum(dim=(1, 3), keepdim=True), ctx.frame_group) / n
    dev = xf - mean
    var = all_reduce_sum((dev * dev).sum(dim=(1, 3), keepdim=True), ctx.frame_group) / n
    out = dev * torch.rsqrt(var + eps)
    out = out.reshape(x.shape) * p.weight.float() + p.bias.float()
    return out.to(x.dtype)


def temporal_conv(p, video: torch.Tensor, ctx: FrameShardingCtx) -> torch.Tensor:
    """The SAME conv over the frame axis of the local frames [B, Fl, H, W,
    C]: the halos of both neighbours (zeros at the global ends) around the
    local block, then a VALID conv."""
    from motioneditor_tpu_torch.models.layers import temporal_conv as conv

    width = (p.weight.shape[-1] - 1) // 2
    if width == 0:
        return conv(p, video, padding="VALID")
    if video.shape[1] < width:
        raise ValueError(f"{video.shape[1]} local frames for a halo of {width}")
    x = torch.cat([frames_from_prev(video, ctx, width), video,
                   frames_from_next(video, ctx, width)], dim=1)
    return conv(p, x, padding="VALID")
