"""Frame-sharded attention: explicit collectives build each frame's K/V
source, and the explicit-K/V kernels run on the local frame shard (port of
motioneditor_tpu/parallel/flash_sharding.py).

Every rank holds its local block of frames [rank * Fl, (rank + 1) * Fl) of
the frame group (parallel/mesh.py). The attention variants read K/V from
other frames, so the K/V source is built with collectives first:

  normal         no communication (frame-local): K1
  sparse_causal  [frame 0 | prev]: a broadcast of global frame 0 and a
                 1-frame halo from the previous rank: K12
  motion_frame   [prev | cur]: the 1-frame halo: K12
  dense          all frames: an all-gather, [B, 1, F * N, C]: K12
  injection      the motion-frame source, its fg mask over the same halo: K13
  temporal       all frames gathered, causal at global frame indices: K14

Global frame 0's "previous" frame is itself (the reference's former[0] = 0).
The collectives are autograd Functions written here, each backward the
adjoint of its forward: the halo sends the borrowed frames' gradient back
to the rank that owns them, the all-gather all-reduces the gradient and
keeps the local block, the frame-0 broadcast sums every rank's gradient
into rank 0's frame 0. Each keeps JAX's ``fp == 1`` shortcut (no
communication).

Below the kernels' size gates, or at head dims they decline, the same K/V
is built and the plain ``sdpa`` runs on it: the JAX package falls back to
GSPMD's einsum on the global arrays there, which is the same arithmetic.

Head sharding over a ``model`` group (JAX ``head_shards``, :81-93): the
call sites pass q / k / v of this model rank's heads, [B, Fl, N, C / T],
made by the column-parallel projections (parallel/tp.py), and the local
head count; the halo, frame-0 and all-gather collectives run over the
frame group on those head-local tensors, and the kernels launch at width
C / T. The fg mask has no channel axis and stays whole. No collective runs
over the model group at a kernel boundary: the only model-group traffic is
the row-parallel output's all-reduce after the kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from motioneditor_tpu_torch.ops.attention import (
    DENSE,
    MOTION_FRAME,
    NORMAL,
    SPARSE_CAUSAL,
    merge_heads,
    sdpa,
    split_heads,
)
from motioneditor_tpu_torch.parallel.mesh import FrameShardingCtx

# ---------------------------------------------------------------------------
# collectives over the frame group, as autograd Functions
# ---------------------------------------------------------------------------


def _p2p(ctx: FrameShardingCtx, sends, recvs) -> None:
    """Post every (tensor, frame-group peer) send and receive, then wait."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), ctx.frame_ranks[peer], ctx.frame_group)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, ctx.frame_ranks[peer], ctx.frame_group)
            for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _shift(ctx: FrameShardingCtx, x: torch.Tensor, towards_next: bool) -> torch.Tensor:
    """Send ``x`` to the next rank (``towards_next``) or the previous one,
    and return what the opposite neighbour sent: zeros at the open ends
    (rank 0 gets nothing from a previous rank, the last rank nothing from a
    next one)."""
    r, fp = ctx.frame_rank, ctx.fp
    dst, src = (r + 1, r - 1) if towards_next else (r - 1, r + 1)
    buf = torch.zeros_like(x, memory_format=torch.contiguous_format)
    _p2p(ctx, [(x, dst)] if 0 <= dst < fp else [], [(buf, src)] if 0 <= src < fp else [])
    return buf


def _into_frames(g: torch.Tensor, frames: int, start: int) -> torch.Tensor:
    """A zero gradient of ``frames`` frames holding ``g`` from ``start``."""
    out = g.new_zeros(g.shape[:1] + (frames,) + g.shape[2:])
    out[:, start:start + g.shape[1]] = g
    return out


class _FromPrev(torch.autograd.Function):
    """The previous rank's last ``width`` frames of x [B, Fl, ...] (zeros on
    rank 0); the gradient goes back to the rank that sent them."""

    @staticmethod
    def forward(fctx, x, ctx, width):
        fctx.ctx, fctx.fl = ctx, x.shape[1]
        return _shift(ctx, x[:, x.shape[1] - width:], towards_next=True)

    @staticmethod
    def backward(fctx, g):
        back = _shift(fctx.ctx, g, towards_next=False)
        return _into_frames(back, fctx.fl, fctx.fl - g.shape[1]), None, None


class _FromNext(torch.autograd.Function):
    """The next rank's first ``width`` frames of x [B, Fl, ...] (zeros on
    the last rank); the gradient goes back to the rank that sent them."""

    @staticmethod
    def forward(fctx, x, ctx, width):
        fctx.ctx, fctx.fl = ctx, x.shape[1]
        return _shift(ctx, x[:, :width], towards_next=False)

    @staticmethod
    def backward(fctx, g):
        back = _shift(fctx.ctx, g, towards_next=True)
        return _into_frames(back, fctx.fl, 0), None, None


class _FirstFrame(torch.autograd.Function):
    """Global frame 0 [B, 1, ...], broadcast from the frame group's rank 0;
    the gradient of every rank sums into rank 0's frame 0."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx, fctx.fl = ctx, x.shape[1]
        buf = x[:, :1].clone(memory_format=torch.contiguous_format)
        dist.broadcast(buf, ctx.frame_ranks[0], group=ctx.frame_group)
        return buf

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.ctx
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.frame_group)
        if ctx.frame_rank == 0:
            return _into_frames(g, fctx.fl, 0), None
        return g.new_zeros(g.shape[:1] + (fctx.fl,) + g.shape[2:]), None


class _AllFrames(torch.autograd.Function):
    """The all-gather of x [B, Fl, ...] over the frame group along the frame
    axis, in global frame order; the gradient is all-reduced and the local
    block kept."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(ctx.fp)]
        dist.all_gather(parts, x.contiguous(), group=ctx.frame_group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.ctx
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.frame_group)
        fl = g.shape[1] // ctx.fp
        return g[:, ctx.frame_rank * fl:(ctx.frame_rank + 1) * fl], None


class _AllReduce(torch.autograd.Function):
    """The sum of x over a group, on every rank; the gradient is the sum of
    every rank's gradient."""

    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(fctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=fctx.group)
        return g, None


def frames_from_prev(x: torch.Tensor, ctx: FrameShardingCtx, width: int = 1) -> torch.Tensor:
    """The ``width`` frames before this rank's block (zeros on rank 0)."""
    ctx.check(x)
    return _FromPrev.apply(x, ctx, width)


def frames_from_next(x: torch.Tensor, ctx: FrameShardingCtx, width: int = 1) -> torch.Tensor:
    """The ``width`` frames after this rank's block (zeros on the last rank)."""
    ctx.check(x)
    return _FromNext.apply(x, ctx, width)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``."""
    return _AllReduce.apply(x, group)


def prev_frames(x: torch.Tensor, ctx: FrameShardingCtx) -> torch.Tensor:
    """prev[f] = global frame f - 1, frame 0's previous being itself: the
    local block shifted right by one frame over a 1-frame halo
    (flash_sharding.py:117-130)."""
    if ctx.fp == 1:
        return torch.cat([x[:, :1], x[:, :-1]], dim=1)
    recv = frames_from_prev(x, ctx)
    # rank 0 receives zeros and adds its own frame 0; every rank keeps the
    # halo in its graph, so every rank runs the halo's backward exchange
    head = recv + x[:, :1] if ctx.frame_rank == 0 else recv
    return torch.cat([head, x[:, :-1]], dim=1)


def first_frame(x: torch.Tensor, ctx: FrameShardingCtx) -> torch.Tensor:
    """[B, 1, ...]: global frame 0 on every rank (flash_sharding.py:133-138)."""
    if ctx.fp == 1:
        return x[:, :1]
    ctx.check(x)
    return _FirstFrame.apply(x, ctx)


def all_frames(x: torch.Tensor, ctx: FrameShardingCtx) -> torch.Tensor:
    """[B, F, ...]: every frame, in global order (flash_sharding.py:141-143)."""
    if ctx.fp == 1:
        return x
    ctx.check(x)
    return _AllFrames.apply(x, ctx)


# ---------------------------------------------------------------------------
# K/V sources and the sharded attention sites
# ---------------------------------------------------------------------------


def build_kv(x: torch.Tensor, mode: str, ctx: FrameShardingCtx) -> torch.Tensor:
    """The explicit K/V source of the local query frames from the local
    tokens x [B, Fl, N, C]: [B, Fl, 2N, C] for sparse_causal ([frame 0 |
    prev]) and motion_frame ([prev | cur]), [B, 1, F * N, C] for dense (all
    frames in global order), flash_sharding.py:195-215."""
    b, fl, n, c = x.shape
    if mode == SPARSE_CAUSAL:
        first = first_frame(x, ctx).expand(b, fl, n, c)
        return torch.cat([first, prev_frames(x, ctx)], dim=2)
    if mode == MOTION_FRAME:
        return torch.cat([prev_frames(x, ctx), x], dim=2)
    if mode == DENSE:
        return all_frames(x, ctx).reshape(b, 1, -1, c)
    raise ValueError(f"mode {mode} has no explicit K/V source")


def motion_frame_mask(mask: torch.Tensor, ctx: FrameShardingCtx) -> torch.Tensor:
    """The fg mask [Fl, N] of the local frames -> [Fl, 2N] = [prev mask |
    cur], over the same halo as the keys (flash_sharding.py:260-263)."""
    prev = prev_frames(mask[None, ..., None], ctx)[0, ..., 0]
    return torch.cat([prev, mask], dim=1)


def kv_attention(q, kk, vv, scale: float, heads: int, use_kernel: bool) -> torch.Tensor:
    """q [B, Fl, N, C] over the explicit K/V [B, Fl or 1, M, C]: K12, or the
    plain ``sdpa`` on the same K/V."""
    if use_kernel:
        from motioneditor_tpu_torch.ops.video_flash import video_flash_attention_kv

        return video_flash_attention_kv(q, kk, vv, scale, heads)
    return merge_heads(sdpa(split_heads(q, heads), split_heads(kk, heads),
                            split_heads(vv, heads), scale))


def sharded_spatial_attention(q, k, v, mode: str, scale: float, heads: int,
                              ctx: FrameShardingCtx, use_kernel: bool) -> torch.Tensor:
    """Frame-sharded spatial attention of the local tokens [B, Fl, N, C]:
    normal mode is frame-local (K1), the others run K12 on the K/V built by
    ``build_kv`` (flash_sharding.py:151-221)."""
    if mode == NORMAL:
        if use_kernel:
            from motioneditor_tpu_torch.ops.video_flash import video_flash_attention

            return video_flash_attention(q, k, v, NORMAL, scale, heads)
        return merge_heads(sdpa(split_heads(q, heads), split_heads(k, heads),
                                split_heads(v, heads), scale))
    return kv_attention(q, build_kv(k, mode, ctx), build_kv(v, mode, ctx), scale, heads,
                        use_kernel)


def injection_attention(q_tgt, ks2, vs2, k_tgt, v_tgt, m2, scale: float, heads: int,
                        use_kernel: bool) -> torch.Tensor:
    """The edit rows' fg/bg injection attention over the halo-built source
    K/V ks2, vs2 [B, Fl, 2N, C] with its mask m2 [Fl, 2N]: K13, or the plain
    concatenation [K_src*m, K_src*(1-m), K_tgt] through ``sdpa``."""
    if use_kernel:
        from motioneditor_tpu_torch.ops.video_flash import video_injection_attention_kv

        return video_injection_attention_kv(q_tgt, ks2, vs2, k_tgt, v_tgt, m2, scale, heads)
    m = m2[None, ..., None].to(ks2.dtype)
    k_inj = torch.cat([ks2 * m, ks2 * (1.0 - m), k_tgt], dim=2)
    v_inj = torch.cat([vs2, vs2, v_tgt], dim=2)
    return merge_heads(sdpa(split_heads(q_tgt, heads), split_heads(k_inj, heads),
                            split_heads(v_inj, heads), scale))


def sharded_temporal_attention(q, k, v, scale: float, heads: int, causal: bool,
                               ctx: FrameShardingCtx, use_kernel: bool) -> torch.Tensor:
    """Temporal attention of the local frames q [B, Fl, N, C] over all
    frames: K/V all-gathered, the query offset ``frame_rank * Fl``
    (flash_sharding.py:275-314). K14, or the plain path of JAX's
    ``temporal_self_attention`` with its -1e4 causal bias at global
    indices."""
    kg, vg = all_frames(k, ctx), all_frames(v, ctx)
    fl = q.shape[1]
    off = ctx.frame_rank * fl
    if use_kernel:
        from motioneditor_tpu_torch.ops.temporal_flash import temporal_flash_attention_global

        return temporal_flash_attention_global(q, kg, vg, scale, heads, causal, off)
    bias = None
    if causal:
        g = torch.arange(kg.shape[1], device=q.device)
        f = torch.arange(fl, device=q.device) + off
        bias = (g[None, :] > f[:, None]).float() * -10000.0
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kg, vg))  # [B, N, F, C]
    out = merge_heads(sdpa(split_heads(qt, heads), split_heads(kt, heads),
                           split_heads(vt, heads), scale, bias=bias))
    return out.transpose(1, 2)
