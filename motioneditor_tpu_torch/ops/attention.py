"""Attention primitives and video K/V-selection variants
(port of motioneditor_tpu/ops/attention.py).

Video tokens are [B, F, N, C] (B = branch/batch, F = frames, N = H*W):

  normal        per-frame self-attention
  sparse_causal K/V = [frame0, prev frame]
  motion_frame  K/V = [prev frame, current frame]
  dense         K/V = all frames
  temporal      attention over the frame axis, causal additive mask

``sdpa`` is the plain form: matmul scores in fp32, fp32 softmax, then P.V
in the value dtype; with ``use_flash`` it routes long sequences to the
split-head kernel (ops/flash_attention.py). The hand-written CUDA kernels
(ops/video_flash.py, ops/temporal_flash.py, ops/flash_attention.py) run at
the same call sites as the JAX Pallas kernels, behind the same size gates.

Under tensor parallelism (parallel/tp.py) a split Attention holds its
model rank's heads: every site projects with the column-parallel q / k / v
(``project_qkv``), computes over ``local_heads`` at width C / T, the kernel
gates evaluated there, and reduces through the row-parallel
``project_out``. The p2p editors act on the local heads' probabilities,
and the cross-attention maps, a mean over heads, are the local heads' sum
summed over the model group and divided by the global head count
(``head_mean``), so every rank collects the full width's maps.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from motioneditor_tpu_torch.models.layers import linear, zero_init
from motioneditor_tpu_torch.parallel.tp import copy_to_model, reduce_from_model, sum_over_model

NORMAL = "normal"
SPARSE_CAUSAL = "sparse_causal"
MOTION_FRAME = "motion_frame"
DENSE = "dense"

# Call-site gates, kept from the JAX package so the port launches its kernels
# at the same sites. Both were derived from TPU measurements and are not yet
# measured on the H100.
_FLASH_MIN_Q = 1024  # spatial kernels run at N >= this (attention.py:34)
_TEMPORAL_MIN_N = 512  # temporal kernel runs at N >= this (attention.py:341)


class Attention(nn.Module):
    """q/k/v without bias, out with bias; keys to_q / to_k / to_v / to_out.0.
    ``zero_out`` zero-inits the output projection (layers.init_params).
    ``tp_group`` / ``tp_size``: the model group parallel/tp.py
    ``shard_params_tp`` split this module over (None / 1: whole)."""

    tp_group = None
    tp_size = 1

    def __init__(self, query_dim: int, cross_dim: Optional[int] = None, heads: int = 8,
                 zero_out: bool = False):
        super().__init__()
        cross_dim = cross_dim if cross_dim is not None else query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(cross_dim, query_dim, bias=False)
        self.to_v = nn.Linear(cross_dim, query_dim, bias=False)
        out = nn.Linear(query_dim, query_dim)
        self.to_out = nn.ModuleList([zero_init(out) if zero_out else out])


def local_heads(p: Attention, heads: int) -> int:
    """The heads this rank computes at site ``p``: ``heads``, or its share
    of them when ``p`` is split over a model group."""
    if p.tp_size == 1:
        return heads
    if heads != p.heads:
        raise ValueError(f"a site split over {p.tp_size} model ranks for {p.heads} heads was "
                         f"called with {heads}")
    return heads // p.tp_size


def project_qkv(p: Attention, x: torch.Tensor, kv: Optional[torch.Tensor] = None):
    """q of ``x``, k and v of ``kv`` (``x`` when None): under a model group
    the column-parallel projections to this rank's heads, their inputs
    through Megatron's f (``copy_to_model``)."""
    x = copy_to_model(x, p.tp_group)
    kv = x if kv is None else copy_to_model(kv, p.tp_group)
    return linear(p.to_q, x), linear(p.to_k, kv), linear(p.to_v, kv)


def project_out(p: Attention, h: torch.Tensor) -> torch.Tensor:
    """to_out.0 of the merged heads ``h``; under a model group the
    row-parallel product of this rank's heads summed over the group, then
    the bias, once."""
    if p.tp_size == 1:
        return linear(p.to_out[0], h)
    out = p.to_out[0]
    y = reduce_from_model(F.linear(h, out.weight.to(h.dtype)), p.tp_group)
    return y + out.bias.to(h.dtype)


def head_mean(p: Attention, probs: torch.Tensor) -> torch.Tensor:
    """The mean over every head of site ``p`` of ``probs`` [..., H, N, L]
    holding this rank's heads: under a model group the local heads' sum,
    summed over the group, over the global head count."""
    if p.tp_size == 1:
        return probs.mean(dim=-3)
    return sum_over_model(probs.sum(dim=-3), p.tp_group) / p.heads


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., N, H*D] -> [..., H, N, D]"""
    *lead, n, c = x.shape
    return x.reshape(*lead, n, heads, c // heads).movedim(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, N, D] -> [..., N, H*D]"""
    x = x.movedim(-3, -2)
    *lead, n, h, d = x.shape
    return x.reshape(*lead, n, h * d)


def sdpa(q, k, v, scale: float, bias: Optional[torch.Tensor] = None,
         use_flash: bool = False) -> torch.Tensor:
    """Scaled dot-product attention over [..., H, N, D] with fp32 softmax.
    ``use_flash`` routes to the split-head flash kernel
    (ops/flash_attention.py) at ``q.shape[-2] >= _FLASH_MIN_Q`` without a
    bias, as JAX's sdpa does; every call site that JAX routes passes it."""
    if use_flash and bias is None and q.shape[-2] >= _FLASH_MIN_Q:
        from motioneditor_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, scale)
    probs = attention_probs(q, k, scale, bias).to(v.dtype)
    return torch.matmul(probs, v)


def attention_probs(q, k, scale: float, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 softmax probabilities over [..., H, Nq, Nk] (the explicit form the
    16x16 cross-attention map collection needs)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    return torch.softmax(scores, dim=-1)


def former_frame_index(f: int) -> torch.Tensor:
    idx = torch.arange(f) - 1
    idx[0] = 0
    return idx


def select_kv(x: torch.Tensor, mode: str) -> torch.Tensor:
    """Per-frame K/V source tokens from video tokens [B, F, N, C].

    normal -> [B, F, N, C]; sparse_causal -> [B, F, 2N, C] ([frame0, prev]);
    motion_frame -> [B, F, 2N, C] ([prev, cur]); dense -> [B, F, F*N, C]."""
    b, f, n, c = x.shape
    if mode == NORMAL:
        return x
    former = former_frame_index(f).to(x.device)
    if mode == SPARSE_CAUSAL:
        return torch.cat([x[:, :1].expand(b, f, n, c), x[:, former]], dim=2)
    if mode == MOTION_FRAME:
        return torch.cat([x[:, former], x], dim=2)
    if mode == DENSE:
        return x.reshape(b, 1, f * n, c).expand(b, f, f * n, c)
    raise ValueError(f"unknown attention mode {mode}")


def spatial_self_attention(p: Attention, x: torch.Tensor, mode: str, heads: int,
                           use_flash: bool = True, shard=None,
                           prob_editor=None) -> torch.Tensor:
    """Video self-attention with per-frame K/V selection; x: [B, F, N, C].
    ``shard`` (a FrameShardingCtx): x holds the local frames, the K/V source
    is built with collectives and the explicit-K/V kernel runs on it
    (parallel/flash_sharding.py), as JAX attention.py:187-196.
    ``prob_editor``: a (probs, is_cross=False) -> probs hook, the p2p
    self-attention map replacement (control/p2p.py); at N <= 256 it takes
    the explicit-probs path before the shard and kernel branches, as JAX
    attention.py:176-184 (the callers pass it in normal mode only, whose
    K/V are the frame's own, so a shard needs no collective)."""
    from motioneditor_tpu_torch.ops.video_flash import (
        video_flash_attention,
        video_flash_supported,
    )

    b, f, n, c = x.shape
    q, k, v = project_qkv(p, x)
    heads = local_heads(p, heads)
    inner = q.shape[-1]
    scale = (inner // heads) ** -0.5
    if prob_editor is not None and n <= 256:
        vh = split_heads(select_kv(v, mode), heads)
        probs = attention_probs(split_heads(q, heads), split_heads(select_kv(k, mode), heads),
                                scale)  # [B, F, H, N, KV]
        out = torch.matmul(prob_editor(probs, False).to(vh.dtype), vh)
        return project_out(p, merge_heads(out))
    if shard is not None:
        from motioneditor_tpu_torch.parallel.flash_sharding import sharded_spatial_attention

        kernel = use_flash and n >= _FLASH_MIN_Q and video_flash_supported(inner, heads)
        out = sharded_spatial_attention(q, k, v, mode, scale, heads, shard, kernel)
        return project_out(p, out)
    if use_flash and n >= _FLASH_MIN_Q and video_flash_supported(inner, heads):
        # packed-head kernel: head split and frame selection happen in-kernel
        out = video_flash_attention(q, k, v, mode, scale, heads)
        return project_out(p, out)
    out = sdpa(split_heads(q, heads), split_heads(select_kv(k, mode), heads),
               split_heads(select_kv(v, mode), heads), scale, use_flash=use_flash)
    return project_out(p, merge_heads(out))


def cross_attention(p: Attention, x: torch.Tensor, encoder_states: torch.Tensor,
                    heads: int, collect_maps_into: Optional[list] = None,
                    prob_editor=None) -> torch.Tensor:
    """Text cross-attention. x: [B, F, N, C]; encoder_states: [B, L, D_text]
    (the same text for every frame). ``collect_maps_into``: when given,
    appends the mean-over-heads probabilities [(B F), N, L], the maps the
    auto-mask injection and LocalBlend read (``head_mean``: the full
    width's under a model group). ``prob_editor``: a (probs,
    is_cross=True) -> probs hook over [B, F, H, N, L] (this rank's heads),
    the p2p controller; the maps are collected before it edits them (JAX
    attention.py:251-258)."""
    b, f, n, _ = x.shape
    q, k, v = project_qkv(p, x, encoder_states)
    heads = local_heads(p, heads)
    scale = (q.shape[-1] // heads) ** -0.5
    qh = split_heads(q, heads)  # [B, F, H, N, D]
    kh = split_heads(k, heads)[:, None]  # [B, 1, H, L, D], broadcast over frames
    vh = split_heads(v, heads)[:, None]
    if collect_maps_into is None and prob_editor is None:
        return project_out(p, merge_heads(sdpa(qh, kh, vh, scale)))
    probs = attention_probs(qh, kh, scale)  # [B, F, H, N, L]
    if collect_maps_into is not None:
        collect_maps_into.append(head_mean(p, probs).reshape(b * f, n, probs.shape[-1]))
    if prob_editor is not None:
        probs = prob_editor(probs, True)
    out = torch.matmul(probs.to(vh.dtype), vh)
    return project_out(p, merge_heads(out))


def causal_temporal_bias(f: int, device=None) -> torch.Tensor:
    """(1 - tril) * -1e4 over frames."""
    mask = torch.tril(torch.ones((f, f), dtype=torch.float32, device=device))
    return (1.0 - mask) * -10000.0


def temporal_self_attention(p: Attention, x: torch.Tensor, heads: int, causal: bool = True,
                            kv_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over the frame axis; x: [B, N, F, C]. ``kv_override`` (same
    shape) substitutes the K/V source (temporal injection)."""
    f = x.shape[2]
    q, k, v = project_qkv(p, x, kv_override)
    heads = local_heads(p, heads)
    scale = (q.shape[-1] // heads) ** -0.5
    bias = causal_temporal_bias(f, x.device) if causal else None
    out = sdpa(split_heads(q, heads), split_heads(k, heads), split_heads(v, heads), scale,
               bias=bias)
    return project_out(p, merge_heads(out))


def temporal_self_attention_video(p: Attention, x: torch.Tensor, heads: int,
                                  causal: bool = True,
                                  kv_override: Optional[torch.Tensor] = None,
                                  use_kernel: bool = True, shard=None) -> torch.Tensor:
    """Temporal attention on video tokens in their native [B, F, N, C] layout.
    ``shard`` (a FrameShardingCtx): x holds the local frames, K/V are
    all-gathered and the causal mask holds at global frame indices
    (parallel/flash_sharding.py), as JAX attention.py:324-337."""
    from motioneditor_tpu_torch.ops.temporal_flash import (
        temporal_flash_attention,
        temporal_flash_supported,
    )

    b, f, n, c = x.shape
    hl = local_heads(p, heads)
    cl = p.to_q.weight.shape[0]  # this rank's channels
    frames = f * shard.fp if shard is not None else f
    kernel = use_kernel and n >= _TEMPORAL_MIN_N and temporal_flash_supported(frames, cl, hl)
    if shard is None and not kernel:
        xt = x.transpose(1, 2)
        kvt = None if kv_override is None else kv_override.transpose(1, 2)
        out = temporal_self_attention(p, xt, heads, causal=causal, kv_override=kvt)
        return out.transpose(1, 2)
    q, k, v = project_qkv(p, x, kv_override)
    scale = (cl // hl) ** -0.5
    if shard is not None:
        from motioneditor_tpu_torch.parallel.flash_sharding import sharded_temporal_attention

        out = sharded_temporal_attention(q, k, v, scale, hl, causal, shard, kernel)
    else:
        out = temporal_flash_attention(q, k, v, scale, hl, causal=causal)
    return project_out(p, out)
