"""Attention primitives and video K/V-selection variants
(port of motioneditor_tpu/ops/attention.py).

Video tokens are [B, F, N, C] (B = branch/batch, F = frames, N = H*W):

  normal        per-frame self-attention
  sparse_causal K/V = [frame0, prev frame]
  motion_frame  K/V = [prev frame, current frame]
  dense         K/V = all frames
  temporal      attention over the frame axis, causal additive mask

``sdpa`` is the plain form: matmul scores in fp32, fp32 softmax, then P.V
in the value dtype. The hand-written CUDA kernels (ops/video_flash.py,
ops/temporal_flash.py) run at the same call sites as the JAX Pallas
kernels, behind the same size gates.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from motioneditor_tpu_torch.models.layers import linear, zero_init

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
    ``zero_out`` zero-inits the output projection (layers.init_params)."""

    def __init__(self, query_dim: int, cross_dim: Optional[int] = None, heads: int = 8,
                 zero_out: bool = False):
        super().__init__()
        cross_dim = cross_dim if cross_dim is not None else query_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(cross_dim, query_dim, bias=False)
        self.to_v = nn.Linear(cross_dim, query_dim, bias=False)
        out = nn.Linear(query_dim, query_dim)
        self.to_out = nn.ModuleList([zero_init(out) if zero_out else out])


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., N, H*D] -> [..., H, N, D]"""
    *lead, n, c = x.shape
    return x.reshape(*lead, n, heads, c // heads).movedim(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, N, D] -> [..., N, H*D]"""
    x = x.movedim(-3, -2)
    *lead, n, h, d = x.shape
    return x.reshape(*lead, n, h * d)


def sdpa(q, k, v, scale: float, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over [..., H, N, D] with fp32 softmax."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


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
                           use_flash: bool = True) -> torch.Tensor:
    """Video self-attention with per-frame K/V selection; x: [B, F, N, C]."""
    from motioneditor_tpu_torch.ops.video_flash import (
        video_flash_attention,
        video_flash_supported,
    )

    b, f, n, c = x.shape
    q = linear(p.to_q, x)
    k = linear(p.to_k, x)
    v = linear(p.to_v, x)
    inner = q.shape[-1]
    scale = (inner // heads) ** -0.5
    if use_flash and n >= _FLASH_MIN_Q and video_flash_supported(inner, heads):
        # packed-head kernel: head split and frame selection happen in-kernel
        out = video_flash_attention(q, k, v, mode, scale, heads)
        return linear(p.to_out[0], out)
    out = sdpa(split_heads(q, heads), split_heads(select_kv(k, mode), heads),
               split_heads(select_kv(v, mode), heads), scale)
    return linear(p.to_out[0], merge_heads(out))


def cross_attention(p: Attention, x: torch.Tensor, encoder_states: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Text cross-attention. x: [B, F, N, C]; encoder_states: [B, L, D_text]
    (the same text for every frame)."""
    q = linear(p.to_q, x)
    k = linear(p.to_k, encoder_states)
    v = linear(p.to_v, encoder_states)
    scale = (q.shape[-1] // heads) ** -0.5
    qh = split_heads(q, heads)  # [B, F, H, N, D]
    kh = split_heads(k, heads)[:, None]  # [B, 1, H, L, D], broadcast over frames
    vh = split_heads(v, heads)[:, None]
    return linear(p.to_out[0], merge_heads(sdpa(qh, kh, vh, scale)))


def causal_temporal_bias(f: int, device=None) -> torch.Tensor:
    """(1 - tril) * -1e4 over frames."""
    mask = torch.tril(torch.ones((f, f), dtype=torch.float32, device=device))
    return (1.0 - mask) * -10000.0


def temporal_self_attention(p: Attention, x: torch.Tensor, heads: int, causal: bool = True,
                            kv_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over the frame axis; x: [B, N, F, C]. ``kv_override`` (same
    shape) substitutes the K/V source (temporal injection)."""
    f = x.shape[2]
    kv_src = x if kv_override is None else kv_override
    q = linear(p.to_q, x)
    k = linear(p.to_k, kv_src)
    v = linear(p.to_v, kv_src)
    scale = (q.shape[-1] // heads) ** -0.5
    bias = causal_temporal_bias(f, x.device) if causal else None
    out = sdpa(split_heads(q, heads), split_heads(k, heads), split_heads(v, heads), scale,
               bias=bias)
    return linear(p.to_out[0], merge_heads(out))


def temporal_self_attention_video(p: Attention, x: torch.Tensor, heads: int,
                                  causal: bool = True,
                                  kv_override: Optional[torch.Tensor] = None,
                                  use_kernel: bool = True) -> torch.Tensor:
    """Temporal attention on video tokens in their native [B, F, N, C] layout."""
    from motioneditor_tpu_torch.ops.temporal_flash import (
        temporal_flash_attention,
        temporal_flash_supported,
    )

    b, f, n, c = x.shape
    kv_src = x if kv_override is None else kv_override
    if use_kernel and n >= _TEMPORAL_MIN_N and temporal_flash_supported(f, c, heads):
        q = linear(p.to_q, x)
        k = linear(p.to_k, kv_src)
        v = linear(p.to_v, kv_src)
        scale = (q.shape[-1] // heads) ** -0.5
        out = temporal_flash_attention(q, k, v, scale, heads, causal=causal)
        return linear(p.to_out[0], out)
    xt = x.transpose(1, 2)
    kvt = None if kv_override is None else kv_src.transpose(1, 2)
    out = temporal_self_attention(p, xt, heads, causal=causal, kv_override=kvt)
    return out.transpose(1, 2)
