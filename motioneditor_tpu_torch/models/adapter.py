"""Content-aware motion ControlAdapter (port of motioneditor_tpu/models/adapter.py).

Twelve blocks, one per ControlNet down residual; each returns

  conv branch:  zero-init TemporalConv(k3) -> ReLU -> zero-init TemporalConv(k1) + x
  attn branch:  sparse-causal self-attn -> per-frame cross-attn to the source
                UNet features -> GEGLU FF -> causal temporal self-attn
                (zero-init output projection)

summed: conv + attn.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from motioneditor_tpu_torch.models.layers import (
    FeedForward,
    feed_forward,
    layer_norm,
    linear,
    temporal_conv,
)
from motioneditor_tpu_torch.ops.attention import (
    _FLASH_MIN_Q,
    NORMAL,
    SPARSE_CAUSAL,
    Attention,
    merge_heads,
    sdpa,
    spatial_self_attention,
    split_heads,
    temporal_self_attention_video,
)

ADAPTER_HEADS = 8
NUM_ADAPTER_BLOCKS = 12
SD15_BLOCK_CHANNELS = (320, 640, 1280, 1280)


def adapter_block_channels(idx: int, block_out_channels=SD15_BLOCK_CHANNELS) -> int:
    """Flat block index -> channels, matching the UNet's 12 down res-samples."""
    c0, c1, c2, c3 = block_out_channels
    if idx <= 3:
        return c0
    if idx <= 6:
        return c1
    if idx <= 9:
        return c2
    return c3


class AdapterBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block1 = nn.Conv1d(ch, ch, 3)  # temporal convs init to zero
        self.block2 = nn.Conv1d(ch, ch, 1)
        self.norm_temp = nn.LayerNorm(ch)
        self.attn_temp = Attention(ch, cross_dim=ch, heads=ADAPTER_HEADS)
        self.cross_pose_norm = nn.LayerNorm(ch)
        self.attn_pose = Attention(ch, cross_dim=ch, heads=ADAPTER_HEADS)
        self.ff_norm = nn.LayerNorm(ch)
        self.ff = FeedForward(ch)
        self.norm_self_temp = nn.LayerNorm(ch)
        self.attn_self_temp = Attention(ch, heads=ADAPTER_HEADS, zero_out=True)


class ControlAdapter(nn.Module):
    def __init__(self, block_out_channels: Tuple[int, ...] = SD15_BLOCK_CHANNELS):
        super().__init__()
        self.body = nn.ModuleList([
            AdapterBlock(adapter_block_channels(i, block_out_channels))
            for i in range(NUM_ADAPTER_BLOCKS)
        ])


def _per_frame_cross_attention(p: Attention, q_tokens, kv_tokens, use_flash: bool):
    """Each frame's adapter tokens attend to the same frame's source tokens."""
    from motioneditor_tpu_torch.ops.video_flash import (
        video_flash_attention,
        video_flash_supported,
    )

    q = linear(p.to_q, q_tokens)
    k = linear(p.to_k, kv_tokens)
    v = linear(p.to_v, kv_tokens)
    heads = ADAPTER_HEADS
    inner = q.shape[-1]
    n = q.shape[-2]
    scale = (inner // heads) ** -0.5
    if use_flash and n >= _FLASH_MIN_Q and video_flash_supported(inner, heads):
        return linear(p.to_out[0], video_flash_attention(q, k, v, NORMAL, scale, heads))
    out = sdpa(split_heads(q, heads), split_heads(k, heads), split_heads(v, heads), scale)
    return linear(p.to_out[0], merge_heads(out))


def adapter_block_apply(p: AdapterBlock, x, source_hidden, use_flash: bool = True):
    """x, source_hidden: [B, F, h, w, C] (ControlNet residual / UNet feature)."""
    b, f, h, w, c = x.shape
    conv = torch.relu(temporal_conv(p.block1, x))
    conv = temporal_conv(p.block2, conv, padding="VALID") + x

    tokens = x.reshape(b, f, h * w, c)
    n = layer_norm(p.norm_temp, tokens)
    tokens = tokens + spatial_self_attention(p.attn_temp, n, SPARSE_CAUSAL, ADAPTER_HEADS,
                                             use_flash=use_flash)
    n = layer_norm(p.cross_pose_norm, tokens)
    tokens = tokens + _per_frame_cross_attention(
        p.attn_pose, n, source_hidden.reshape(b, f, h * w, c), use_flash)
    tokens = tokens + feed_forward(p.ff, layer_norm(p.ff_norm, tokens))
    nt = layer_norm(p.norm_self_temp, tokens)
    tokens = tokens + temporal_self_attention_video(
        p.attn_self_temp, nt, ADAPTER_HEADS, causal=True, use_kernel=use_flash)
    return tokens.reshape(b, f, h, w, c) + conv


def control_adapter_apply(p: ControlAdapter, x_list: Sequence[torch.Tensor],
                          source_hidden_states: Sequence[torch.Tensor],
                          use_flash: bool = True) -> List[torch.Tensor]:
    """Adapt the 12 ControlNet residuals."""
    if len(x_list) != NUM_ADAPTER_BLOCKS or len(source_hidden_states) != NUM_ADAPTER_BLOCKS:
        raise ValueError(f"the adapter takes {NUM_ADAPTER_BLOCKS} residuals and features")
    return [
        adapter_block_apply(p.body[i], x_list[i], source_hidden_states[i], use_flash)
        for i in range(NUM_ADAPTER_BLOCKS)
    ]
