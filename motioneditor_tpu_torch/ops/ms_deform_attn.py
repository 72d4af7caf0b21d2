"""Multi-scale deformable attention (port of
motioneditor_tpu/ops/ms_deform_attn.py).

The core of GroundingDINO's deformable encoder self-attention and decoder
cross-attention (models/grounding_dino.py ``_msdeform_apply``): per-level
value maps sampled bilinearly at predicted locations (``align_corners=False``,
zero padding), then summed over levels and points with the attention
weights. Semantics of the reference's PyTorch fallback
``multi_scale_deformable_attn_pytorch``.

The JAX package computes this with XLA gathers, not a Pallas kernel, so the
port is plain PyTorch: the same four-corner gather, op for op.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def bilinear_sample(value: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``grid_sample(mode="bilinear", padding_mode="zeros",
    align_corners=False)`` on channel-last maps.

    value: [N, H, W, C]; grid: [N, P, 2] normalized to [-1, 1] as (x, y).
    Returns [N, P, C]."""
    n, h, w, c = value.shape
    x = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5
    y = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat = value.reshape(n, h * w, c)

    def gather(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = xi.clamp(0, w - 1).long()
        yi_c = yi.clamp(0, h - 1).long()
        idx = (yi_c * w + xi_c)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx) * inside[..., None].to(value.dtype)

    return (gather(y0, x0) * (wy0 * wx0)[..., None]
            + gather(y0, x1) * (wy0 * wx1)[..., None]
            + gather(y1, x0) * (wy1 * wx0)[..., None]
            + gather(y1, x1) * (wy1 * wx1)[..., None])


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value: [B, sum(H_l * W_l), heads, dim]; spatial_shapes: (H_l, W_l)
    per level; sampling_locations: [B, Nq, heads, L, P, 2] in [0, 1];
    attention_weights: [B, Nq, heads, L, P]. Returns [B, Nq, heads * dim]."""
    b, _, heads, dim = value.shape
    _, nq, _, _, num_points, _ = sampling_locations.shape
    values = value.split([h * w for h, w in spatial_shapes], dim=1)
    outputs = []
    for lvl, (hl, wl) in enumerate(spatial_shapes):
        v = values[lvl].reshape(b, hl, wl, heads, dim)
        v = v.permute(0, 3, 1, 2, 4).reshape(b * heads, hl, wl, dim)
        grid = 2.0 * sampling_locations[:, :, :, lvl] - 1.0  # [B, Nq, heads, P, 2]
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * heads, nq * num_points, 2)
        sampled = bilinear_sample(v, grid)  # [B * heads, Nq * P, dim]
        outputs.append(sampled.reshape(b, heads, nq, num_points, dim))
    stacked = torch.stack(outputs, dim=3)  # [B, heads, Nq, L, P, dim]
    weights = attention_weights.permute(0, 2, 1, 3, 4)  # [B, heads, Nq, L, P]
    out = (stacked * weights[..., None]).sum(dim=(3, 4))  # [B, heads, Nq, dim]
    return out.permute(0, 2, 1, 3).reshape(b, nq, heads * dim)
