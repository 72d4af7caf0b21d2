"""Swin Transformer backbone of GroundingDINO (port of
motioneditor_tpu/models/swin.py).

``SwinTransformer`` holds its parameters under the official GroundingDINO
checkpoint's names below ``backbone.0.`` (``patch_embed.proj``,
``layers.{i}.blocks.{j}.attn.qkv``, ``layers.{i}.downsample.reduction``,
``norm{i}``; tests/fixtures/manifests/gdino_swint.txt). The relative
position index is a buffer recomputed from the window, not loaded.

The forward is channel-last like JAX's: windows are reshapes, the shifted
window mask is host-side numpy, attention is an fp32 product + softmax
over 49 / 144-token windows, the MLP's GELU is exact.

Variants (the reference's swin_transformer.py:762-786):
  SWIN_T:     embed_dim 96,  depths (2, 2, 6, 2),  heads (3, 6, 12, 24), window 7
  SWIN_B_384: embed_dim 128, depths (2, 2, 18, 2), heads (4, 8, 16, 32), window 12
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motioneditor_tpu_torch.models.layers import conv2d, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 4
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (1, 2, 3)

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2**i)

    @property
    def num_channels(self) -> Tuple[int, ...]:
        return tuple(self.stage_dim(i) for i in self.out_indices)


SWIN_T = SwinConfig()
SWIN_B_384 = SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                        window_size=12)


# ---------------------------------------------------------------------------
# host-side index tables (copies of JAX's)
# ---------------------------------------------------------------------------


def _rel_position_index(window: int) -> np.ndarray:
    """[ws*ws, ws*ws] index into the (2w-1)^2 bias table
    (swin_transformer.py:114-124)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, n, n]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def _shift_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """Additive attention mask [nW, n, n] of the shifted windows
    (swin_transformer.py:231-249)."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws_ in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws_] = cnt
            cnt += 1
    win = (img.reshape(hp // window, window, wp // window, window)
           .transpose(0, 2, 1, 3).reshape(-1, window * window))
    diff = win[:, None, :] != win[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the module (the checkpoint's names below backbone.0.)
# ---------------------------------------------------------------------------


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_position_index(window).reshape(-1)),
                             persistent=False)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class SwinTransformer(nn.Module):
    def __init__(self, config: SwinConfig = SWIN_T):
        super().__init__()
        self.config = c = config
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, c.embed_dim, c.patch_size, stride=c.patch_size)
        self.patch_embed.norm = nn.LayerNorm(c.embed_dim)
        self.layers = nn.ModuleList()
        for i in range(c.num_stages):
            stage = nn.Module()
            stage.blocks = nn.ModuleList([
                SwinBlock(c.stage_dim(i), c.num_heads[i], c.window_size, c.mlp_ratio)
                for _ in range(c.depths[i])])
            if i < c.num_stages - 1:  # PatchMerging after stages 0 .. n-2
                stage.downsample = PatchMerging(c.stage_dim(i))
            self.layers.append(stage)
        for i in c.out_indices:
            setattr(self, f"norm{i}", nn.LayerNorm(c.stage_dim(i)))


@torch.no_grad()
def init_swin(model: SwinTransformer, generator: torch.Generator) -> SwinTransformer:
    """Random init with JAX's rules (init_swin): ``layers.init_params``, the
    bias tables truncated normal (std 0.02, cut at 2 std)."""
    from motioneditor_tpu_torch.models.layers import init_params

    init_params(model, generator)
    for m in model.modules():
        if isinstance(m, WindowAttention):
            t = m.relative_position_bias_table
            t.copy_(0.02 * truncated_normal(t.shape, generator, t.device))
    return model


def truncated_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal draws cut to [-2, 2] by redrawing."""
    out = torch.randn(shape, generator=generator, device=device)
    bad = out.abs() > 2.0
    while bool(bad.any()):
        out[bad] = torch.randn(int(bad.sum()), generator=generator, device=device)
        bad = out.abs() > 2.0
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def window_attention(p: WindowAttention, x: torch.Tensor,
                     mask: Optional[np.ndarray]) -> torch.Tensor:
    """x: [B_, n, C] windows; mask: additive [nW, n, n] or None."""
    b_, n, c = x.shape
    heads = p.heads
    d = c // heads
    qkv = linear(p.qkv, x).reshape(b_, n, 3, heads, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B_, H, n, d]
    s = torch.matmul((q * (d**-0.5)).float(), k.float().transpose(-1, -2))
    bias = p.relative_position_bias_table[p.relative_position_index]
    s = s + bias.reshape(n, n, heads).permute(2, 0, 1).float()[None]
    if mask is not None:
        nw = mask.shape[0]
        m = torch.as_tensor(mask, device=x.device)
        s = (s.reshape(b_ // nw, nw, heads, n, n) + m[None, :, None]).reshape(b_, heads, n, n)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).transpose(1, 2)
    return linear(p.proj, out.reshape(b_, n, c))


def swin_block(p: SwinBlock, x: torch.Tensor, h: int, w: int, shift: int) -> torch.Tensor:
    """x: [B, H*W, C]: pre-norm windowed attention and MLP with residuals
    (swin_transformer.py:252-307); the map padded to whole windows."""
    b, _, c = x.shape
    window = p.attn.window
    shortcut = x
    x = layer_norm(p.norm1, x).reshape(b, h, w, c)
    hp = int(math.ceil(h / window)) * window
    wp = int(math.ceil(w / window)) * window
    x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = _shift_mask(hp, wp, window, shift)
    else:
        mask = None
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)
    x = window_attention(p.attn, x, mask)
    x = x.reshape(b, hp // window, wp // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = x[:, :h, :w].reshape(b, h * w, c)
    x = shortcut + x
    y = layer_norm(p.norm2, x)
    return x + linear(p.mlp.fc2, F.gelu(linear(p.mlp.fc1, y)))


def patch_merging(p: PatchMerging, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*W, C] -> [B, ceil(H/2) * ceil(W/2), 2C] (swin_transformer.py:310-345)."""
    b, _, c = x.shape
    x = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1).reshape(b, -1, 4 * c)
    return linear(p.reduction, layer_norm(p.norm, x))


def swin_apply(model: SwinTransformer, images: torch.Tensor) -> List[torch.Tensor]:
    """images: [B, H, W, 3] -> [B, Hi, Wi, Ci] feature maps of
    ``config.out_indices`` (strides 8 / 16 / 32 for (1, 2, 3))."""
    c = model.config
    x = conv2d(model.patch_embed.proj, images, stride=c.patch_size, padding="VALID")
    b, h, w, ch = x.shape
    x = layer_norm(model.patch_embed.norm, x.reshape(b, h * w, ch))
    outs = []
    for i, stage in enumerate(model.layers):
        for j, blk in enumerate(stage.blocks):
            shift = 0 if j % 2 == 0 else c.window_size // 2
            if min(h, w) <= c.window_size:  # one window covers the map: no shift
                shift = 0
            x = swin_block(blk, x, h, w, shift)
        if i in c.out_indices:
            y = layer_norm(getattr(model, f"norm{i}"), x)
            outs.append(y.reshape(b, h, w, c.stage_dim(i)))
        if hasattr(stage, "downsample"):
            x = patch_merging(stage.downsample, x, h, w)
            h, w = (h + 1) // 2, (w + 1) // 2
    return outs
