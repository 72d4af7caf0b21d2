"""NN primitives on channel-last tensors (port of motioneditor_tpu/models/layers.py).

Parameters live in ``nn.Module`` containers with diffusers key names
(``nn.Linear`` weight [out, in], ``nn.Conv2d`` OIHW, temporal ``nn.Conv1d``
[out, in, K], norms ``weight``/``bias``); the functions below take the
container first, as the JAX functions take their parameter dict, and keep
the JAX layouts: images [N, H, W, C], video [B, F, H, W, C].

Compute follows the JAX forms that run off-TPU: parameters are cast to the
activation dtype; group/layer norm statistics are fp32; ``temporal_conv`` is
a conv over the frame axis; the 2x upsample is nearest-2x then a 3x3 conv.
Convolutions run on channels-last views (a permute, no copy).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def zero_init(m: nn.Module) -> nn.Module:
    """Mark a module whose parameters ``init_params`` sets to zero."""
    m.zero_init = True
    return m


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init with the JAX package's rules (models/layers.py init_*):
    linear and conv weights and biases uniform in +-1/sqrt(fan_in); norms
    ones / zeros; temporal convs and modules marked by ``zero_init`` zero.
    Draws from ``generator``, which must live on the parameters' device."""
    for m in model.modules():
        if isinstance(m, nn.Conv1d) or getattr(m, "zero_init", False):
            for t in m.parameters(recurse=False):
                t.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            for t in m.parameters(recurse=False):
                t.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p.weight.to(x.dtype), _cast(p.bias, x.dtype))


def _padding(padding, kernel_size: int):
    if isinstance(padding, int):
        return padding
    if padding == "SAME":
        return (kernel_size - 1) // 2
    if padding == "VALID":
        return 0
    raise ValueError(f"unsupported padding {padding!r}")


def conv2d(p: nn.Conv2d, x: torch.Tensor, stride: int = 1, padding="SAME") -> torch.Tensor:
    """NHWC conv. ``padding`` is "SAME" (stride 1, odd kernel), "VALID" or an int."""
    w = p.weight.to(x.dtype)
    y = F.conv2d(
        x.permute(0, 3, 1, 2), w, _cast(p.bias, x.dtype), stride=stride,
        padding=_padding(padding, w.shape[-1]),
    )
    return y.permute(0, 2, 3, 1)


def inflated_conv3d(p: nn.Conv2d, video: torch.Tensor, stride: int = 1, padding="SAME"):
    """Per-frame 2D conv on [B, F, H, W, C]."""
    b, f, h, w, c = video.shape
    y = conv2d(p, video.reshape(b * f, h, w, c), stride=stride, padding=padding)
    return y.reshape(b, f, *y.shape[1:])


def temporal_conv(p: nn.Conv1d, video: torch.Tensor, padding="SAME") -> torch.Tensor:
    """Conv over the frame axis at every spatial site of [B, F, H, W, C]."""
    b, f, h, w, c = video.shape
    x = video.permute(0, 2, 3, 4, 1).reshape(b * h * w, c, f)
    weight = p.weight.to(video.dtype)
    y = F.conv1d(x, weight, _cast(p.bias, video.dtype),
                 padding=_padding(padding, weight.shape[-1]))
    return y.reshape(b, h, w, c, y.shape[-1]).permute(0, 4, 1, 2, 3)


def group_norm(p: nn.Module, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-6):
    """GroupNorm over [B, ..., C]: fp32 stats per group over every interior
    axis (so on a [B, F, H, W, C] video the stats pool across frames)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out.reshape(x.shape) * p.weight.float() + p.bias.float()
    return out.to(x.dtype)


def layer_norm(p: nn.Module, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channel axis with fp32 statistics."""
    out = F.layer_norm(x.float(), (x.shape[-1],), p.weight.float(), p.bias.float(), eps)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """diffusers FeedForward (GEGLU, mult=4): keys net.0.proj / net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])


def feed_forward(p: FeedForward, x: torch.Tensor) -> torch.Tensor:
    h, gate = linear(p.net[0].proj, x).chunk(2, dim=-1)
    return linear(p.net[2], h * F.gelu(gate))


def sinusoidal_timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """diffusers get_timestep_embedding, SD UNet config (flip=True, shift=0)."""
    half = dim // 2
    freqs = np.exp(
        -math.log(max_period) * np.arange(half, dtype=np.float64) / (half - downscale_freq_shift)
    )
    freqs = torch.as_tensor(freqs, dtype=torch.float32, device=timesteps.device)
    emb = freqs[None, :] * timesteps.float()[:, None]
    two_pi = 2.0 * math.pi
    emb = emb - two_pi * torch.floor(emb / two_pi)
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)


def timestep_embedding_mlp(p: TimestepEmbedding, t_emb: torch.Tensor) -> torch.Tensor:
    return linear(p.linear_2, silu(linear(p.linear_1, t_emb)))


def upsample_conv2d_2x(p: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Nearest-2x upsample then a SAME 3x3 conv: [N, H, W, C] -> [N, 2H, 2W, C']."""
    u = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
    return conv2d(p, u.permute(0, 2, 3, 1), padding=1)


def upsample_conv3d_2x(p: nn.Conv2d, video: torch.Tensor) -> torch.Tensor:
    b, f, h, w, c = video.shape
    y = upsample_conv2d_2x(p, video.reshape(b * f, h, w, c))
    return y.reshape(b, f, *y.shape[1:])


def nearest_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of [..., H, W, C] with torch F.interpolate(mode="nearest")
    index selection (floor of the scaled index, computed in fp32 as JAX does)."""
    h, w = x.shape[-3], x.shape[-2]
    th, tw = size
    rows = torch.floor(torch.arange(th, dtype=torch.float32) * np.float32(h / th)).long()
    cols = torch.floor(torch.arange(tw, dtype=torch.float32) * np.float32(w / tw)).long()
    x = x.index_select(-3, rows.to(x.device))
    return x.index_select(-2, cols.to(x.device))
