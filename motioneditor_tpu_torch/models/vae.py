"""AutoencoderKL, the SD-1.5 VAE (port of motioneditor_tpu/models/vae.py).

``AutoencoderKL`` holds the parameters under the diffusers key names of a
real SD-1.5 ``vae`` checkpoint, the legacy mid-block attention names
``query`` / ``key`` / ``value`` / ``proj_attn`` included
(tests/fixtures/manifests/sd15_vae.txt); the functions compute on NHWC
images exactly as the JAX functions of the same names do. Frames fold into
the batch: the VAE is per frame.

SD-1.5 config: block_out_channels (128, 256, 512, 512), 2 resnets per
block, one single-head attention in each mid block, GroupNorm(32, eps 1e-6),
4 latent channels, scaling factor 0.18215.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from motioneditor_tpu_torch.models.layers import (
    conv2d,
    downsample_conv2d_2x,
    group_norm,
    linear,
    upsample_conv2d_2x,
)
from motioneditor_tpu_torch.models.unet import ConvHolder
from motioneditor_tpu_torch.ops.attention import attention_probs

SCALING_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6


class VAEResnet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, c: VAEConfig):
        super().__init__()
        self.norm1 = nn.GroupNorm(c.norm_num_groups, in_ch, c.norm_eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3)
        self.norm2 = nn.GroupNorm(c.norm_num_groups, out_ch, c.norm_eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)


class VAEAttention(nn.Module):
    """Single-head attention with biased projections (legacy key names)."""

    def __init__(self, ch: int, c: VAEConfig):
        super().__init__()
        self.group_norm = nn.GroupNorm(c.norm_num_groups, ch, c.norm_eps)
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.proj_attn = nn.Linear(ch, ch)


class VAEBlock(nn.Module):
    def __init__(self, chans, c: VAEConfig, attention: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(i, o, c) for i, o in chans])
        if attention:
            self.attentions = nn.ModuleList([VAEAttention(chans[-1][1], c)])


def _half(conv_in: Tuple[int, int], conv_out: Tuple[int, int], norm_ch: int, mid_ch: int,
          c: VAEConfig) -> nn.Module:
    m = nn.Module()
    m.conv_in = nn.Conv2d(*conv_in, 3)
    m.mid_block = VAEBlock([(mid_ch, mid_ch)] * 2, c, attention=True)
    m.conv_norm_out = nn.GroupNorm(c.norm_num_groups, norm_ch, c.norm_eps)
    m.conv_out = nn.Conv2d(*conv_out, 3)
    return m


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        c = config
        ch = c.block_out_channels
        self.encoder = _half((c.in_channels, ch[0]), (ch[-1], 2 * c.latent_channels), ch[-1],
                             ch[-1], c)
        self.encoder.down_blocks = nn.ModuleList()
        out_ch = ch[0]
        for i, o in enumerate(ch):
            in_ch, out_ch = out_ch, o
            block = VAEBlock([(in_ch if j == 0 else out_ch, out_ch)
                              for j in range(c.layers_per_block)], c)
            if i < len(ch) - 1:
                block.downsamplers = nn.ModuleList([ConvHolder(out_ch)])
            self.encoder.down_blocks.append(block)
        self.decoder = _half((c.latent_channels, ch[-1]), (ch[0], c.out_channels), ch[0],
                             ch[-1], c)
        self.decoder.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        out_ch = rev[0]
        for i, o in enumerate(rev):
            in_ch, out_ch = out_ch, o
            block = VAEBlock([(in_ch if j == 0 else out_ch, out_ch)
                              for j in range(c.layers_per_block + 1)], c)
            if i < len(rev) - 1:
                block.upsamplers = nn.ModuleList([ConvHolder(out_ch)])
            self.decoder.up_blocks.append(block)
        self.quant_conv = nn.Conv2d(2 * c.latent_channels, 2 * c.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(c.latent_channels, c.latent_channels, 1)


def _resnet(p: VAEResnet, x, c: VAEConfig):
    h = conv2d(p.conv1, group_norm(p.norm1, x, c.norm_num_groups, c.norm_eps, silu=True),
               padding=1)
    h = conv2d(p.conv2, group_norm(p.norm2, h, c.norm_num_groups, c.norm_eps, silu=True),
               padding=1)
    skip = conv2d(p.conv_shortcut, x, padding=0) if hasattr(p, "conv_shortcut") else x
    return skip + h


def _attention(p: VAEAttention, x, c: VAEConfig):
    """Single-head spatial self-attention, scale c**-0.5, fp32 softmax."""
    b, h, w, ch = x.shape
    n = group_norm(p.group_norm, x, c.norm_num_groups, c.norm_eps).reshape(b, h * w, ch)
    q, k, v = linear(p.query, n), linear(p.key, n), linear(p.value, n)
    out = torch.matmul(attention_probs(q, k, ch ** -0.5).to(v.dtype), v)
    return x + linear(p.proj_attn, out).reshape(b, h, w, ch)


def _mid(p: VAEBlock, x, c: VAEConfig):
    x = _resnet(p.resnets[0], x, c)
    x = _attention(p.attentions[0], x, c)
    return _resnet(p.resnets[1], x, c)


def vae_encode_moments(vae: AutoencoderKL, images: torch.Tensor,
                       config: VAEConfig = VAEConfig()):
    """images: [N, H, W, 3] in [-1, 1] -> (mean, logvar) each [N, h, w, 4],
    logvar clipped to [-30, 20]."""
    c, e = config, vae.encoder
    x = conv2d(e.conv_in, images, padding=1)
    for block in e.down_blocks:
        for rp in block.resnets:
            x = _resnet(rp, x, c)
        if hasattr(block, "downsamplers"):
            x = downsample_conv2d_2x(block.downsamplers[0].conv, x)
    x = _mid(e.mid_block, x, c)
    x = group_norm(e.conv_norm_out, x, c.norm_num_groups, c.norm_eps, silu=True)
    moments = conv2d(vae.quant_conv, conv2d(e.conv_out, x, padding=1), padding=0)
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def _sample(mean: torch.Tensor, logvar: torch.Tensor,
            noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The diagonal Gaussian's sample at ``noise`` (its mean without), times
    0.18215."""
    if noise is not None:
        mean = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
    return mean * SCALING_FACTOR


def vae_encode(vae: AutoencoderKL, images: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               config: VAEConfig = VAEConfig()) -> torch.Tensor:
    """The diagonal Gaussian's sample drawn from ``generator`` (its mean
    without one) times 0.18215."""
    mean, logvar = vae_encode_moments(vae, images, config)
    noise = None
    if generator is not None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return _sample(mean, logvar, noise)


def vae_decode(vae: AutoencoderKL, latents: torch.Tensor,
               config: VAEConfig = VAEConfig()) -> torch.Tensor:
    """latents: [N, h, w, 4] (scaled) -> images [N, H, W, 3] in [-1, 1]."""
    c, d = config, vae.decoder
    z = conv2d(vae.post_quant_conv, latents / SCALING_FACTOR, padding=0)
    x = _mid(d.mid_block, conv2d(d.conv_in, z, padding=1), c)
    for block in d.up_blocks:
        for rp in block.resnets:
            x = _resnet(rp, x, c)
        if hasattr(block, "upsamplers"):
            x = upsample_conv2d_2x(block.upsamplers[0].conv, x)
    x = group_norm(d.conv_norm_out, x, c.norm_num_groups, c.norm_eps, silu=True)
    return conv2d(d.conv_out, x, padding=1)


def vae_encode_video(vae: AutoencoderKL, video: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     config: VAEConfig = VAEConfig(), shard_ctx=None) -> torch.Tensor:
    """[B, F, H, W, 3] -> [B, F, h, w, 4]; frames fold into the batch.
    ``shard_ctx``: ``video`` holds this rank's frames of the clip (the
    batch whole); the posterior noise is drawn at the whole clip's shape
    and this rank's frames of it taken, so the ranks together sample what
    one unsharded encode does."""
    b, f = video.shape[:2]
    mean, logvar = (t.reshape(b, f, *t.shape[1:]) for t in vae_encode_moments(
        vae, video.reshape(b * f, *video.shape[2:]), config))
    noise = None
    if generator is not None:
        fp = 1 if shard_ctx is None else shard_ctx.fp
        noise = torch.randn((b, f * fp, *mean.shape[2:]), generator=generator,
                            device=mean.device)
        if shard_ctx is not None:
            from motioneditor_tpu_torch.parallel.mesh import shard_video

            noise = shard_video(noise, shard_ctx, branch_axis=True)
    return _sample(mean, logvar, noise)


def vae_decode_video(vae: AutoencoderKL, latents: torch.Tensor,
                     config: VAEConfig = VAEConfig()) -> torch.Tensor:
    """[B, F, h, w, 4] -> [B, F, H, W, 3] in [-1, 1]."""
    b, f = latents.shape[:2]
    img = vae_decode(vae, latents.reshape(b * f, *latents.shape[2:]), config=config)
    return img.reshape(b, f, *img.shape[1:])
