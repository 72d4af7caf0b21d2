"""ControlNet (openpose), the per-frame 2D conditioning network
(port of motioneditor_tpu/models/controlnet.py).

The SD encoder (no temporal modules), zero-init output convs and the
conditioning-image embedding CNN. GroupNorm in its resnets is per frame.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch import nn

from motioneditor_tpu_torch.models.layers import (
    conv2d,
    inflated_conv3d,
    silu,
    zero_init,
)
from motioneditor_tpu_torch.models.unet import (
    AttnContext,
    UNetConfig,
    build_encoder,
    refuse_text_time,
    resnet_block,
    time_embedding,
    transformer2d,
)
from motioneditor_tpu_torch.ops.attention import NORMAL
from motioneditor_tpu_torch.utils.profiling import spanned

COND_EMBED_CHANNELS = (16, 32, 96, 256)


def controlnet_config(unet_config: UNetConfig = UNetConfig()) -> UNetConfig:
    refuse_text_time(unet_config, "the ControlNet")
    return dataclasses.replace(unet_config, video=False, use_sc_attn=False,
                               use_st_attn=False)


class CondEmbedding(nn.Module):
    """diffusers ControlNetConditioningEmbedding."""

    def __init__(self, out_ch: int):
        super().__init__()
        ch = COND_EMBED_CHANNELS
        self.conv_in = nn.Conv2d(3, ch[0], 3)
        self.blocks = nn.ModuleList()
        for i in range(len(ch) - 1):
            self.blocks.append(nn.Conv2d(ch[i], ch[i], 3))
            self.blocks.append(nn.Conv2d(ch[i], ch[i + 1], 3))  # stride 2
        self.conv_out = zero_init(nn.Conv2d(ch[-1], out_ch, 3))


class ControlNetModel(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        if config.video:
            raise ValueError("the ControlNet is 2D: use controlnet_config()")
        refuse_text_time(config, "the ControlNet")
        build_encoder(self, config)
        c0 = config.block_out_channels[0]
        self.controlnet_cond_embedding = CondEmbedding(c0)
        chans = [c0]
        for i, ch in enumerate(config.block_out_channels):
            chans += [ch] * config.layers_per_block
            if i < len(config.block_out_channels) - 1:
                chans.append(ch)
        self.controlnet_down_blocks = nn.ModuleList(
            [zero_init(nn.Conv2d(ch, ch, 1)) for ch in chans])
        mid = config.block_out_channels[-1]
        self.controlnet_mid_block = zero_init(nn.Conv2d(mid, mid, 1))


def _cond_embedding(p: CondEmbedding, image: torch.Tensor) -> torch.Tensor:
    """image: [N, H, W, 3] in [0, 1] -> [N, H/8, W/8, C0]."""
    x = silu(conv2d(p.conv_in, image, padding=1))
    for i, conv in enumerate(p.blocks):
        x = silu(conv2d(conv, x, stride=2 if i % 2 == 1 else 1, padding=1))
    return conv2d(p.conv_out, x, padding=1)


def precompute_cond_embedding(model: ControlNetModel, controlnet_cond: torch.Tensor):
    """Embed the conditioning images once, outside the step loop (they are
    constant across steps). [B, F, H, W, 3] -> [B, F, H/8, W/8, C0]."""
    b, f = controlnet_cond.shape[:2]
    emb = _cond_embedding(model.controlnet_cond_embedding,
                          controlnet_cond.reshape(b * f, *controlnet_cond.shape[2:]))
    return emb.reshape(b, f, *emb.shape[1:])


@spanned("me.controlnet")
def controlnet_apply(
    model: ControlNetModel,
    config: UNetConfig,
    sample: torch.Tensor,
    timesteps,
    encoder_hidden_states: torch.Tensor,
    cond_embedding: torch.Tensor,
    conditioning_scale: float = 1.0,
    use_flash: bool = True,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run the ControlNet per frame. sample: [B, F, h, w, 4]; cond_embedding
    from ``precompute_cond_embedding``. Returns (12 down residuals, mid
    residual) as [B, F, ...] videos."""
    c = config
    b = sample.shape[0]
    temb = time_embedding(model, c, timesteps, b, sample.dtype)
    ctx = AttnContext(encoder_hidden_states=encoder_hidden_states, use_flash=use_flash)

    def res(rp, hh):
        return resnet_block(rp, hh, temb, groups=c.norm_num_groups, eps=c.norm_eps,
                            per_frame_gn=True)

    def t2d(bp, hh, layer):
        return transformer2d(bp, hh, ctx, layer, NORMAL, groups=c.norm_num_groups,
                             eps=c.transformer_norm_eps)

    h = inflated_conv3d(model.conv_in, sample, padding=1)
    h = h + cond_embedding.reshape(h.shape)
    res_samples = [h]
    layer_idx = 0
    for block in model.down_blocks:
        for j, rp in enumerate(block.resnets):
            h = res(rp, h)
            if len(block.attentions):
                h = t2d(block.attentions[j], h, layer_idx)
                layer_idx += 1
            res_samples.append(h)
        if hasattr(block, "downsamplers"):
            h = inflated_conv3d(block.downsamplers[0].conv, h, stride=2, padding=1)
            res_samples.append(h)
    mb = model.mid_block
    h = res(mb.resnets[0], h)
    h = t2d(mb.attentions[0], h, layer_idx)
    h = res(mb.resnets[1], h)

    down_out = [inflated_conv3d(zc, r, padding=0) * conditioning_scale
                for r, zc in zip(res_samples, model.controlnet_down_blocks)]
    mid_out = inflated_conv3d(model.controlnet_mid_block, h, padding=0) * conditioning_scale
    return down_out, mid_out
