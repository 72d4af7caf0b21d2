"""Video-inflated SD-1.5 UNet with ControlNet residuals and the motion
adapter (port of motioneditor_tpu/models/unet.py, inference forward).

``UNet3DConditionModel`` holds the parameters under diffusers key names
(plus the reference's temporal modules ``temp_conv1/2``, ``attn_temp``,
``norm_temp`` and the ``controlnet_adapter``); ``unet_apply`` and the block
functions compute the forward on [B, F, H, W, C] videos exactly as the JAX
functions of the same names do. The branch convention is a size-4 leading
axis [recon_u, edit_u, recon_c, edit_c].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from motioneditor_tpu_torch.control.injection import (
    InjectionSpec,
    injected_spatial_attention,
    injected_temporal_kv,
)
from motioneditor_tpu_torch.models.layers import (
    FeedForward,
    TimestepEmbedding,
    feed_forward,
    group_norm,
    inflated_conv3d,
    layer_norm,
    linear,
    silu,
    sinusoidal_timestep_embedding,
    temporal_conv,
    timestep_embedding_mlp,
    upsample_conv3d_2x,
    zero_init,
)
from motioneditor_tpu_torch.ops.attention import (
    DENSE,
    MOTION_FRAME,
    NORMAL,
    Attention,
    cross_attention,
    spatial_self_attention,
    temporal_self_attention_video,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static architecture config: the same fields and defaults as the JAX
    ``UNetConfig`` (SD-1.5 plus the video flags)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_heads: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_norm_eps: float = 1e-6
    use_sc_attn: bool = True
    use_st_attn: bool = False
    st_attn_idx: int = 0
    video: bool = True  # include temporal modules

    @property
    def down_block_types(self) -> Tuple[str, ...]:
        return ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)

    @property
    def up_block_types(self) -> Tuple[str, ...]:
        return ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3

    def attn1_mode(self, use_st: bool) -> str:
        if use_st:
            return DENSE
        if self.use_sc_attn:
            return MOTION_FRAME
        return NORMAL


# ---------------------------------------------------------------------------
# parameter containers
# ---------------------------------------------------------------------------


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, groups: int, eps: float,
                 video: bool):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3)
        if temb_ch:
            self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)
        if video:
            # zero-init temporal convs: the inflated UNet starts per-frame
            self.temp_conv1 = zero_init(nn.Conv1d(out_ch, out_ch, 3))
            self.temp_conv2 = zero_init(nn.Conv1d(out_ch, out_ch, 3))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, cross_dim: int, heads: int, video: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads=heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, cross_dim=cross_dim, heads=heads)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)
        if video:
            self.norm_temp = nn.LayerNorm(dim)
            self.attn_temp = Attention(dim, heads=heads, zero_out=True)


class Transformer2D(nn.Module):
    def __init__(self, channels: int, cross_dim: int, heads: int, groups: int, eps: float,
                 video: bool):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, cross_dim, heads, video)])
        self.proj_out = nn.Conv2d(channels, channels, 1)


class ConvHolder(nn.Module):
    """diffusers Downsample2D / Upsample2D: one ``conv``."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3)


class Block(nn.Module):
    """A down, mid or up block: resnets, optional attentions and resampler."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


def build_encoder(m: nn.Module, c: UNetConfig) -> None:
    """conv_in, time_embedding, down_blocks, mid_block (shared with ControlNet)."""
    time_dim = c.block_out_channels[0] * 4
    g, eps, teps = c.norm_num_groups, c.norm_eps, c.transformer_norm_eps
    m.conv_in = nn.Conv2d(c.in_channels, c.block_out_channels[0], 3)
    m.time_embedding = TimestepEmbedding(c.block_out_channels[0], time_dim)
    m.down_blocks = nn.ModuleList()
    out_ch = c.block_out_channels[0]
    for i, btype in enumerate(c.down_block_types):
        in_ch, out_ch = out_ch, c.block_out_channels[i]
        block = Block()
        for j in range(c.layers_per_block):
            block.resnets.append(ResnetBlock(in_ch if j == 0 else out_ch, out_ch, time_dim,
                                             g, eps, c.video))
            if btype == "CrossAttnDownBlock2D":
                block.attentions.append(Transformer2D(
                    out_ch, c.cross_attention_dim, c.attention_heads, g, teps, c.video))
        if i < len(c.block_out_channels) - 1:
            block.downsamplers = nn.ModuleList([ConvHolder(out_ch)])
        m.down_blocks.append(block)
    mid_ch = c.block_out_channels[-1]
    m.mid_block = Block()
    for _ in range(2):
        m.mid_block.resnets.append(ResnetBlock(mid_ch, mid_ch, time_dim, g, eps, c.video))
    m.mid_block.attentions.append(Transformer2D(
        mid_ch, c.cross_attention_dim, c.attention_heads, g, teps, c.video))


class UNet3DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig, include_adapter: bool = True):
        super().__init__()
        from motioneditor_tpu_torch.models.adapter import ControlAdapter

        c = config
        build_encoder(self, c)
        time_dim = c.block_out_channels[0] * 4
        g, eps, teps = c.norm_num_groups, c.norm_eps, c.transformer_norm_eps
        rev = list(reversed(c.block_out_channels))
        self.up_blocks = nn.ModuleList()
        out_ch = rev[0]
        for i, btype in enumerate(c.up_block_types):
            prev_out, out_ch = out_ch, rev[i]
            in_ch = rev[min(i + 1, len(rev) - 1)]
            block = Block()
            for j in range(c.layers_per_block + 1):
                res_skip = in_ch if j == c.layers_per_block else out_ch
                r_in = prev_out if j == 0 else out_ch
                block.resnets.append(ResnetBlock(r_in + res_skip, out_ch, time_dim, g, eps,
                                                 c.video))
                if btype == "CrossAttnUpBlock2D":
                    block.attentions.append(Transformer2D(
                        out_ch, c.cross_attention_dim, c.attention_heads, g, teps, c.video))
            if i < len(rev) - 1:
                block.upsamplers = nn.ModuleList([ConvHolder(out_ch)])
            self.up_blocks.append(block)
        self.conv_norm_out = nn.GroupNorm(g, c.block_out_channels[0], eps)
        self.conv_out = nn.Conv2d(c.block_out_channels[0], c.out_channels, 3)
        if include_adapter and c.video:
            self.controlnet_adapter = ControlAdapter(c.block_out_channels)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _gn_per_frame(p, video, groups, eps):
    b, f, h, w, ch = video.shape
    return group_norm(p, video.reshape(b * f, h, w, ch), groups, eps).reshape(video.shape)


def resnet_block(p: ResnetBlock, video, temb, *, groups=32, eps=1e-5,
                 per_frame_gn: bool = False):
    """Video resnet; zero-init temporal convs are residual adds after each
    spatial conv. GroupNorm pools across frames unless ``per_frame_gn``
    (the per-frame 2D ControlNet)."""
    def gn(norm, x):
        if per_frame_gn:
            return _gn_per_frame(norm, x, groups, eps)
        return group_norm(norm, x, groups, eps)

    h = inflated_conv3d(p.conv1, silu(gn(p.norm1, video)), padding=1)
    if hasattr(p, "temp_conv1"):
        h = h + temporal_conv(p.temp_conv1, h)
    if temb is not None and hasattr(p, "time_emb_proj"):
        t = linear(p.time_emb_proj, silu(temb))  # [B, C]
        h = h + t[:, None, None, None, :]
    h = inflated_conv3d(p.conv2, silu(gn(p.norm2, h)), padding=1)
    if hasattr(p, "temp_conv2"):
        h = h + temporal_conv(p.temp_conv2, h)
    skip = video
    if hasattr(p, "conv_shortcut"):
        skip = inflated_conv3d(p.conv_shortcut, skip, padding=0)
    return skip + h


@dataclasses.dataclass
class AttnContext:
    """Per-call context threaded through the transformer blocks."""

    encoder_hidden_states: torch.Tensor  # [B, L, D_text]
    heads: int
    injection: Optional[InjectionSpec] = None
    injection_masks: Optional[Dict[Tuple[int, int], torch.Tensor]] = None
    use_flash: bool = True


def basic_transformer_block(p: BasicTransformerBlock, tokens, ctx: AttnContext,
                            layer_idx: int, hw: Tuple[int, int], attn1_mode: str):
    """tokens: [B, F, N, C]. attn1 -> attn2 -> ff -> temporal attention."""
    inj = ctx.injection
    spatial_gate = inj is not None and inj.active and inj.spatial_layers[layer_idx]
    temporal_gate = inj is not None and inj.active and inj.temporal_layers[layer_idx]

    h = layer_norm(p.norm1, tokens)
    if spatial_gate:
        if inj.mask_mode not in ("mask", "mutual"):
            raise NotImplementedError(f"injection mask_mode {inj.mask_mode!r}")
        mask_n = None if ctx.injection_masks is None else ctx.injection_masks.get(hw)
        attn1_out = injected_spatial_attention(p.attn1, h, ctx.heads, mask_n, inj.mask_fgbg,
                                               use_flash=ctx.use_flash)
    else:
        attn1_out = spatial_self_attention(p.attn1, h, attn1_mode, ctx.heads,
                                           use_flash=ctx.use_flash)
    # plain add + LN: what JAX runs, its fused add+LN kernel being off by default
    tokens = tokens + attn1_out
    h = layer_norm(p.norm2, tokens)
    tokens = tokens + cross_attention(p.attn2, h, ctx.encoder_hidden_states, ctx.heads)
    h = layer_norm(p.norm3, tokens)
    ff_out = feed_forward(p.ff, h)
    if hasattr(p, "attn_temp"):
        tokens = tokens + ff_out
        ht = layer_norm(p.norm_temp, tokens)
        kv_override = injected_temporal_kv(ht) if temporal_gate else None
        tokens = tokens + temporal_self_attention_video(
            p.attn_temp, ht, ctx.heads, causal=True, kv_override=kv_override,
            use_kernel=ctx.use_flash)
    else:
        tokens = tokens + ff_out
    return tokens


def transformer2d(p: Transformer2D, video, ctx: AttnContext, layer_idx: int,
                  attn1_mode: str, groups=32, eps=1e-6):
    """Per-frame GN -> 1x1 conv in -> transformer block -> 1x1 conv out + residual."""
    b, f, h, w, c = video.shape
    x = _gn_per_frame(p.norm, video, groups, eps)
    x = inflated_conv3d(p.proj_in, x, padding=0)
    tokens = x.reshape(b, f, h * w, c)
    for bp in p.transformer_blocks:
        tokens = basic_transformer_block(bp, tokens, ctx, layer_idx, (h, w), attn1_mode)
    x = inflated_conv3d(p.proj_out, tokens.reshape(b, f, h, w, c), padding=0)
    return x + video


def time_embedding(m: nn.Module, config: UNetConfig, timesteps, batch: int, dtype):
    """Sinusoidal embedding + MLP for an int or a [B] tensor of timesteps."""
    device = m.conv_in.weight.device
    t = torch.as_tensor(timesteps, device=device)
    if t.dim() == 0:
        t = t.expand(batch)
    t_emb = sinusoidal_timestep_embedding(t, config.block_out_channels[0])
    return timestep_embedding_mlp(m.time_embedding, t_emb.to(dtype))


def unet_apply(
    model: UNet3DConditionModel,
    config: UNetConfig,
    sample: torch.Tensor,
    timesteps,
    encoder_hidden_states: torch.Tensor,
    *,
    normal_infer: bool = False,
    injection: Optional[InjectionSpec] = None,
    injection_masks: Optional[Dict[Tuple[int, int], torch.Tensor]] = None,
    down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
    mid_block_additional_residual: Optional[torch.Tensor] = None,
    use_flash: bool = True,
) -> torch.Tensor:
    """Full UNet forward. sample: [B, F, H, W, C_in]; timesteps: scalar or
    [B]; encoder_hidden_states: [B, L, D_text].

    ControlNet residuals: 12 down + mid. With a 4-row branch axis and a
    4-row mid residual, the residuals are the 2-row edit-branch ControlNet
    outputs: the adapter runs on rows [1, 3] against those rows' UNet
    features and the recon rows get zero residuals. Otherwise the adapter
    consumes them against the UNet's own features."""
    from motioneditor_tpu_torch.models.adapter import control_adapter_apply

    c = config
    b = sample.shape[0]
    temb = time_embedding(model, c, timesteps, b, sample.dtype)
    ctx = AttnContext(encoder_hidden_states=encoder_hidden_states, heads=c.attention_heads,
                      injection=injection, injection_masks=injection_masks,
                      use_flash=use_flash)

    def mode_for(use_st: bool) -> str:
        return NORMAL if normal_infer else c.attn1_mode(use_st)

    def res(rp, hh):
        return resnet_block(rp, hh, temb, groups=c.norm_num_groups, eps=c.norm_eps)

    def t2d(bp, hh, layer, mode):
        return transformer2d(bp, hh, ctx, layer, mode, groups=c.norm_num_groups,
                             eps=c.transformer_norm_eps)

    h = inflated_conv3d(model.conv_in, sample, padding=1)
    res_samples: List[torch.Tensor] = [h]
    layer_idx = 0
    for i, block in enumerate(model.down_blocks):
        for j, rp in enumerate(block.resnets):
            h = res(rp, h)
            if len(block.attentions):
                use_st = c.use_st_attn and i == c.st_attn_idx and j == 0
                h = t2d(block.attentions[j], h, layer_idx, mode_for(use_st))
                layer_idx += 1
            res_samples.append(h)
        if hasattr(block, "downsamplers"):
            h = inflated_conv3d(block.downsamplers[0].conv, h, stride=2, padding=1)
            res_samples.append(h)

    if down_block_additional_residuals is not None:
        residuals = list(down_block_additional_residuals)
        mid_res = mid_block_additional_residual
        if mid_res is not None and mid_res.shape[0] == 4:
            edit_rows = [1, 3]
            motion = control_adapter_apply(model.controlnet_adapter, residuals,
                                           [s[edit_rows] for s in res_samples],
                                           use_flash=use_flash)
            residuals = []
            for m in motion:
                z = torch.zeros_like(m[:1])
                residuals.append(torch.cat([z, m[:1], z, m[1:2]], dim=0))
        else:
            residuals = control_adapter_apply(model.controlnet_adapter, residuals,
                                              res_samples, use_flash=use_flash)
        res_samples = [r + d for r, d in zip(res_samples, residuals)]

    mb = model.mid_block
    h = res(mb.resnets[0], h)
    h = t2d(mb.attentions[0], h, layer_idx, mode_for(c.use_st_attn))
    layer_idx += 1
    h = res(mb.resnets[1], h)
    if mid_block_additional_residual is not None:
        h = h + mid_block_additional_residual

    for i, block in enumerate(model.up_blocks):
        n_res = len(block.resnets)
        skips = res_samples[-n_res:]
        res_samples = res_samples[:-n_res]
        for j, rp in enumerate(block.resnets):
            h = res(rp, torch.cat([h, skips[-(j + 1)]], dim=-1))
            if len(block.attentions):
                use_st = c.use_st_attn and (i - 1) == c.st_attn_idx and j == 0
                h = t2d(block.attentions[j], h, layer_idx, mode_for(use_st))
                layer_idx += 1
        if hasattr(block, "upsamplers"):
            h = upsample_conv3d_2x(block.upsamplers[0].conv, h)

    # the final GN pools across frames too
    h = silu(group_norm(model.conv_norm_out, h, c.norm_num_groups, c.norm_eps))
    return inflated_conv3d(model.conv_out, h, padding=1)
