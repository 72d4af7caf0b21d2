"""Video-inflated SD-1.5 UNet with ControlNet residuals and the motion
adapter (port of motioneditor_tpu/models/unet.py), and SDXL's UNet
inflated the same way (per-level transformer depth and heads, linear
projections, the text_time added conditioning; no adapter).

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
import torch.utils.checkpoint
from torch import nn

from motioneditor_tpu_torch.control.injection import (
    InjectionSpec,
    injected_spatial_attention,
    injected_spatial_attention_auto,
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
from motioneditor_tpu_torch.ops import flop_count, fused_norm
from motioneditor_tpu_torch.ops.attention import (
    DENSE,
    MOTION_FRAME,
    NORMAL,
    Attention,
    cross_attention,
    spatial_self_attention,
    temporal_self_attention_video,
)
from motioneditor_tpu_torch.utils.profiling import spanned


SD15_DOWN_BLOCKS = ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)
_UP_OF = {"CrossAttnDownBlock2D": "CrossAttnUpBlock2D", "DownBlock2D": "UpBlock2D"}


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static architecture config: the fields and defaults of the JAX
    ``UNetConfig`` (SD-1.5 plus the video flags), then the fields of the
    diffusers UNet config that SDXL sets, each defaulting to SD-1.5's
    architecture: ``down_block_types`` (the up path mirrors it),
    ``transformer_layers_per_block`` and ``num_attention_heads`` per level
    (empty: 1 block and ``attention_heads`` at every level; the mid block
    takes the last level's), the Linear ``proj_in`` / ``proj_out``, and the
    ``text_time`` added embedding (the pooled text embedding and the 6 time
    ids, their 256-wide sinusoids concatenated into an MLP of
    ``projection_class_embeddings_input_dim`` inputs)."""

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
    down_block_types: Tuple[str, ...] = SD15_DOWN_BLOCKS
    transformer_layers_per_block: Tuple[int, ...] = ()
    num_attention_heads: Tuple[int, ...] = ()
    use_linear_projection: bool = False
    addition_embed_type: Optional[str] = None  # None or "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 0

    @property
    def up_block_types(self) -> Tuple[str, ...]:
        return tuple(_UP_OF[t] for t in reversed(self.down_block_types))

    @property
    def text_time(self) -> bool:
        return self.addition_embed_type == "text_time"

    def depth(self, level: int) -> int:
        """Transformer blocks in each ``Transformer2D`` of down level ``level``."""
        return self.transformer_layers_per_block[level] if self.transformer_layers_per_block else 1

    def heads(self, level: int) -> int:
        """Attention heads at down level ``level``."""
        return self.num_attention_heads[level] if self.num_attention_heads else self.attention_heads

    def attn1_mode(self, use_st: bool) -> str:
        if use_st:
            return DENSE
        if self.use_sc_attn:
            return MOTION_FRAME
        return NORMAL


# stabilityai/stable-diffusion-xl-base-1.0 unet/config.json, inflated to video
SDXL_BASE = UNetConfig(
    block_out_channels=(320, 640, 1280), cross_attention_dim=2048,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    transformer_layers_per_block=(1, 2, 10), num_attention_heads=(5, 10, 20),
    use_linear_projection=True, addition_embed_type="text_time", addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816)


def refuse_text_time(config: UNetConfig, what: str) -> None:
    """Raise for a path that is not ported to SDXL's text_time configuration."""
    if config.text_time:
        raise NotImplementedError(f"{what} is not ported to a text_time (SDXL) configuration")


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
    """``depth`` transformer blocks at ``heads`` heads between a 1x1-conv or
    (``linear``) a Linear ``proj_in`` and ``proj_out``."""

    def __init__(self, channels: int, cross_dim: int, heads: int, groups: int, eps: float,
                 video: bool, depth: int = 1, linear: bool = False):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps)
        proj = (lambda: nn.Linear(channels, channels)) if linear else (
            lambda: nn.Conv2d(channels, channels, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, cross_dim, heads, video) for _ in range(depth)])
        self.proj_out = proj()


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


def transformer_for(c: UNetConfig, channels: int, level: int) -> Transformer2D:
    """The ``Transformer2D`` of down level ``level`` (the up path passes its
    mirror level, the mid block the last)."""
    return Transformer2D(channels, c.cross_attention_dim, c.heads(level), c.norm_num_groups,
                         c.transformer_norm_eps, c.video, c.depth(level),
                         c.use_linear_projection)


def build_encoder(m: nn.Module, c: UNetConfig) -> None:
    """conv_in, time_embedding (add_embedding), down_blocks, mid_block
    (shared with ControlNet)."""
    time_dim = c.block_out_channels[0] * 4
    g, eps = c.norm_num_groups, c.norm_eps
    m.conv_in = nn.Conv2d(c.in_channels, c.block_out_channels[0], 3)
    m.time_embedding = TimestepEmbedding(c.block_out_channels[0], time_dim)
    if c.text_time:
        m.add_embedding = TimestepEmbedding(c.projection_class_embeddings_input_dim, time_dim)
    m.down_blocks = nn.ModuleList()
    out_ch = c.block_out_channels[0]
    for i, btype in enumerate(c.down_block_types):
        in_ch, out_ch = out_ch, c.block_out_channels[i]
        block = Block()
        for j in range(c.layers_per_block):
            block.resnets.append(ResnetBlock(in_ch if j == 0 else out_ch, out_ch, time_dim,
                                             g, eps, c.video))
            if btype == "CrossAttnDownBlock2D":
                block.attentions.append(transformer_for(c, out_ch, i))
        if i < len(c.block_out_channels) - 1:
            block.downsamplers = nn.ModuleList([ConvHolder(out_ch)])
        m.down_blocks.append(block)
    mid_ch = c.block_out_channels[-1]
    m.mid_block = Block()
    for _ in range(2):
        m.mid_block.resnets.append(ResnetBlock(mid_ch, mid_ch, time_dim, g, eps, c.video))
    m.mid_block.attentions.append(transformer_for(c, mid_ch, len(c.block_out_channels) - 1))


class UNet3DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig, include_adapter: bool = True):
        super().__init__()
        from motioneditor_tpu_torch.models.adapter import ControlAdapter

        c = config
        if include_adapter and c.video:
            refuse_text_time(c, "the motion adapter")
        build_encoder(self, c)
        time_dim = c.block_out_channels[0] * 4
        g, eps = c.norm_num_groups, c.norm_eps
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
                    block.attentions.append(transformer_for(c, out_ch, len(rev) - 1 - i))
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


def _gn_per_frame(p, video, groups, eps, silu=False):
    b, f, h, w, ch = video.shape
    return group_norm(p, video.reshape(b * f, h, w, ch), groups, eps,
                      silu=silu).reshape(video.shape)


def resnet_block(p: ResnetBlock, video, temb, *, groups=32, eps=1e-5,
                 per_frame_gn: bool = False, shard=None):
    """Video resnet; zero-init temporal convs are residual adds after each
    spatial conv. GroupNorm pools across frames unless ``per_frame_gn``
    (the per-frame 2D ControlNet). ``shard``: ``video`` holds the local
    frames of a frame-sharded run; the pooled GroupNorms and the temporal
    convs communicate (parallel/frame_ops.py)."""
    def gn_silu(norm, x):
        if per_frame_gn:
            return _gn_per_frame(norm, x, groups, eps, silu=True)
        return group_norm(norm, x, groups, eps, shard=shard, silu=True)

    h = inflated_conv3d(p.conv1, gn_silu(p.norm1, video), padding=1)
    if hasattr(p, "temp_conv1"):
        h = h + temporal_conv(p.temp_conv1, h, shard=shard)
    if temb is not None and hasattr(p, "time_emb_proj"):
        t = linear(p.time_emb_proj, silu(temb))  # [B, C]
        h = h + t[:, None, None, None, :]
    h = inflated_conv3d(p.conv2, gn_silu(p.norm2, h), padding=1)
    if hasattr(p, "temp_conv2"):
        h = h + temporal_conv(p.temp_conv2, h, shard=shard)
    skip = video
    if hasattr(p, "conv_shortcut"):
        skip = inflated_conv3d(p.conv_shortcut, skip, padding=0)
    return skip + h


@dataclasses.dataclass
class AttnContext:
    """Per-call context threaded through the transformer blocks."""

    encoder_hidden_states: torch.Tensor  # [B, L, D_text]
    injection: Optional[InjectionSpec] = None
    injection_masks: Optional[Dict[Tuple[int, int], torch.Tensor]] = None
    use_flash: bool = True
    # the 16x16 cross-attention maps of this forward, in forward order, for
    # the auto-mask injection: later injected blocks read the maps that
    # earlier blocks appended; None collects nothing
    cross_maps: Optional[list] = None
    # frame-sharded execution (parallel/mesh.FrameShardingCtx): the tokens
    # hold this rank's frames and the attention sites communicate
    shard: Optional[object] = None
    # the p2p probability editor (control/p2p.py): every attn2, and attn1
    # in normal mode only, as JAX unet.py:345 / :369
    prob_editor: Optional[object] = None


def basic_transformer_block(p: BasicTransformerBlock, tokens, ctx: AttnContext,
                            layer_idx: int, hw: Tuple[int, int], attn1_mode: str):
    """tokens: [B, F, N, C]. attn1 -> attn2 -> ff -> temporal attention, at
    the block's heads."""
    heads = p.attn1.heads
    inj = ctx.injection
    spatial_gate = inj is not None and inj.active and inj.spatial_layers[layer_idx]
    temporal_gate = inj is not None and inj.active and inj.temporal_layers[layer_idx]

    h = layer_norm(p.norm1, tokens)
    if spatial_gate:
        mask_n = None if ctx.injection_masks is None else ctx.injection_masks.get(hw)
        if inj.mask_mode == "auto":
            # no kernel for auto mode under a shard, as in JAX (unet.py:333-336)
            attn1_out = injected_spatial_attention_auto(
                p.attn1, h, heads, mask_n, ctx.cross_maps or [], inj.auto_token_idx,
                inj.auto_thres, use_flash=ctx.use_flash and ctx.shard is None,
                shard=ctx.shard)
        else:
            attn1_out = injected_spatial_attention(p.attn1, h, heads, mask_n,
                                                   inj.mask_fgbg, use_flash=ctx.use_flash,
                                                   shard=ctx.shard)
    else:
        attn1_out = spatial_self_attention(
            p.attn1, h, attn1_mode, heads, use_flash=ctx.use_flash, shard=ctx.shard,
            prob_editor=ctx.prob_editor if attn1_mode == NORMAL else None)
    # the residual add and the next LayerNorm: fused in one kernel with
    # MOTIONEDITOR_FUSED_LN on, at JAX's call-site gate (flash on, N >= 512,
    # and no shard: unet.py:353)
    fuse_ln = (ctx.use_flash and ctx.shard is None and tokens.shape[2] >= 512
               and fused_norm.enabled())

    def add_norm(norm, tokens, delta):
        if fuse_ln:
            return fused_norm.add_layer_norm(norm, tokens, delta)
        tokens = tokens + delta
        return tokens, layer_norm(norm, tokens)

    tokens, h = add_norm(p.norm2, tokens, attn1_out)
    collect = ctx.cross_maps is not None and tokens.shape[2] == 256
    attn2_out = cross_attention(p.attn2, h, ctx.encoder_hidden_states, heads,
                                collect_maps_into=ctx.cross_maps if collect else None,
                                prob_editor=ctx.prob_editor)
    tokens, h = add_norm(p.norm3, tokens, attn2_out)
    ff_out = feed_forward(p.ff, h)
    if hasattr(p, "attn_temp"):
        tokens, ht = add_norm(p.norm_temp, tokens, ff_out)
        kv_override = injected_temporal_kv(ht) if temporal_gate else None
        tokens = tokens + temporal_self_attention_video(
            p.attn_temp, ht, heads, causal=True, kv_override=kv_override,
            use_kernel=ctx.use_flash, shard=ctx.shard)
    else:
        tokens = tokens + ff_out
    return tokens


@spanned("me.transformer")
def transformer2d(p: Transformer2D, video, ctx: AttnContext, layer_idx: int,
                  attn1_mode: str, groups=32, eps=1e-6):
    """Per-frame GN -> proj in (1x1 conv or Linear) -> the transformer
    blocks at the stack's heads -> proj out + residual."""
    b, f, h, w, c = video.shape
    x = _gn_per_frame(p.norm, video, groups, eps)
    if isinstance(p.proj_in, nn.Linear):
        x = linear(p.proj_in, x.reshape(b, f, h * w, c))
    else:
        x = inflated_conv3d(p.proj_in, x, padding=0)
    tokens = x.reshape(b, f, h * w, c)
    for bp in p.transformer_blocks:
        tokens = basic_transformer_block(bp, tokens, ctx, layer_idx, (h, w), attn1_mode)
    if isinstance(p.proj_out, nn.Linear):
        x = linear(p.proj_out, tokens).reshape(b, f, h, w, c)
    else:
        x = inflated_conv3d(p.proj_out, tokens.reshape(b, f, h, w, c), padding=0)
    return x + video


def time_embedding(m: nn.Module, config: UNetConfig, timesteps, batch: int, dtype,
                   added_cond_kwargs: Optional[Dict[str, torch.Tensor]] = None):
    """Sinusoidal embedding + MLP for an int or a [B] tensor of timesteps;
    for a text_time configuration plus ``add_embedding`` of the pooled text
    embedding ``text_embeds`` [B, D] and the sinusoids of the ``time_ids``
    [B, 6] (diffusers' SDXL conditioning), which it must be given."""
    device = m.conv_in.weight.device
    t = torch.as_tensor(timesteps, device=device)
    if t.dim() == 0:
        t = t.expand(batch)
    t_emb = sinusoidal_timestep_embedding(t, config.block_out_channels[0])
    temb = timestep_embedding_mlp(m.time_embedding, t_emb.to(dtype))
    if not config.text_time:
        if added_cond_kwargs is not None:
            raise ValueError("added conditioning given to a configuration without text_time")
        return temb
    if added_cond_kwargs is None or not {"text_embeds", "time_ids"} <= set(added_cond_kwargs):
        raise ValueError("a text_time configuration needs added_cond_kwargs with "
                         "'text_embeds' and 'time_ids'")
    text_embeds, time_ids = added_cond_kwargs["text_embeds"], added_cond_kwargs["time_ids"]
    time_embeds = sinusoidal_timestep_embedding(time_ids.reshape(-1),
                                                config.addition_time_embed_dim)
    add = torch.cat([text_embeds.to(dtype),
                     time_embeds.reshape(text_embeds.shape[0], -1).to(dtype)], dim=-1)
    return temb + timestep_embedding_mlp(m.add_embedding, add)


@spanned("me.unet")
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
    remat: bool = False,
    shard_ctx=None,
    prob_editor=None,
    cross_maps_out: Optional[list] = None,
    added_cond_kwargs: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Full UNet forward. sample: [B, F, H, W, C_in]; timesteps: scalar or
    [B]; encoder_hidden_states: [B, L, D_text]. ``remat`` is gradient
    checkpointing: each resnet and each transformer block keeps only its
    inputs and recomputes its activations in the backward pass.
    ``shard_ctx`` (parallel/mesh.FrameShardingCtx): ``sample`` holds this
    rank's frames (and batch rows) and the output does too; every
    frame-mixing op communicates over the frame group. A layout whose
    frame axis is 1 with a model group of T > 1 holds every frame and runs
    the unsharded routes (``FrameShardingCtx.shards_frames``); the
    attention modules split over the model group (parallel/tp.py) reduce
    their outputs over it whatever the layout.
    ``prob_editor``: the p2p editor of this step (``P2PController.
    prob_editor``). ``cross_maps_out``: a list that receives the 16x16
    cross-attention maps [(B F), 256, L] of this forward, in forward order
    (JAX's ``_cross_maps_out``); with auto-mask injection on too, the same
    list serves the injection, as JAX unet.py:461-470. ``added_cond_kwargs``:
    a text_time configuration's ``text_embeds`` and ``time_ids``
    (``time_embedding``); such a configuration runs no ControlNet residuals,
    injection, p2p or cross-map collection, and no shard layout.

    ControlNet residuals: 12 down + mid. With a 4-row branch axis and a
    4-row mid residual, the residuals are the 2-row edit-branch ControlNet
    outputs: the adapter runs on rows [1, 3] against those rows' UNet
    features and the recon rows get zero residuals. Otherwise the adapter
    consumes them against the UNet's own features."""
    from motioneditor_tpu_torch.models.adapter import control_adapter_apply

    c = config
    if c.text_time:
        for what, given in (("ControlNet residuals", down_block_additional_residuals),
                            ("the injection", injection), ("p2p control", prob_editor),
                            ("cross-attention map collection", cross_maps_out),
                            ("a shard layout", shard_ctx)):
            if given is not None:
                refuse_text_time(c, what)
    if shard_ctx is not None and not shard_ctx.shards_frames:
        shard_ctx = None
    b = sample.shape[0]
    temb = time_embedding(model, c, timesteps, b, sample.dtype, added_cond_kwargs)
    cross_maps = cross_maps_out
    if cross_maps is None and (injection is not None and injection.active
                               and injection.collect_cross_maps):
        cross_maps = []
    ctx = AttnContext(encoder_hidden_states=encoder_hidden_states, injection=injection,
                      injection_masks=injection_masks, use_flash=use_flash,
                      cross_maps=cross_maps, shard=shard_ctx, prob_editor=prob_editor)

    def mode_for(use_st: bool) -> str:
        return NORMAL if normal_infer else c.attn1_mode(use_st)

    def checkpointed(fn):
        if not remat:
            return fn
        # the recompute in the backward counts no kernel flops (ops/flop_count.py)
        return lambda *args: torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, context_fn=flop_count.checkpoint_contexts)

    @checkpointed
    def res(rp, hh):
        return resnet_block(rp, hh, temb, groups=c.norm_num_groups, eps=c.norm_eps,
                            shard=shard_ctx)

    @checkpointed
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
                                           use_flash=use_flash, shard=shard_ctx)
            residuals = []
            for m in motion:
                z = torch.zeros_like(m[:1])
                residuals.append(torch.cat([z, m[:1], z, m[1:2]], dim=0))
        else:
            residuals = control_adapter_apply(model.controlnet_adapter, residuals,
                                              res_samples, use_flash=use_flash,
                                              shard=shard_ctx)
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
    h = group_norm(model.conv_norm_out, h, c.norm_num_groups, c.norm_eps, shard=shard_ctx,
                   silu=True)
    return inflated_conv3d(model.conv_out, h, padding=1)
