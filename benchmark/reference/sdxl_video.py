"""Plain reference of SDXL's UNet inflated to video as MotionEditor inflates
SD-1.5's, and its stage-1 loss, over a dict of parameters keyed by their
diffusers names.

Written from the model's equations in float32 with TF32 off
(``sd15_video.strict_fp32``), on the SD-1.5 reference's layers and
precision modes (``sd15_video.Reference``: "fp8" the control, "bf16" an
emulation of the program's precision; every attention site reported to
``sites`` in the same format). It imports nothing of the program under
test.

The UNet is diffusers' ``UNet2DConditionModel`` at the configuration's
widths (stabilityai/stable-diffusion-xl-base-1.0, unet/config.json): three
levels, the first without attention; ``transformer_layers_per_block``
blocks in each ``Transformer2D`` (the up path takes them in reverse, the
mid block the last level's); ``attention_head_dim`` read as the heads of
each level, since ``num_attention_heads`` is null (heads of 64 channels);
Linear ``proj_in`` / ``proj_out`` on the tokens; the ``text_time`` added
embedding: the pooled text embedding and the 256-wide sinusoids of the 6
time ids (cos first, shift 0, as the timestep's) through ``add_embedding``,
added to the timestep embedding.

Departures from diffusers, all of them MotionEditor's inflation:
- videos [B, F, H, W, C]; the 2D convolutions run per frame;
- each resnet adds a temporal conv of kernel 3 over the frames
  (``temp_conv1`` / ``temp_conv2``) after each spatial conv, and its
  GroupNorms pool over the frames; the ``Transformer2D``'s GroupNorm is
  per frame;
- attn1 reads the keys and values of [previous frame | frame]
  (motion-frame attention, frame 0 its own previous);
- each transformer block ends in causal temporal attention ``attn_temp``
  after ``norm_temp``, at the level's heads, added after the feed-forward;
- no ControlNet residuals, motion adapter or injection.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import sd15_video as R

TIME_IDS = 6  # (original h, w, crop top, left, target h, w)


def attention_levels(cfg: dict, up: bool = False) -> list:
    types = cfg["up_block_types"] if up else cfg["down_block_types"]
    return [t.startswith("CrossAttn") for t in types]


def level_heads(cfg: dict) -> list:
    """The heads of each level: ``num_attention_heads``, or
    ``attention_head_dim`` where that is null, as diffusers reads them."""
    heads = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
    return list(heads) if isinstance(heads, (list, tuple)) else [heads] * len(
        cfg["block_out_channels"])


def _transformer(out: dict, name: str, c: int, depth: int, cross: int) -> None:
    R._norm(out, f"{name}.norm", c)
    R._linear(out, f"{name}.proj_in", c, c)
    for k in range(depth):
        b = f"{name}.transformer_blocks.{k}"
        R._norm(out, f"{b}.norm1", c)
        R._attention(out, f"{b}.attn1", c, c)
        R._norm(out, f"{b}.norm2", c)
        R._attention(out, f"{b}.attn2", c, cross)
        R._norm(out, f"{b}.norm3", c)
        R._linear(out, f"{b}.ff.net.0.proj", 8 * c, c)
        R._linear(out, f"{b}.ff.net.2", c, 4 * c)
        R._norm(out, f"{b}.norm_temp", c)
        R._attention(out, f"{b}.attn_temp", c, c)
    R._linear(out, f"{name}.proj_out", c, c)


def unet_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of the video UNet, diffusers' key names plus the
    inflation's ``temp_conv1/2``, ``norm_temp`` and ``attn_temp``."""
    ch, layers = cfg["block_out_channels"], cfg["layers_per_block"]
    depth, cross = cfg["transformer_layers_per_block"], cfg["cross_attention_dim"]
    down, up = attention_levels(cfg), attention_levels(cfg, up=True)
    temb = 4 * ch[0]
    out: Dict[str, Tuple[int, ...]] = {}
    R._conv(out, "conv_in", ch[0], cfg["in_channels"], 3)
    R._linear(out, "time_embedding.linear_1", temb, ch[0])
    R._linear(out, "time_embedding.linear_2", temb, temb)
    R._linear(out, "add_embedding.linear_1", temb, cfg["projection_class_embeddings_input_dim"])
    R._linear(out, "add_embedding.linear_2", temb, temb)
    c_out = ch[0]
    for i in range(len(ch)):
        c_in, c_out = c_out, ch[i]
        for j in range(layers):
            R._resnet(out, f"down_blocks.{i}.resnets.{j}", c_in if j == 0 else c_out, c_out,
                      temb, True)
            if down[i]:
                _transformer(out, f"down_blocks.{i}.attentions.{j}", c_out, depth[i], cross)
        if i < len(ch) - 1:
            R._conv(out, f"down_blocks.{i}.downsamplers.0.conv", c_out, c_out, 3)
    for j in range(2):
        R._resnet(out, f"mid_block.resnets.{j}", ch[-1], ch[-1], temb, True)
        if j == 0:
            _transformer(out, "mid_block.attentions.0", ch[-1], depth[-1], cross)
    rev = list(reversed(ch))
    c_out = rev[0]
    for i in range(len(rev)):
        prev, c_out = c_out, rev[i]
        c_in = rev[min(i + 1, len(rev) - 1)]
        for j in range(layers + 1):
            skip = c_in if j == layers else c_out
            R._resnet(out, f"up_blocks.{i}.resnets.{j}", (prev if j == 0 else c_out) + skip,
                      c_out, temb, True)
            if up[i]:
                _transformer(out, f"up_blocks.{i}.attentions.{j}", c_out,
                             depth[len(rev) - 1 - i], cross)
        if i < len(rev) - 1:
            R._conv(out, f"up_blocks.{i}.upsamplers.0.conv", c_out, c_out, 3)
    R._norm(out, "conv_norm_out", ch[0])
    R._conv(out, "conv_out", cfg["out_channels"], ch[0], 3)
    return out


class Reference(R.Reference):
    """The SDXL video UNet over ``params`` ({name: tensor}, float32); ``cfg``
    is the configuration file's ``model`` group. Attention runs at the heads
    of the level being computed."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, precision: str = "fp32",
                 sites: Optional[list] = None):
        self.p = params
        self.cfg = cfg
        self.products = R.PRODUCTS[precision]
        self.precision = precision
        self.sites = sites
        self.level_heads = level_heads(cfg)
        self.heads = self.level_heads[0]
        self.remat = True  # under autograd, recompute blocks and score slices in the backward

    def add_embedding(self, text_embeds: torch.Tensor, time_ids: torch.Tensor) -> torch.Tensor:
        """add_embedding(concat(text_embeds, sinusoids of the time ids))."""
        half = self.cfg["addition_time_embed_dim"] // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                            device=time_ids.device) / half)
        arg = time_ids.float().reshape(-1)[:, None] * freqs[None]
        emb = torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)
        x = torch.cat([text_embeds.float(), emb.reshape(text_embeds.shape[0], -1)], dim=-1)
        return self.linear("add_embedding.linear_2",
                           F.silu(self.linear("add_embedding.linear_1", self.st(x))))

    def block(self, name: str, tok, text, mode: str):
        """One transformer block on tokens [B, F, N, C]."""
        st = self.st
        tok = st(tok + self.self_attention(f"{name}.attn1", self.layer_norm(f"{name}.norm1", tok),
                                           mode))
        tok = st(tok + self.cross_attention(f"{name}.attn2",
                                            self.layer_norm(f"{name}.norm2", tok), text))
        tok = st(tok + self.feed_forward(f"{name}.ff", self.layer_norm(f"{name}.norm3", tok)))
        return st(tok + self.temporal_attention(f"{name}.attn_temp",
                                                self.layer_norm(f"{name}.norm_temp", tok)))

    def transformer_stack(self, name: str, x, text, mode: str, heads: int, depth: int):
        """Per-frame GN, the Linear proj_in, ``depth`` blocks (each recomputed
        in the backward), the Linear proj_out, + x."""
        b, f, hh, ww, c = x.shape
        tok = self.group_norm(f"{name}.norm", x, self.cfg["transformer_norm_eps"],
                              per_frame=True).reshape(b, f, hh * ww, c)
        tok = self.linear(f"{name}.proj_in", tok)
        for k in range(depth):
            def run(t, n=f"{name}.transformer_blocks.{k}"):
                self.heads = heads  # set again when the backward recomputes the block
                return self.block(n, t, text, mode)
            tok = self._checkpointed(run, tok)
        y = self.linear(f"{name}.proj_out", tok).reshape(b, f, hh, ww, c)
        return self.st(y + x)

    def unet(self, sample, t, text, mode: str = "motion_frame", added=None):
        """The video UNet on [B, F, h, w, 4] under the text [B, L, D] and
        ``added`` = {"text_embeds": [B, D_pool], "time_ids": [B, 6]}."""
        cfg = self.cfg
        ch, layers = cfg["block_out_channels"], cfg["layers_per_block"]
        depth, heads = cfg["transformer_layers_per_block"], self.level_heads
        down, up = attention_levels(cfg), attention_levels(cfg, up=True)
        if added is None:
            raise ValueError("the text_time UNet needs its added conditioning")
        temb = self.st(self.time_embedding(self._timesteps(t, sample))
                       + self.add_embedding(added["text_embeds"], added["time_ids"]))

        def res(name, hh):
            return self._checkpointed(lambda z: self.resnet(name, z, temb, True), hh)

        h = self.conv("conv_in", sample)
        skips = [h]
        for i in range(len(ch)):
            for j in range(layers):
                h = res(f"down_blocks.{i}.resnets.{j}", h)
                if down[i]:
                    h = self.transformer_stack(f"down_blocks.{i}.attentions.{j}", h, text,
                                               mode, heads[i], depth[i])
                skips.append(h)
            if i < len(ch) - 1:
                h = self.conv(f"down_blocks.{i}.downsamplers.0.conv", h, stride=2)
                skips.append(h)
        h = res("mid_block.resnets.0", h)
        h = self.transformer_stack("mid_block.attentions.0", h, text, mode, heads[-1], depth[-1])
        h = res("mid_block.resnets.1", h)
        top = len(ch) - 1
        for i in range(len(ch)):
            for j in range(layers + 1):
                h = res(f"up_blocks.{i}.resnets.{j}", torch.cat([h, skips.pop()], dim=-1))
                if up[i]:
                    h = self.transformer_stack(f"up_blocks.{i}.attentions.{j}", h, text, mode,
                                               heads[top - i], depth[top - i])
            if i < top:
                bb, f, hh, ww, c = h.shape
                u = h.reshape(bb * f, hh, ww, c).repeat_interleave(2, 1).repeat_interleave(2, 2)
                h = self.conv(f"up_blocks.{i}.upsamplers.0.conv",
                              u.reshape(bb, f, 2 * hh, 2 * ww, c))
        h = F.silu(self.group_norm("conv_norm_out", h, cfg["norm_eps"]))
        return self.conv("conv_out", h)


def stage1_loss(ref: Reference, acp, latents, text, added: dict, noise, t: torch.Tensor):
    """The epsilon-prediction loss of stage 1: the UNet on the latents noised
    at ``t`` against the noise, mean squared, with motion-frame attn1."""
    a = acp.to(latents.device)[t].reshape(-1, 1, 1, 1, 1)
    noisy = a.sqrt() * latents + (1 - a).sqrt() * noise
    pred = ref.unet(noisy, t, text, "motion_frame", added)
    return ((pred - noise) ** 2).mean()
