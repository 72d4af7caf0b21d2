"""MiDaS DPT-Hybrid depth estimator (port of motioneditor_tpu/models/midas.py).

The reference's ``depth`` condition runs controlnet_aux's MidasDetector
(data_preparation/video_skeletons.py:13-21, :71-74), which wraps
isl-org/MiDaS ``DPTDepthModel(backbone="vitb_rn50_384")``: a ResNetV2-50
stem and stages (3, 4, 9) of weight-standardized convs, a ViT-Base on
1/16-resolution patches, DPT reassembly from ResNet stages 1-2 and ViT
blocks 8 and 11, RefineNet fusion and the monodepth head.

``DPTHybrid`` holds the parameters under the ``dpt_hybrid-midas-501f0c75.pt``
key layout (``pretrained.model.*``, ``scratch.*``), so ``load_dpt_params``
reads the file through ``models/weights.load_state_dict``. The forward
keeps the timm / MiDaS details JAX reproduces: TF-"same" padding (the odd
pixel bottom / right) in the standardized convs and the stem's max pool
(padded with -inf); weight standardization in fp32 with biased variance and
eps 1e-6; GroupNorm(32, eps 1e-5); exact GELU; the position embedding
resized bilinearly without corner alignment, the fusion and head
upsampling with it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

RESNET_LAYERS = (3, 4, 9)
RESNET_WIDTHS = (256, 512, 1024)
RESNET_STRIDES = (1, 2, 2)
STEM_CH = 64
VIT_DIM = 768
VIT_HEADS = 12
VIT_MLP = 3072
VIT_DEPTH = 12
HOOKS = (8, 11)  # the transformer blocks feeding DPT levels 3 and 4
FEATURES = 256  # DPT scratch width
PATCH_STRIDE = 16
POS_TOKENS = 577  # the 24 x 24 grid of 384 px, plus the class token
GN_EPS = 1e-5
LN_EPS = 1e-6
WS_EPS = 1e-6
# keys the released checkpoint may hold that the DPT forward never reads:
# the final LayerNorm and classifier head of timm's VisionTransformer (the
# hooks take blocks 8 and 11 before that norm)
UNUSED_KEYS = ("pretrained.model.norm.weight", "pretrained.model.norm.bias",
               "pretrained.model.head.weight", "pretrained.model.head.bias")


# ---------------------------------------------------------------------------
# the module (the checkpoint's key layout)
# ---------------------------------------------------------------------------


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=GN_EPS)


class _Downsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.norm = _norm(cout)


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, first: bool):
        super().__init__()
        mid = cout // 4
        if first:
            self.downsample = _Downsample(cin, cout)
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.norm1 = _norm(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, bias=False)
        self.norm2 = _norm(mid)
        self.conv3 = nn.Conv2d(mid, cout, 1, bias=False)
        self.norm3 = _norm(cout)


class _ViTBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm1 = nn.LayerNorm(VIT_DIM, eps=LN_EPS)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(VIT_DIM, 3 * VIT_DIM)
        self.attn.proj = nn.Linear(VIT_DIM, VIT_DIM)
        self.norm2 = nn.LayerNorm(VIT_DIM, eps=LN_EPS)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(VIT_DIM, VIT_MLP)
        self.mlp.fc2 = nn.Linear(VIT_MLP, VIT_DIM)


def _readout(with_down: bool) -> nn.Module:
    """``act_postprocess3`` / ``4``: index 0 the project readout (Linear +
    GELU under ``.project.0``), 3 a 1x1 conv, 4 (level 4) a strided 3x3."""
    m = nn.Module()
    read = nn.Module()
    read.project = nn.ModuleList([nn.Linear(2 * VIT_DIM, VIT_DIM)])
    setattr(m, "0", read)
    setattr(m, "3", nn.Conv2d(VIT_DIM, VIT_DIM, 1))
    if with_down:
        setattr(m, "4", nn.Conv2d(VIT_DIM, VIT_DIM, 3, stride=2, padding=1))
    return m


def _refinenet() -> nn.Module:
    m = nn.Module()
    m.out_conv = nn.Conv2d(FEATURES, FEATURES, 1)
    for name in ("resConfUnit1", "resConfUnit2"):
        rcu = nn.Module()
        rcu.conv1 = nn.Conv2d(FEATURES, FEATURES, 3, padding=1)
        rcu.conv2 = nn.Conv2d(FEATURES, FEATURES, 3, padding=1)
        setattr(m, name, rcu)
    return m


class DPTHybrid(nn.Module):
    """MiDaS DPT-Hybrid (``vitb_rn50_384``) in the checkpoint's key layout."""

    def __init__(self):
        super().__init__()
        backbone = nn.Module()
        backbone.stem = nn.Module()
        backbone.stem.conv = nn.Conv2d(3, STEM_CH, 7, stride=2, bias=False)
        backbone.stem.norm = _norm(STEM_CH)
        backbone.stages = nn.ModuleList()
        cin = STEM_CH
        for n_blocks, cout in zip(RESNET_LAYERS, RESNET_WIDTHS):
            stage = nn.Module()
            stage.blocks = nn.ModuleList(
                [_Bottleneck(cin if b == 0 else cout, cout, b == 0) for b in range(n_blocks)])
            backbone.stages.append(stage)
            cin = cout
        model = nn.Module()
        model.cls_token = nn.Parameter(torch.zeros(1, 1, VIT_DIM))
        model.pos_embed = nn.Parameter(torch.zeros(1, POS_TOKENS, VIT_DIM))
        model.patch_embed = nn.Module()
        model.patch_embed.backbone = backbone
        model.patch_embed.proj = nn.Conv2d(RESNET_WIDTHS[-1], VIT_DIM, 1)
        model.blocks = nn.ModuleList([_ViTBlock() for _ in range(VIT_DEPTH)])
        self.pretrained = nn.Module()
        self.pretrained.model = model
        self.pretrained.act_postprocess3 = _readout(False)
        self.pretrained.act_postprocess4 = _readout(True)
        s = self.scratch = nn.Module()
        for i, cin in enumerate((256, 512, VIT_DIM, VIT_DIM), start=1):
            setattr(s, f"layer{i}_rn", nn.Conv2d(cin, FEATURES, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(s, f"refinenet{i}", _refinenet())
        head = nn.Module()
        setattr(head, "0", nn.Conv2d(FEATURES, 128, 3, padding=1))
        setattr(head, "2", nn.Conv2d(128, 32, 3, padding=1))
        setattr(head, "4", nn.Conv2d(32, 1, 1))
        s.output_conv = head


def load_dpt_params(path: str, device="cpu") -> DPTHybrid:
    """A ``dpt_hybrid-midas-501f0c75.pt`` (a state dict, or one under
    ``state_dict``) into a ``DPTHybrid`` on ``device``; the keys of
    ``UNUSED_KEYS`` are dropped, any other key the module lacks raises."""
    from motioneditor_tpu_torch.models.weights import load_into, load_state_dict

    sd = load_state_dict(path)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    sd = {k: v for k, v in sd.items() if k not in UNUSED_KEYS}
    with torch.device(device):
        model = DPTHybrid()
    return load_into(model, sd, path).eval()


# ---------------------------------------------------------------------------
# primitives (NCHW)
# ---------------------------------------------------------------------------


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TF "same" padding: the odd pixel goes bottom / right."""
    top, bottom = _same_pads(x.shape[-2], k, s)
    left, right = _same_pads(x.shape[-1], k, s)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def std_conv2d(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """timm StdConv2dSame: each filter standardized over its fan-in in fp32
    (biased variance, eps 1e-6), TF-"same" padding."""
    w = conv.weight.float()
    var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, unbiased=False)
    w = (w - mean) * torch.rsqrt(var + WS_EPS)
    k = w.shape[-1]
    return F.conv2d(_pad_same(x, k, stride), w.to(x.dtype), None, stride)


def _gn(norm: nn.GroupNorm, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
    y = F.group_norm(x.float(), 32, norm.weight.float(), norm.bias.float(), GN_EPS)
    return (F.relu(y) if relu else y).to(x.dtype)


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """timm MaxPool2dSame: TF-"same" padding with -inf."""
    return F.max_pool2d(_pad_same(x, window, stride, float("-inf")), window, stride)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), b, conv.stride, conv.padding)


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]), mode="bilinear",
                         align_corners=True)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _bottleneck(blk: _Bottleneck, x: torch.Tensor, stride: int) -> torch.Tensor:
    if hasattr(blk, "downsample"):
        sc = _gn(blk.downsample.norm, std_conv2d(blk.downsample.conv, x, stride), relu=False)
    else:
        sc = x
    h = _gn(blk.norm1, std_conv2d(blk.conv1, x))
    h = _gn(blk.norm2, std_conv2d(blk.conv2, h, stride))
    h = _gn(blk.norm3, std_conv2d(blk.conv3, h), relu=False)
    return F.relu(h + sc)


def _resnet_forward(bb: nn.Module, x: torch.Tensor) -> List[torch.Tensor]:
    h = _gn(bb.stem.norm, std_conv2d(bb.stem.conv, x, stride=2))
    h = max_pool_same(h)
    feats = []
    for s, stage in enumerate(bb.stages):
        for b, blk in enumerate(stage.blocks):
            h = _bottleneck(blk, h, RESNET_STRIDES[s] if b == 0 else 1)
        feats.append(h)
    return feats  # [1/4 x256, 1/8 x512, 1/16 x1024]


def _vit_block(blk: _ViTBlock, x: torch.Tensor) -> torch.Tensor:
    b, n, c = x.shape
    h = F.layer_norm(x, (c,), blk.norm1.weight.to(x.dtype), blk.norm1.bias.to(x.dtype), LN_EPS)
    qkv = _linear(blk.attn.qkv, h).reshape(b, n, 3, VIT_HEADS, c // VIT_HEADS)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, N, d]
    att = torch.matmul(q * (1.0 / math.sqrt(c // VIT_HEADS)), k.transpose(-1, -2))
    att = torch.softmax(att.float(), dim=-1).to(x.dtype)
    out = torch.matmul(att, v).transpose(1, 2).reshape(b, n, c)
    x = x + _linear(blk.attn.proj, out)
    h = F.layer_norm(x, (c,), blk.norm2.weight.to(x.dtype), blk.norm2.bias.to(x.dtype), LN_EPS)
    return x + _linear(blk.mlp.fc2, F.gelu(_linear(blk.mlp.fc1, h)))


def _resize_pos_embed(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """MiDaS vit.py _resize_pos_embed: the grid part resized bilinearly
    without corner alignment."""
    gs = int(round(math.sqrt(pos.shape[1] - 1)))
    if (gh, gw) == (gs, gs):
        return pos
    grid = pos[:, 1:].reshape(1, gs, gs, VIT_DIM).permute(0, 3, 1, 2).float()
    grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
    grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, VIT_DIM).to(pos.dtype)
    return torch.cat([pos[:, :1], grid], dim=1)


def _readout_project(post: nn.Module, tokens: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """ProjectReadout: the class token concatenated onto every patch token,
    Linear + exact GELU, on the patch grid [B, C, gh, gw]; then the 1x1
    conv."""
    spatial = tokens[:, 1:]
    cls = tokens[:, :1].expand_as(spatial)
    h = F.gelu(_linear(getattr(post, "0").project[0], torch.cat([spatial, cls], dim=-1)))
    h = h.transpose(1, 2).reshape(h.shape[0], VIT_DIM, gh, gw)
    return _conv(getattr(post, "3"), h)


def _rcu(rcu: nn.Module, x: torch.Tensor) -> torch.Tensor:
    h = _conv(rcu.conv1, F.relu(x))
    return _conv(rcu.conv2, F.relu(h)) + x


def _fusion(p: nn.Module, x: torch.Tensor, skip=None) -> torch.Tensor:
    if skip is not None:
        x = x + _rcu(p.resConfUnit1, skip)
    x = _rcu(p.resConfUnit2, x)
    return _conv(p.out_conv, _up2(x))


def dpt_forward(model: DPTHybrid, x: torch.Tensor) -> torch.Tensor:
    """Inverse depth of normalized [B, H, W, 3] input (H, W multiples of 32):
    [B, H, W] (DPTDepthModel.forward, non_negative=True, squeezed)."""
    b, h0, w0, _ = x.shape
    gh, gw = h0 // PATCH_STRIDE, w0 // PATCH_STRIDE
    vit = model.pretrained.model
    r1, r2, r3 = _resnet_forward(vit.patch_embed.backbone, x.permute(0, 3, 1, 2))
    tokens = _conv(vit.patch_embed.proj, r3).flatten(2).transpose(1, 2)
    cls = vit.cls_token.to(tokens.dtype).expand(b, 1, VIT_DIM)
    tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + _resize_pos_embed(vit.pos_embed, gh, gw).to(tokens.dtype)
    hooks = {}
    for i, blk in enumerate(vit.blocks):
        tokens = _vit_block(blk, tokens)
        if i in HOOKS:
            hooks[i] = tokens
    pre = model.pretrained
    l3 = _readout_project(pre.act_postprocess3, hooks[HOOKS[0]], gh, gw)
    l4 = _conv(getattr(pre.act_postprocess4, "4"),
               _readout_project(pre.act_postprocess4, hooks[HOOKS[1]], gh, gw))
    sc = model.scratch
    p4 = _fusion(sc.refinenet4, _conv(sc.layer4_rn, l4))
    p3 = _fusion(sc.refinenet3, p4, _conv(sc.layer3_rn, l3))
    p2 = _fusion(sc.refinenet2, p3, _conv(sc.layer2_rn, r2))
    p1 = _fusion(sc.refinenet1, p2, _conv(sc.layer1_rn, r1))
    head = sc.output_conv
    h = _up2(_conv(getattr(head, "0"), p1))
    h = F.relu(_conv(getattr(head, "2"), h))
    h = F.relu(_conv(getattr(head, "4"), h))
    return h[:, 0]


def _pil_resize(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """PIL's default resize of a uint8 image, as JAX's estimate_depth makes
    it. PIL is imported only here: the GPU host has none, and a frame whose
    size is already a multiple of 64 needs no resize."""
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize(size_wh), np.uint8)


def estimate_depth(model: DPTHybrid, image_rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> uint8 depth image [H, W, 3] (controlnet_aux
    MidasDetector; JAX midas.py:508-533): the frame resized through PIL to
    the floored multiple of 64 (at least 64), ``x / 127.5 - 1``, the model,
    min-max normalized to uint8 gray, resized back. A frame already at a
    multiple of 64 skips both resizes, where PIL would return a copy."""
    h, w = image_rgb.shape[:2]
    nw, nh = max((w // 64) * 64, 64), max((h // 64) * 64, 64)
    img = image_rgb if (nh, nw) == (h, w) else _pil_resize(image_rgb, (nw, nh))
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(img, np.float32) / 127.5 - 1.0, device=device)
    with torch.no_grad():
        depth = dpt_forward(model, x[None])[0].cpu().numpy()
    depth = depth - depth.min()
    dmax = depth.max()
    if dmax > 0:
        depth = depth / dmax
    gray = np.clip(depth * 255.0, 0, 255).astype(np.uint8)
    out = np.stack([gray] * 3, axis=-1)
    return out if (nh, nw) == (h, w) else _pil_resize(out, (w, h))
