"""Segment Anything, box-prompted (port of motioneditor_tpu/models/sam.py).

The reference's mask stage prompts SAM with one box per frame
(data_preparation/video_masks.py:234-253): the ViT image encoder
(image_encoder.py), the prompt encoder's box corners and dense positional
encoding (prompt_encoder.py), and the two-way mask decoder
(mask_decoder.py, transformer.py). ``Sam`` holds its parameters under the
official ``sam_vit_*.pth`` names (``image_encoder.*``, ``prompt_encoder.*``,
``mask_decoder.*``; tests/fixtures/manifests/sam_vit_h.txt), but for the
mask-prompt downscaler, which a box prompt never runs and
``map_sam_state_dict`` drops.

The forward is channel-last like JAX's: windowed and global ViT blocks with
decomposed relative positions, attention as an fp32 product + softmax,
exact GELU, LayerNorm eps 1e-6 in the encoder's blocks, neck and the
decoder's upscaling; the 2x2 stride-2 transposed convolutions as one
einsum. ``sam_predict_box`` resizes the mask logits with the weights of
``jax.image.resize(..., "bilinear")`` (``clip_image.resize_weights``), which
antialias when they shrink.
"""

from __future__ import annotations

import dataclasses
import math
import os.path as osp
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motioneditor_tpu_torch.models.layers import conv2d, layer_norm, linear


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280  # vit_h (build_sam.py:14-23)
    depth: int = 32
    num_heads: int = 16
    global_attn: Tuple[int, ...] = (7, 15, 23, 31)
    window: int = 14
    prompt_dim: int = 256
    mlp_ratio: float = 4.0
    mask_in_chans: int = 16
    num_multimask: int = 3
    twoway_depth: int = 2
    twoway_heads: int = 8
    twoway_mlp: int = 2048

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


SAM_VIT_H = SAMConfig()
SAM_VIT_B = SAMConfig(embed_dim=768, depth=12, num_heads=12, global_attn=(2, 5, 8, 11))

# ImageNet normalization on 0-255 input (build_sam.py:99-100)
PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)
ENC_EPS = 1e-6  # the encoder's blocks and neck, the decoder's upscaling LayerNorm
# the mask-prompt downscaler of the prompt encoder: box prompts never run it
MASK_PROMPT = "prompt_encoder.mask_downscaling."


# ---------------------------------------------------------------------------
# the module (the checkpoint's names)
# ---------------------------------------------------------------------------


class _Lin2(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)


class ViTBlock(nn.Module):
    def __init__(self, c: SAMConfig, windowed: bool):
        super().__init__()
        d, hd = c.embed_dim, c.embed_dim // c.num_heads
        size = c.window if windowed else c.grid
        self.window = c.window if windowed else 0
        self.norm1 = nn.LayerNorm(d, eps=ENC_EPS)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(d, 3 * d)
        self.attn.proj = nn.Linear(d, d)
        self.attn.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.attn.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.norm2 = nn.LayerNorm(d, eps=ENC_EPS)
        self.mlp = _Lin2(d, int(d * c.mlp_ratio))


class Attention(nn.Module):
    """The decoder's attention, optionally downsampling the internal width."""

    def __init__(self, dim: int, internal: int):
        super().__init__()
        self.q_proj = nn.Linear(dim, internal)
        self.k_proj = nn.Linear(dim, internal)
        self.v_proj = nn.Linear(dim, internal)
        self.out_proj = nn.Linear(internal, dim)


class TwoWayBlock(nn.Module):
    def __init__(self, c: SAMConfig):
        super().__init__()
        d = c.prompt_dim
        self.self_attn = Attention(d, d)
        self.norm1 = nn.LayerNorm(d)
        self.cross_attn_token_to_image = Attention(d, d // 2)
        self.norm2 = nn.LayerNorm(d)
        self.mlp = _Lin2(d, c.twoway_mlp)
        self.norm3 = nn.LayerNorm(d)
        self.norm4 = nn.LayerNorm(d)
        self.cross_attn_image_to_token = Attention(d, d // 2)


class _MLP(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])


class Sam(nn.Module):
    def __init__(self, config: SAMConfig = SAM_VIT_H):
        super().__init__()
        self.config = c = config
        d, p = c.embed_dim, c.prompt_dim
        enc = self.image_encoder = nn.Module()
        enc.patch_embed = nn.Module()
        enc.patch_embed.proj = nn.Conv2d(3, d, c.patch_size, stride=c.patch_size)
        enc.pos_embed = nn.Parameter(torch.zeros(1, c.grid, c.grid, d))
        enc.blocks = nn.ModuleList([ViTBlock(c, i not in c.global_attn) for i in range(c.depth)])
        enc.neck = nn.Sequential(nn.Conv2d(d, p, 1, bias=False), nn.LayerNorm(p, eps=ENC_EPS),
                                 nn.Conv2d(p, p, 3, padding=1, bias=False),
                                 nn.LayerNorm(p, eps=ENC_EPS))
        pe = self.prompt_encoder = nn.Module()
        pe.pe_layer = nn.Module()
        pe.pe_layer.register_buffer("positional_encoding_gaussian_matrix",
                                    torch.zeros(2, p // 2))
        pe.point_embeddings = nn.ModuleList([nn.Embedding(1, p) for _ in range(4)])
        pe.not_a_point_embed = nn.Embedding(1, p)
        pe.no_mask_embed = nn.Embedding(1, p)
        dec = self.mask_decoder = nn.Module()
        n_tokens = c.num_multimask + 1
        dec.iou_token = nn.Embedding(1, p)
        dec.mask_tokens = nn.Embedding(n_tokens, p)
        dec.transformer = nn.Module()
        dec.transformer.layers = nn.ModuleList([TwoWayBlock(c) for _ in range(c.twoway_depth)])
        dec.transformer.final_attn_token_to_image = Attention(p, p // 2)
        dec.transformer.norm_final_attn = nn.LayerNorm(p)
        dec.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(p, p // 4, 2, stride=2), nn.LayerNorm(p // 4, eps=ENC_EPS),
            nn.GELU(), nn.ConvTranspose2d(p // 4, p // 8, 2, stride=2))
        dec.output_hypernetworks_mlps = nn.ModuleList(
            [_MLP((p, p, p, p // 8)) for _ in range(n_tokens)])
        dec.iou_prediction_head = _MLP((p, 256, 256, n_tokens))


@torch.no_grad()
def init_sam(model: Sam, generator: torch.Generator) -> Sam:
    """Random init with JAX's rules (init_sam): ``layers.init_params``; the
    position embedding, relative positions, not-a-point and no-mask
    embeddings zero; the Gaussian PE matrix standard normal; the point
    embeddings and tokens normal (std 0.02); the transposed convolutions'
    weights normal (std 0.02) and biases zero."""
    from motioneditor_tpu_torch.models.layers import init_params

    init_params(model, generator)
    enc, pe, dec = model.image_encoder, model.prompt_encoder, model.mask_decoder
    enc.pos_embed.zero_()
    for blk in enc.blocks:
        blk.attn.rel_pos_h.zero_()
        blk.attn.rel_pos_w.zero_()
    pe.pe_layer.positional_encoding_gaussian_matrix.normal_(generator=generator)
    pe.not_a_point_embed.weight.zero_()
    pe.no_mask_embed.weight.zero_()
    for i in (0, 3):
        up = dec.output_upscaling[i]
        up.weight.normal_(0.0, 0.02, generator=generator)
        up.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------


def _rel_pos_bias(q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                  h: int, w: int) -> torch.Tensor:
    """Decomposed relative positions (image_encoder.py:324-360) with
    q_size == k_size. q: [B_, H*W, hd]. Returns the additive bias
    [B_, H*W, H*W]."""
    dev = q.device
    idx_h = torch.as_tensor(np.arange(h)[:, None] - np.arange(h)[None, :] + (h - 1), device=dev)
    idx_w = torch.as_tensor(np.arange(w)[:, None] - np.arange(w)[None, :] + (w - 1), device=dev)
    rh = rel_pos_h.to(q.dtype)[idx_h]  # [h, h, hd]
    rw = rel_pos_w.to(q.dtype)[idx_w]  # [w, w, hd]
    rq = q.reshape(-1, h, w, q.shape[-1])
    rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
    return (rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).reshape(-1, h * w, h * w)


def _vit_attention(blk: ViTBlock, x: torch.Tensor, heads: int) -> torch.Tensor:
    """x: [B_, h, w, C] -> the same: dense attention with decomposed
    relative positions (image_encoder.py:186-240)."""
    b_, h, w, c = x.shape
    hd, n = c // heads, h * w
    a = blk.attn
    qkv = linear(a.qkv, x.reshape(b_, n, c)).reshape(b_, n, 3, heads, hd)
    qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, b_ * heads, n, hd)
    q, k, v = qkv[0], qkv[1], qkv[2]
    s = torch.matmul((q * (hd**-0.5)).float(), k.float().transpose(-1, -2))
    s = s + _rel_pos_bias(q, a.rel_pos_h, a.rel_pos_w, h, w).float()
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)
    out = out.reshape(b_, heads, n, hd).transpose(1, 2).reshape(b_, h, w, c)
    return linear(a.proj, out)


def _vit_block(blk: ViTBlock, x: torch.Tensor, heads: int) -> torch.Tensor:
    """A windowed (``blk.window`` > 0, the map padded to whole windows) or
    global ViT block on [B, H, W, C]."""
    b, h, w, c = x.shape
    window = blk.window
    shortcut = x
    x = layer_norm(blk.norm1, x, eps=ENC_EPS)
    if window > 0:
        ph, pw = (window - h % window) % window, (window - w % window) % window
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        x = x.reshape(b, hp // window, window, wp // window, window, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
        x = _vit_attention(blk, x, heads)
        x = x.reshape(b, hp // window, wp // window, window, window, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)[:, :h, :w]
    else:
        x = _vit_attention(blk, x, heads)
    x = shortcut + x
    y = layer_norm(blk.norm2, x, eps=ENC_EPS)
    return x + linear(blk.mlp.lin2, F.gelu(linear(blk.mlp.lin1, y)))


def sam_encode_image(model: Sam, image: torch.Tensor) -> torch.Tensor:
    """image: [B, img_size, img_size, 3], already (x - mean) / std.
    Returns [B, grid, grid, prompt_dim]."""
    c, enc = model.config, model.image_encoder
    x = conv2d(enc.patch_embed.proj, image, stride=c.patch_size, padding="VALID")
    x = x + enc.pos_embed.to(x.dtype)
    for blk in enc.blocks:
        x = _vit_block(blk, x, c.num_heads)
    neck = enc.neck
    x = layer_norm(neck[1], conv2d(neck[0], x, padding="VALID"), eps=ENC_EPS)
    return layer_norm(neck[3], conv2d(neck[2], x, padding="SAME"), eps=ENC_EPS)


# ---------------------------------------------------------------------------
# prompt encoder (box prompts) and the dense positional encoding
# ---------------------------------------------------------------------------


def _pe_encode(gaussian: torch.Tensor, coords01: torch.Tensor) -> torch.Tensor:
    """[..., 2] in [0, 1] -> [..., prompt_dim] (prompt_encoder.py:185-192)."""
    cc = torch.matmul(2.0 * coords01 - 1.0, gaussian.to(coords01.dtype)) * (2.0 * math.pi)
    return torch.cat([torch.sin(cc), torch.cos(cc)], dim=-1)


def sam_dense_pe(model: Sam) -> torch.Tensor:
    """[grid, grid, prompt_dim]: the positional encoding of the embedding grid."""
    g = model.config.grid
    gauss = model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix
    ys = (np.arange(g, dtype=np.float32) + 0.5) / g
    xs = (np.arange(g, dtype=np.float32) + 0.5) / g
    grid = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1)  # [g, g, 2] as (x, y)
    return _pe_encode(gauss, torch.from_numpy(grid).to(gauss.device))


def sam_embed_boxes(model: Sam, boxes: torch.Tensor) -> torch.Tensor:
    """boxes: [B, 4] xyxy in input-image pixels -> sparse embeddings
    [B, 2, prompt_dim] (prompt_encoder.py:133-141)."""
    pe = model.prompt_encoder
    corners = (boxes.reshape(-1, 2, 2) + 0.5) / model.config.img_size
    emb = _pe_encode(pe.pe_layer.positional_encoding_gaussian_matrix, corners)
    offs = torch.cat([pe.point_embeddings[2].weight, pe.point_embeddings[3].weight], dim=0)
    return emb + offs[None].to(emb.dtype)


# ---------------------------------------------------------------------------
# mask decoder
# ---------------------------------------------------------------------------


def _twoway_attention(p: Attention, q_in, k_in, v_in, heads: int) -> torch.Tensor:
    q, k, v = linear(p.q_proj, q_in), linear(p.k_proj, k_in), linear(p.v_proj, v_in)
    b, n, c = q.shape
    hd = c // heads

    def split(y):
        return y.reshape(b, -1, heads, hd).transpose(1, 2)

    s = torch.matmul((split(q) * (hd**-0.5)).float(), split(k).float().transpose(-1, -2))
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(probs, split(v)).transpose(1, 2).reshape(b, n, c)
    return linear(p.out_proj, out)


def _conv_transpose_2x2(p: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """torch's ConvTranspose2d(kernel 2, stride 2) on [B, H, W, C_in]: each
    pixel emits a 2x2 block. weight [C_in, C_out, 2, 2]."""
    y = torch.einsum("bhwc,coij->bhiwjo", x, p.weight.to(x.dtype))
    b, h, _, w, _, o = y.shape
    return y.reshape(b, h * 2, w * 2, o) + p.bias.to(x.dtype)


def _mlp(p: _MLP, x: torch.Tensor) -> torch.Tensor:
    n = len(p.layers)
    for i, lp in enumerate(p.layers):
        x = linear(lp, x)
        if i < n - 1:
            x = F.relu(x)
    return x


def sam_decode_masks(model: Sam, image_emb: torch.Tensor, boxes: torch.Tensor,
                     multimask: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_emb [1, grid, grid, prompt_dim]; boxes [B, 4] xyxy in input
    pixels. Returns (mask logits [B, n_masks, 4*grid, 4*grid], iou
    [B, n_masks]): mask_decoder.py:112-149 and transformer.py:62-107."""
    c, dec = model.config, model.mask_decoder
    g, p, heads = c.grid, c.prompt_dim, c.twoway_heads
    sparse = sam_embed_boxes(model, boxes)  # [B, 2, p]
    b = sparse.shape[0]
    out_tokens = torch.cat([dec.iou_token.weight, dec.mask_tokens.weight], dim=0)
    tokens = torch.cat([out_tokens[None].expand(b, -1, -1).to(sparse.dtype), sparse], dim=1)
    no_mask = model.prompt_encoder.no_mask_embed.weight[0].to(image_emb.dtype)
    src = image_emb.expand(b, g, g, p) + no_mask
    keys = src.reshape(b, g * g, p)
    key_pe = sam_dense_pe(model)[None].expand(b, g, g, p).reshape(b, g * g, p).to(keys.dtype)

    queries = tokens
    for i, blk in enumerate(dec.transformer.layers):
        if i == 0:  # skip_first_layer_pe (transformer.py:151-157)
            queries = _twoway_attention(blk.self_attn, queries, queries, queries, heads)
        else:
            q = queries + tokens
            queries = queries + _twoway_attention(blk.self_attn, q, q, queries, heads)
        queries = layer_norm(blk.norm1, queries)
        q, k = queries + tokens, keys + key_pe
        queries = queries + _twoway_attention(blk.cross_attn_token_to_image, q, k, keys, heads)
        queries = layer_norm(blk.norm2, queries)
        y = linear(blk.mlp.lin2, F.relu(linear(blk.mlp.lin1, queries)))
        queries = layer_norm(blk.norm3, queries + y)
        q = queries + tokens
        keys = keys + _twoway_attention(blk.cross_attn_image_to_token, k, q, queries, heads)
        keys = layer_norm(blk.norm4, keys)
    tr = dec.transformer
    q, k = queries + tokens, keys + key_pe
    queries = queries + _twoway_attention(tr.final_attn_token_to_image, q, k, keys, heads)
    queries = layer_norm(tr.norm_final_attn, queries)

    iou_out = queries[:, 0]
    n_tokens = c.num_multimask + 1
    mask_tokens_out = queries[:, 1:1 + n_tokens]
    ups = dec.output_upscaling
    up = _conv_transpose_2x2(ups[0], keys.reshape(b, g, g, p))
    up = F.gelu(layer_norm(ups[1], up, eps=ENC_EPS))
    up = F.gelu(_conv_transpose_2x2(ups[3], up))  # [B, 4g, 4g, p // 8]
    hyper = torch.stack([_mlp(dec.output_hypernetworks_mlps[i], mask_tokens_out[:, i])
                         for i in range(n_tokens)], dim=1)  # [B, n_tokens, p // 8]
    masks = torch.einsum("btc,bhwc->bthw", hyper, up)
    iou = _mlp(dec.iou_prediction_head, iou_out)
    if multimask:
        return masks[:, 1:], iou[:, 1:]
    return masks[:, :1], iou[:, :1]


# ---------------------------------------------------------------------------
# the box predictor (SamPredictor's box path, predictor.py:17-262)
# ---------------------------------------------------------------------------


def sam_preprocess(image_np: np.ndarray, cfg: SAMConfig = SAM_VIT_H
                   ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """uint8 HWC image -> (padded normalized [1, S, S, 3] float32, the
    resized (h, w)): the longest side to img_size through PIL's bilinear
    resize, padded at the bottom and right (predictor.py:53-95)."""
    from PIL import Image

    h0, w0 = image_np.shape[:2]
    scale = cfg.img_size / max(h0, w0)
    nh, nw = int(h0 * scale + 0.5), int(w0 * scale + 0.5)
    im = Image.fromarray(image_np).resize((nw, nh), Image.BILINEAR)
    x = (np.asarray(im, np.float32) - PIXEL_MEAN) / PIXEL_STD
    pad = np.zeros((cfg.img_size, cfg.img_size, 3), np.float32)
    pad[:nh, :nw] = x
    return pad[None], (nh, nw)


def _resize2d(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H, W] -> [h, w] with ``jax.image.resize(..., "bilinear")``'s weights."""
    from motioneditor_tpu_torch.models.clip_image import resize_weights

    wh = resize_weights(x.shape[0], h, x.device)
    ww = resize_weights(x.shape[1], w, x.device)
    return torch.einsum("hw,hp,wq->pq", x, wh, ww)


def sam_mask_logits(model: Sam, image_np: np.ndarray, box_xyxy) -> Dict[str, torch.Tensor]:
    """The box prediction's stages on one image: ``image`` (the padded
    input), ``image_emb``, ``masks`` (the decoder's logits, 4 * grid
    square) and ``logits`` at the original resolution."""
    cfg = model.config
    dev = next(model.parameters()).device
    x, (nh, nw) = sam_preprocess(image_np, cfg)
    h0, w0 = image_np.shape[:2]
    scale = cfg.img_size / max(h0, w0)
    box = torch.as_tensor(np.asarray(box_xyxy, np.float32) * scale, device=dev)[None]
    x = torch.from_numpy(x).to(dev)
    with torch.no_grad():
        emb = sam_encode_image(model, x)
        masks, _ = sam_decode_masks(model, emb, box)
        m = _resize2d(masks[0, 0], cfg.img_size, cfg.img_size)[:nh, :nw]
        logits = _resize2d(m, h0, w0)
    return {"image": x, "image_emb": emb, "masks": masks, "logits": logits}


def sam_predict_box(model: Sam, image_np: np.ndarray, box_xyxy) -> np.ndarray:
    """The box-prompted mask of one image: bool [H, W] at the original
    resolution, logits above 0 (predictor.py:160-176)."""
    return (sam_mask_logits(model, image_np, box_xyxy)["logits"] > 0.0).cpu().numpy()


# ---------------------------------------------------------------------------
# the official checkpoint (sam_vit_*.pth)
# ---------------------------------------------------------------------------


def map_sam_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An official SAM state dict -> the ``Sam`` state dict: the same names,
    without the mask-prompt downscaler (``MASK_PROMPT``)."""
    return {k: v for k, v in sd.items() if not k.startswith(MASK_PROMPT)}


def released_state_dict(model: Sam) -> Dict[str, torch.Tensor]:
    """The module's state dict in the released file's layout, with a zero
    mask-prompt downscaler (which no box prompt reads); the inverse of
    ``map_sam_state_dict``."""
    c = model.config
    sd = dict(model.state_dict())
    mid, low = c.mask_in_chans, c.mask_in_chans // 4
    for i, shape in ((0, (low, 1, 2, 2)), (1, (low,)), (3, (mid, low, 2, 2)), (4, (mid,)),
                     (6, (c.prompt_dim, mid, 1, 1))):
        sd[f"{MASK_PROMPT}{i}.weight"] = torch.zeros(shape)
        sd[f"{MASK_PROMPT}{i}.bias"] = torch.zeros(shape[0])
    return sd


def config_for(path: str) -> SAMConfig:
    """ViT-B's config for a file named like ``sam_vit_b_*``, else ViT-H's."""
    return SAM_VIT_B if "vit_b" in osp.basename(path) else SAM_VIT_H


def load_sam_checkpoint(path: str, cfg: SAMConfig = None, device="cuda") -> Sam:
    """An official ``sam_vit_*.pth`` into a ``Sam`` of ``cfg`` (by default
    ``config_for(path)``) on ``device``, fp32, strictly
    (``weights.load_into``; the file read with ``weights_only=True``)."""
    from motioneditor_tpu_torch.inference import resolve_device
    from motioneditor_tpu_torch.models.weights import load_into, load_state_dict

    device = resolve_device(device)  # before any file is read

    with torch.device(device):
        model = Sam(cfg or config_for(path))
    return load_into(model, map_sam_state_dict(load_state_dict(path)), path).eval()
