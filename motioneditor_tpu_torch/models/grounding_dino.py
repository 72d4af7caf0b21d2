"""GroundingDINO, the open-vocabulary detector of the mask preparation
(port of motioneditor_tpu/models/grounding_dino.py).

``GroundingDINO`` holds its parameters under the official checkpoint's
names (``backbone.0.*``, ``bert.*``, ``feat_map``, ``input_proj.{i}.{0,1}``,
``transformer.*``, ``bbox_embed.0.*``; tests/fixtures/manifests/
gdino_swint.txt), with nn.MultiheadAttention's packed ``in_proj_weight`` /
``in_proj_bias`` kept packed and split at use. models/gdino_weights.py reads
the released file into it.

The forward is inference-only and batch-1 in spirit, as JAX's: no padding
machinery (valid ratios 1, no key-padding masks but the text token mask),
deformable attention through ops/ms_deform_attn.py, attention as an fp32
product + softmax, the text encoder a BERT with phrase-blocked
self-attention and restarting position ids (``build_text_masks``).

Config: GroundingDINO_SwinT_OGC.py / GroundingDINO_SwinB.cfg.py (two-stage
"standard", 6 encoder and 6 decoder layers, 900 queries, 4 levels).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from motioneditor_tpu_torch.models.layers import conv2d, layer_norm, linear
from motioneditor_tpu_torch.models.swin import SWIN_B_384, SWIN_T, SwinConfig, swin_apply
from motioneditor_tpu_torch.ops.ms_deform_attn import ms_deform_attn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class GroundingDINOConfig:
    d_model: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    ffn_dim: int = 2048
    text_ffn_dim: int = 1024  # the text enhance layer's FFN (transformer.py:136)
    num_queries: int = 900
    num_levels: int = 4
    num_points: int = 4
    max_text_len: int = 256
    pe_temperature: float = 20.0  # pe_temperatureH / W in the configs
    swin: SwinConfig = SWIN_T
    bert: BertConfig = BertConfig()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.nheads


GDINO_SWINT = GroundingDINOConfig()
GDINO_SWINB = GroundingDINOConfig(swin=SWIN_B_384)
FUSION_HEADS = 4  # BiAttentionBlock: embed_dim 4 * d_model over 4 heads
FUSION_CLAMP = 50000.0


# ---------------------------------------------------------------------------
# host-side text masks (bertwarper.py:224-273; a copy of JAX's)
# ---------------------------------------------------------------------------


def build_text_masks(input_ids: np.ndarray, special_ids: Sequence[int]):
    """Per-phrase block-diagonal self-attention masks and restarting
    position ids: (self_attn_mask [B, N, N] bool, position_ids [B, N]
    int32). Tokens attend only within their own '.'-separated phrase, as
    generate_masks_with_special_tokens_and_transfer_map."""
    input_ids = np.asarray(input_ids)
    bs, n = input_ids.shape
    special = np.zeros((bs, n), bool)
    for sid in special_ids:
        special |= input_ids == sid
    attn = np.tile(np.eye(n, dtype=bool)[None], (bs, 1, 1))
    pos = np.zeros((bs, n), np.int64)
    for row in range(bs):
        prev = 0
        for col in np.nonzero(special[row])[0]:
            if col == 0 or col == n - 1:
                pos[row, col] = 0
            else:
                attn[row, prev + 1: col + 1, prev + 1: col + 1] = True
                pos[row, prev + 1: col + 1] = np.arange(0, col - prev)
            prev = col
    return attn, pos.astype(np.int32)


# ---------------------------------------------------------------------------
# the module (the checkpoint's names)
# ---------------------------------------------------------------------------


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.attention = nn.Module()
        self.attention.self = nn.Module()
        for name in ("query", "key", "value"):
            setattr(self.attention.self, name, nn.Linear(c.hidden, c.hidden))
        self.attention.output = nn.Module()
        self.attention.output.dense = nn.Linear(c.hidden, c.hidden)
        self.attention.output.LayerNorm = nn.LayerNorm(c.hidden, eps=c.eps)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(c.hidden, c.intermediate)
        self.output = nn.Module()
        self.output.dense = nn.Linear(c.intermediate, c.hidden)
        self.output.LayerNorm = nn.LayerNorm(c.hidden, eps=c.eps)


class BertModel(nn.Module):
    """bert-base-uncased's encoder, without the pooler (the grounding
    forward reads the sequence output)."""

    def __init__(self, c: BertConfig):
        super().__init__()
        self.config = c
        e = self.embeddings = nn.Module()
        e.word_embeddings = nn.Embedding(c.vocab_size, c.hidden)
        e.position_embeddings = nn.Embedding(c.max_position, c.hidden)
        e.token_type_embeddings = nn.Embedding(c.type_vocab, c.hidden)
        e.LayerNorm = nn.LayerNorm(c.hidden, eps=c.eps)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList([BertLayer(c) for _ in range(c.layers)])


class PackedAttention(nn.Module):
    """nn.MultiheadAttention's parameters: packed q / k / v projections."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


class MLP(nn.Module):
    """DETR MLP: ReLU between the layers, none after the last."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])


class MSDeformAttn(nn.Module):
    def __init__(self, c: GroundingDINOConfig):
        super().__init__()
        h, L, P = c.nheads, c.num_levels, c.num_points
        self.sampling_offsets = nn.Linear(c.d_model, h * L * P * 2)
        self.attention_weights = nn.Linear(c.d_model, h * L * P)
        self.value_proj = nn.Linear(c.d_model, c.d_model)
        self.output_proj = nn.Linear(c.d_model, c.d_model)


class EncoderLayer(nn.Module):
    def __init__(self, c: GroundingDINOConfig):
        super().__init__()
        self.self_attn = MSDeformAttn(c)
        self.norm1 = nn.LayerNorm(c.d_model)
        self.linear1 = nn.Linear(c.d_model, c.ffn_dim)
        self.linear2 = nn.Linear(c.ffn_dim, c.d_model)
        self.norm2 = nn.LayerNorm(c.d_model)


class TextLayer(nn.Module):
    def __init__(self, c: GroundingDINOConfig):
        super().__init__()
        self.self_attn = PackedAttention(c.d_model)
        self.norm1 = nn.LayerNorm(c.d_model)
        self.linear1 = nn.Linear(c.d_model, c.text_ffn_dim)
        self.linear2 = nn.Linear(c.text_ffn_dim, c.d_model)
        self.norm2 = nn.LayerNorm(c.d_model)


class FusionLayer(nn.Module):
    """BiAttentionBlock (fuse_modules.py:216-400)."""

    def __init__(self, c: GroundingDINOConfig):
        super().__init__()
        d, embed = c.d_model, 4 * c.d_model
        self.layer_norm_v = nn.LayerNorm(d)
        self.layer_norm_l = nn.LayerNorm(d)
        a = self.attn = nn.Module()
        for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj"):
            setattr(a, name, nn.Linear(d, embed))
        a.out_v_proj = nn.Linear(embed, d)
        a.out_l_proj = nn.Linear(embed, d)
        self.gamma_v = nn.Parameter(torch.full((d,), 1e-4))
        self.gamma_l = nn.Parameter(torch.full((d,), 1e-4))


class DecoderLayer(nn.Module):
    def __init__(self, c: GroundingDINOConfig):
        super().__init__()
        self.self_attn = PackedAttention(c.d_model)
        self.norm2 = nn.LayerNorm(c.d_model)
        self.ca_text = PackedAttention(c.d_model)
        self.catext_norm = nn.LayerNorm(c.d_model)
        self.cross_attn = MSDeformAttn(c)
        self.norm1 = nn.LayerNorm(c.d_model)
        self.linear1 = nn.Linear(c.d_model, c.ffn_dim)
        self.linear2 = nn.Linear(c.ffn_dim, c.d_model)
        self.norm3 = nn.LayerNorm(c.d_model)


class GroundingDINO(nn.Module):
    def __init__(self, config: GroundingDINOConfig = GDINO_SWINT):
        super().__init__()
        from motioneditor_tpu_torch.models.swin import SwinTransformer

        self.config = c = config
        d = c.d_model
        self.backbone = nn.ModuleList([SwinTransformer(c.swin)])
        self.bert = BertModel(c.bert)
        self.feat_map = nn.Linear(c.bert.hidden, d)
        n_backbone = len(c.swin.num_channels)
        self.input_proj = nn.ModuleList()
        for i in range(c.num_levels):
            if i < n_backbone:
                conv = nn.Conv2d(c.swin.num_channels[i], d, 1)
            else:
                conv = nn.Conv2d(c.swin.num_channels[-1], d, 3, stride=2, padding=1)
            self.input_proj.append(nn.Sequential(conv, nn.GroupNorm(32, d)))
        t = self.transformer = nn.Module()
        t.level_embed = nn.Parameter(torch.zeros(c.num_levels, d))
        t.encoder = nn.Module()
        t.encoder.layers = nn.ModuleList([EncoderLayer(c) for _ in range(c.enc_layers)])
        t.encoder.text_layers = nn.ModuleList([TextLayer(c) for _ in range(c.enc_layers)])
        t.encoder.fusion_layers = nn.ModuleList([FusionLayer(c) for _ in range(c.enc_layers)])
        t.enc_output = nn.Linear(d, d)
        t.enc_output_norm = nn.LayerNorm(d)
        t.enc_out_bbox_embed = MLP((d, d, d, 4))
        t.tgt_embed = nn.Embedding(c.num_queries, d)
        t.decoder = nn.Module()
        t.decoder.layers = nn.ModuleList([DecoderLayer(c) for _ in range(c.dec_layers)])
        t.decoder.norm = nn.LayerNorm(d)
        t.decoder.ref_point_head = MLP((2 * d, d, d))
        # dec_pred_bbox_embed_share=True: one box head for every decoder layer
        self.bbox_embed = nn.ModuleList([MLP((d, d, d, 4))])


@torch.no_grad()
def init_grounding_dino(model: GroundingDINO, generator: torch.Generator) -> GroundingDINO:
    """Random init with JAX's rules (init_grounding_dino):
    ``layers.init_params``; packed projections uniform in +-1/sqrt(d); the
    level embedding normal (std 0.02); the fusion gammas 1e-4; the
    deformable sampling offsets a ring of unit offsets scaled by the point
    index (zero weight), their attention weights zero; the shared box
    head's last layer zero."""
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.swin import init_swin

    c = model.config
    init_params(model, generator)
    init_swin(model.backbone[0], generator)
    model.transformer.level_embed.normal_(0.0, 0.02, generator=generator)
    h, L, P = c.nheads, c.num_levels, c.num_points
    thetas = np.arange(h) * (2.0 * math.pi / h)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None], (1, L, P, 1)) * np.arange(1, P + 1)[None, None, :, None]
    ring = torch.as_tensor(grid.reshape(-1), dtype=torch.float32)
    for m in model.modules():
        if isinstance(m, PackedAttention):
            bound = 1.0 / math.sqrt(m.in_proj_weight.shape[1])
            m.in_proj_weight.uniform_(-bound, bound, generator=generator)
            m.in_proj_bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, FusionLayer):
            m.gamma_v.fill_(1e-4)
            m.gamma_l.fill_(1e-4)
        elif isinstance(m, MSDeformAttn):
            m.sampling_offsets.weight.zero_()
            m.sampling_offsets.bias.copy_(ring)
            m.attention_weights.weight.zero_()
            m.attention_weights.bias.zero_()
    last = model.bbox_embed[0].layers[-1]
    last.weight.zero_()
    last.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# text encoder
# ---------------------------------------------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.matmul((q * scale).float(), k.float().transpose(-1, -2))


def _split(y: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = y.shape
    return y.reshape(b, n, heads, c // heads).transpose(1, 2)


def _merge(y: torch.Tensor) -> torch.Tensor:
    b, h, n, d = y.shape
    return y.transpose(1, 2).reshape(b, n, h * d)


def bert_apply(model: BertModel, input_ids: torch.Tensor, attn_mask: torch.Tensor,
               position_ids: torch.Tensor) -> torch.Tensor:
    """input_ids [B, N]; attn_mask [B, N, N] bool (True = attend);
    position_ids [B, N]. Returns the last hidden state [B, N, hidden]."""
    c, e = model.config, model.embeddings
    input_ids, position_ids = input_ids.long(), position_ids.long()
    x = (e.word_embeddings.weight[input_ids] + e.position_embeddings.weight[position_ids]
         + e.token_type_embeddings.weight[torch.zeros_like(input_ids)])
    x = layer_norm(e.LayerNorm, x, eps=c.eps)
    bias = torch.where(attn_mask[:, None], 0.0, -1e4)  # [B, 1, N, N]
    d = c.hidden // c.heads
    for p in model.encoder.layer:
        a = p.attention.self
        q, k, v = (_split(linear(m, x), c.heads) for m in (a.query, a.key, a.value))
        probs = torch.softmax(_scores(q, k, d**-0.5) + bias, dim=-1).to(v.dtype)
        o = linear(p.attention.output.dense, _merge(torch.matmul(probs, v)))
        x = layer_norm(p.attention.output.LayerNorm, x + o, eps=c.eps)
        y = linear(p.output.dense, F.gelu(linear(p.intermediate.dense, x)))
        x = layer_norm(p.output.LayerNorm, x + y, eps=c.eps)
    return x


# ---------------------------------------------------------------------------
# shared primitives
# ---------------------------------------------------------------------------


def _mha(p: PackedAttention, q_in, k_in, v_in, heads: int,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nn.MultiheadAttention's forward (no dropout) on [B, N*, C] inputs;
    ``bias`` additive [B or 1, 1, Nq, Nk]."""
    c = q_in.shape[-1]
    w, b = p.in_proj_weight.to(q_in.dtype), p.in_proj_bias.to(q_in.dtype)
    q = _split(F.linear(q_in, w[:c], b[:c]), heads)
    k = _split(F.linear(k_in, w[c:2 * c], b[c:2 * c]), heads)
    v = _split(F.linear(v_in, w[2 * c:], b[2 * c:]), heads)
    s = _scores(q, k, (c // heads) ** -0.5)
    if bias is not None:
        s = s + bias
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    return linear(p.out_proj, _merge(torch.matmul(probs, v)))


def _mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    n = len(p.layers)
    for i, lp in enumerate(p.layers):
        x = linear(lp, x)
        if i < n - 1:
            x = F.relu(x)
    return x


def _sine_embed(x: torch.Tensor, num_feats: int, temperature: float = 10000.0) -> torch.Tensor:
    """get_sine_pos_embed of one scalar channel: [..., 1] -> [..., num_feats],
    sin on the even features and cos on the odd, interleaved."""
    dim_t = temperature ** (2 * (np.arange(num_feats) // 2) / num_feats)
    ang = x * (2 * math.pi) / torch.as_tensor(dim_t, dtype=x.dtype, device=x.device)
    return torch.stack([torch.sin(ang[..., 0::2]), torch.cos(ang[..., 1::2])],
                       dim=-1).reshape(*ang.shape[:-1], num_feats)


def _box_sine_embed(ref: torch.Tensor, d_model: int) -> torch.Tensor:
    """gen_sineembed_for_position (utils.py:206-234): [..., 4] (cx cy w h)
    -> [..., 2 * d_model] ordered (y, x, w, h)."""
    nf = d_model // 2
    return torch.cat([_sine_embed(ref[..., i:i + 1], nf) for i in (1, 0, 2, 3)], dim=-1)


def _inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


# ---------------------------------------------------------------------------
# encoder and decoder layers
# ---------------------------------------------------------------------------


def _msdeform_apply(p: MSDeformAttn, query, value_tokens, reference_points, spatial_shapes,
                    cfg: GroundingDINOConfig) -> torch.Tensor:
    """query [B, Nq, C]; value_tokens [B, sum(HW), C]; reference_points
    [B, Nq, L, 2] (per level, the encoder) or [B, Nq, 4] (boxes, the
    decoder), normalized."""
    b, nq, c = query.shape
    h, L, P = cfg.nheads, cfg.num_levels, cfg.num_points
    value = linear(p.value_proj, value_tokens).reshape(b, -1, h, c // h)
    offsets = linear(p.sampling_offsets, query).reshape(b, nq, h, L, P, 2)
    weights = linear(p.attention_weights, query).reshape(b, nq, h, L * P)
    weights = torch.softmax(weights, dim=-1).reshape(b, nq, h, L, P)
    if reference_points.shape[-1] == 2:  # transformer.py:480
        normalizer = torch.as_tensor([[wl, hl] for hl, wl in spatial_shapes],
                                     dtype=offsets.dtype, device=offsets.device)
        loc = (reference_points[:, :, None, :, None, :]
               + offsets / normalizer[None, None, None, :, None, :])
    else:  # cx cy w h: offsets scale with the box (transformer.py:319)
        loc = (reference_points[:, :, None, None, None, :2]
               + offsets / P * reference_points[:, :, None, None, None, 2:] * 0.5)
    return linear(p.output_proj, ms_deform_attn(value, spatial_shapes, loc, weights))


def _fusion_apply(p: FusionLayer, v, l, text_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image <-> text attention. v [B, Nv, C]; l [B, Nt, C]; text_mask
    [B, Nt] bool (True = a real token)."""
    heads = FUSION_HEADS
    a = p.attn
    d = a.v_proj.out_features // heads
    vn = layer_norm(p.layer_norm_v, v)
    ln = layer_norm(p.layer_norm_l, l)
    q = _split(linear(a.v_proj, vn) * (d**-0.5), heads)
    k = _split(linear(a.l_proj, ln), heads)
    val_v = _split(linear(a.values_v_proj, vn), heads)
    val_l = _split(linear(a.values_l_proj, ln), heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    # stable_softmax_2d: the global max subtracted (fuse_modules.py:189), then
    # a clamp to +-50000 both ways
    s = (s - s.max()).clamp(-FUSION_CLAMP, FUSION_CLAMP)
    s_l = s.transpose(-1, -2)  # text -> image
    s_l = (s_l - s_l.max(dim=-1, keepdim=True).values).clamp(-FUSION_CLAMP, FUSION_CLAMP)
    s = torch.where(text_mask[:, None, None, :], s, float("-inf"))
    p_v = torch.softmax(s, dim=-1).to(val_l.dtype)
    p_l = torch.softmax(s_l, dim=-1).to(val_v.dtype)
    dv = linear(a.out_v_proj, _merge(torch.matmul(p_v, val_l)))
    dl = linear(a.out_l_proj, _merge(torch.matmul(p_l, val_v)))
    return vn + p.gamma_v.to(dv.dtype) * dv, ln + p.gamma_l.to(dl.dtype) * dl


def _text_layer_apply(p: TextLayer, text, text_self_mask, pos_text,
                      cfg: GroundingDINOConfig) -> torch.Tensor:
    """The text enhancer (post-LN, ReLU FFN); text_self_mask [B, Nt, Nt]
    bool, True = attend."""
    bias = torch.where(text_self_mask[:, None], 0.0, float("-inf"))
    q_in = text + pos_text
    text = layer_norm(p.norm1, text + _mha(p.self_attn, q_in, q_in, text, cfg.nheads, bias))
    y = linear(p.linear2, F.relu(linear(p.linear1, text)))
    return layer_norm(p.norm2, text + y)


def _enc_layer_apply(p: EncoderLayer, src, pos, reference_points, spatial_shapes,
                     cfg: GroundingDINOConfig) -> torch.Tensor:
    att = _msdeform_apply(p.self_attn, src + pos, src, reference_points, spatial_shapes, cfg)
    src = layer_norm(p.norm1, src + att)
    y = linear(p.linear2, F.relu(linear(p.linear1, src)))
    return layer_norm(p.norm2, src + y)


def _dec_layer_apply(p: DecoderLayer, tgt, query_pos, reference_points, memory, memory_text,
                     text_mask, spatial_shapes, cfg: GroundingDINOConfig) -> torch.Tensor:
    """transformer.py:868-957: self-attention, text cross-attention,
    deformable cross-attention, FFN, each post-LN."""
    q_in = tgt + query_pos
    tgt = layer_norm(p.norm2, tgt + _mha(p.self_attn, q_in, q_in, tgt, cfg.nheads))
    bias = torch.where(text_mask[:, None, None, :], 0.0, float("-inf"))
    att = _mha(p.ca_text, tgt + query_pos, memory_text, memory_text, cfg.nheads, bias)
    tgt = layer_norm(p.catext_norm, tgt + att)
    att = _msdeform_apply(p.cross_attn, tgt + query_pos, memory, reference_points,
                          spatial_shapes, cfg)
    tgt = layer_norm(p.norm1, tgt + att)
    y = linear(p.linear2, F.relu(linear(p.linear1, tgt)))
    return layer_norm(p.norm3, tgt + y)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def _group_norm_32(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm(32, eps 1e-5) over NHWC (input_proj, groundingdino.py:126)."""
    b, h, w, c = x.shape
    xg = x.float().reshape(b, h * w, 32, c // 32)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, unbiased=False)
    xg = (xg - mean) * torch.rsqrt(var + 1e-5)
    return (xg.reshape(b, h, w, c) * norm.weight.float() + norm.bias.float()).to(x.dtype)


def _sine_pos_hw(h: int, w: int, d_model: int, temperature: float) -> np.ndarray:
    """PositionEmbeddingSineHW with normalize=True (position_encoding.py:
    79-145), without padding: [H*W, d_model], host-side numpy."""
    nf = d_model // 2
    y = (np.arange(1, h + 1, dtype=np.float32) / (h + 1e-6))[:, None] * (2 * math.pi)
    x = (np.arange(1, w + 1, dtype=np.float32) / (w + 1e-6))[None, :] * (2 * math.pi)
    dim_t = temperature ** (2 * (np.arange(nf) // 2) / nf)
    pos_x = np.broadcast_to(x[..., None] / dim_t, (h, w, nf)).copy()
    pos_y = np.broadcast_to(y[..., None] / dim_t, (h, w, nf)).copy()
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], -1).reshape(h, w, nf)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], -1).reshape(h, w, nf)
    return np.concatenate([pos_y, pos_x], -1).reshape(h * w, d_model).astype(np.float32)


def _encoder_reference_points(spatial_shapes) -> np.ndarray:
    """The normalized (x, y) centre of every token of every level, for every
    level (transformer.py:465-480, valid ratios 1): [sum(HW), L, 2]."""
    pts = []
    for hl, wl in spatial_shapes:
        ry = (np.arange(hl, dtype=np.float32) + 0.5) / hl
        rx = (np.arange(wl, dtype=np.float32) + 0.5) / wl
        pts.append(np.stack(np.meshgrid(rx, ry, indexing="xy"), -1).reshape(-1, 2))
    ref = np.concatenate(pts, 0)
    return np.tile(ref[:, None], (1, len(spatial_shapes), 1))


def _proposals(spatial_shapes) -> Tuple[np.ndarray, np.ndarray]:
    """gen_encoder_output_proposals without padding (utils.py:57-119): the
    unsigmoided (cx cy w h) anchors [sum(HW), 4], +inf where invalid, and
    their validity [sum(HW)]."""
    props = []
    for lvl, (hl, wl) in enumerate(spatial_shapes):
        gy = (np.arange(hl, dtype=np.float32) + 0.5) / hl
        gx = (np.arange(wl, dtype=np.float32) + 0.5) / wl
        grid = np.stack(np.meshgrid(gx, gy, indexing="xy"), -1).reshape(-1, 2)
        props.append(np.concatenate([grid, np.full_like(grid, 0.05 * (2.0**lvl))], -1))
    p = np.concatenate(props, 0)
    valid = ((p > 0.01) & (p < 0.99)).all(-1)
    unsig = np.log(p / (1 - p))
    unsig[~valid] = np.inf
    return unsig, valid


def _contrastive_logits(x, text, text_mask, max_text_len: int) -> torch.Tensor:
    """ContrastiveEmbed (utils.py:237-268): the dot with the encoded text,
    -inf on padded tokens, right-padded with -inf to max_text_len."""
    res = torch.matmul(x.float(), text.float().transpose(-1, -2))
    res = torch.where(text_mask[:, None, :], res, float("-inf"))
    pad = max_text_len - res.shape[-1]
    if pad > 0:
        res = F.pad(res, (0, pad), value=float("-inf"))
    return res[..., :max_text_len]


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest scores per row, in descending order,
    ties to the lower index (``jax.lax.top_k``'s order): a stable sort."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def grounding_dino_encode(model: GroundingDINO, image: torch.Tensor, input_ids: torch.Tensor,
                          text_self_mask: torch.Tensor, position_ids: torch.Tensor,
                          text_token_mask: torch.Tensor) -> Dict[str, object]:
    """The backbones, the encoder and the scores the queries are chosen by.
    Inputs as ``grounding_dino_apply``'s. Returns memory [B, sum(HW), d],
    memory_text [B, Nt, d], spatial_shapes, coords_unsig [B, sum(HW), 4]
    (each encoder token's unsigmoided box) and scores [B, sum(HW)] (each
    token's best text logit, -inf at invalid proposals)."""
    cfg = model.config
    dev = image.device
    t = model.transformer
    encoded = bert_apply(model.bert, input_ids, text_self_mask, position_ids)
    text = linear(model.feat_map, encoded)  # [B, Nt, d_model]

    feats = swin_apply(model.backbone[0], image)
    srcs = []
    for i, proj in enumerate(model.input_proj):
        conv, norm = proj[0], proj[1]
        if i < len(feats):
            x = conv2d(conv, feats[i], stride=1, padding="SAME")
        else:
            x = conv2d(conv, feats[-1] if i == len(feats) else srcs[-1], stride=2, padding=1)
        srcs.append(_group_norm_32(norm, x))
    spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
    b = image.shape[0]
    src_flat = torch.cat([s.reshape(b, -1, cfg.d_model) for s in srcs], dim=1)
    pos_flat = torch.cat([
        torch.from_numpy(_sine_pos_hw(hl, wl, cfg.d_model, cfg.pe_temperature)).to(dev)[None]
        + t.level_embed[lvl][None, None]
        for lvl, (hl, wl) in enumerate(spatial_shapes)], dim=1)

    # encoder: fusion, text enhancer, deformable self-attention (transformer.py:545+)
    ref_pts = torch.from_numpy(_encoder_reference_points(spatial_shapes)).to(dev)[None]
    pos_text = _sine_embed(position_ids[..., None].float(), cfg.d_model)
    memory, memory_text = src_flat, text
    enc = t.encoder
    for i in range(cfg.enc_layers):
        memory, memory_text = _fusion_apply(enc.fusion_layers[i], memory, memory_text,
                                            text_token_mask)
        memory_text = _text_layer_apply(enc.text_layers[i], memory_text, text_self_mask,
                                        pos_text, cfg)
        memory = _enc_layer_apply(enc.layers[i], memory, pos_flat, ref_pts, spatial_shapes,
                                  cfg)

    # two-stage query selection (transformer.py:286-321); invalid proposals
    # are +inf, so memory is zeroed there before any product
    proposals, valid = _proposals(spatial_shapes)
    proposals = torch.from_numpy(proposals).to(dev)
    valid = torch.from_numpy(valid).to(dev)
    out_mem = torch.where(valid[None, :, None], memory, 0.0)
    out_mem = layer_norm(t.enc_output_norm, linear(t.enc_output, out_mem))
    enc_logits = _contrastive_logits(out_mem, memory_text, text_token_mask, cfg.max_text_len)
    scores = torch.where(valid[None], enc_logits.max(dim=-1).values, float("-inf"))
    coords_unsig = _mlp_apply(t.enc_out_bbox_embed, out_mem) + proposals[None]
    return {"memory": memory, "memory_text": memory_text, "spatial_shapes": spatial_shapes,
            "coords_unsig": coords_unsig, "scores": scores}


def grounding_dino_decode(model: GroundingDINO, enc: Dict[str, object], topk_idx: torch.Tensor,
                          text_token_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The decoder from the encoder tokens ``topk_idx`` [B, num_queries] of
    ``grounding_dino_encode``'s output ``enc``: pred_logits and pred_boxes
    as ``grounding_dino_apply`` returns them."""
    cfg = model.config
    t = model.transformer
    memory, memory_text = enc["memory"], enc["memory_text"]
    spatial_shapes = enc["spatial_shapes"]
    ref_unsig = torch.gather(enc["coords_unsig"], 1, topk_idx[..., None].expand(-1, -1, 4))
    refs = torch.sigmoid(ref_unsig)
    tgt = t.tgt_embed.weight[None].expand(memory.shape[0], -1, -1)

    # decoder (transformer.py:633-737)
    bbox = model.bbox_embed[0]
    refs_before = refs
    for dp in t.decoder.layers:
        query_pos = _mlp_apply(t.decoder.ref_point_head, _box_sine_embed(refs, cfg.d_model))
        tgt = _dec_layer_apply(dp, tgt, query_pos, refs, memory, memory_text, text_token_mask,
                               spatial_shapes, cfg)
        refs_before = refs
        refs = torch.sigmoid(_mlp_apply(bbox, tgt) + _inverse_sigmoid(refs))

    hs = layer_norm(t.decoder.norm, tgt)
    logits = _contrastive_logits(hs, memory_text, text_token_mask, cfg.max_text_len)
    # the last boxes recompute the last delta from the NORMED hidden state
    # and the reference before the last update: the reference's
    # groundingdino.py:321-327 applies bbox_embed to hs = norm(output),
    # while its decoder iterated the references on the unnormed output
    boxes = torch.sigmoid(_mlp_apply(bbox, hs) + _inverse_sigmoid(refs_before))
    return {"pred_logits": logits, "pred_boxes": boxes}


def grounding_dino_apply(model: GroundingDINO, image: torch.Tensor, input_ids: torch.Tensor,
                         text_self_mask: torch.Tensor, position_ids: torch.Tensor,
                         text_token_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The inference forward. image [B, H, W, 3] normalized with ImageNet's
    statistics; input_ids [B, Nt]; text_self_mask [B, Nt, Nt] and
    position_ids [B, Nt] from ``build_text_masks``; text_token_mask [B, Nt]
    bool. Returns pred_logits [B, num_queries, max_text_len] and pred_boxes
    [B, num_queries, 4] (normalized cx cy w h; groundingdino.py:313-336)."""
    enc = grounding_dino_encode(model, image, input_ids, text_self_mask, position_ids,
                                text_token_mask)
    topk_idx = top_k_indices(enc["scores"], model.config.num_queries)
    return grounding_dino_decode(model, enc, topk_idx, text_token_mask)
