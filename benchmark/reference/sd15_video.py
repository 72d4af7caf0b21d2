"""Plain reference of the MotionEditor video UNet, its motion adapter, the
openpose ControlNet, the DDIM steps and the stage-1 loss, over a dict of
parameters keyed by their diffusers names.

Written from the model's equations (Tune-A-Video's inflated SD-1.5 UNet
with MotionEditor's motion-frame attn1, causal temporal attention, the
content-aware motion adapter and the fg/bg attention injection) in float32
with TF32 off (``strict_fp32``). It imports nothing of the program under
test: the benchmark makes the parameters and inputs from the seed and
hands the same values to both sides, and this module works out again
whatever the program derives from them (the masks at each resolution, the
ControlNet's conditioning embedding, a training step's noise).

Attention is the explicit softmax(q k^T / sqrt(d)) v, computed in slices
of the leading dims so that no score matrix exceeds ``SCORE_BUDGET``
elements; under autograd each slice is checkpointed, so the backward
recomputes its scores. ``precision`` "fp8" is the lower-precision control
that the correctness limits are held against, a float8 program as one
would build it: every operand of a product (the inputs and weights of each
linear and convolution, q, k, the probabilities and v of each attention)
is rounded to float8 e4m3 with a per-tensor scale, every activation that
an op stores is rounded to bfloat16, and every gradient that flows back
through such a rounding to e5m2 or bfloat16 alike. "bf16" rounds products
and storage to bfloat16 (an emulation of the program's own precision).

Every attention site is reported to ``sites`` (a list, or None) as a dict
of its kind, query tokens, spatial tokens, flops and the elements it reads
and writes once: the benchmark's attention work, counted from the shapes.

Layouts follow the program's: videos [B, F, H, W, C], tokens [B, F, N, C].
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

SCORE_BUDGET = 1 << 28  # fp32 score elements per attention slice (1 GiB)
TEXT_LEN = 77
COND_EMBED_CHANNELS = (16, 32, 96, 256)
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def strict_fp32() -> None:
    """No TF32 in matmuls or convolutions: the reference is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# parameter layout
# ---------------------------------------------------------------------------


def _linear(out: dict, name: str, n_out: int, n_in: int, bias: bool = True) -> None:
    out[f"{name}.weight"] = (n_out, n_in)
    if bias:
        out[f"{name}.bias"] = (n_out,)


def _conv(out: dict, name: str, n_out: int, n_in: int, k: int) -> None:
    out[f"{name}.weight"] = (n_out, n_in, k, k)
    out[f"{name}.bias"] = (n_out,)


def _conv1d(out: dict, name: str, n_out: int, n_in: int, k: int) -> None:
    out[f"{name}.weight"] = (n_out, n_in, k)
    out[f"{name}.bias"] = (n_out,)


def _norm(out: dict, name: str, c: int) -> None:
    out[f"{name}.weight"] = (c,)
    out[f"{name}.bias"] = (c,)


def _attention(out: dict, name: str, c: int, kv: int) -> None:
    _linear(out, f"{name}.to_q", c, c, bias=False)
    _linear(out, f"{name}.to_k", c, kv, bias=False)
    _linear(out, f"{name}.to_v", c, kv, bias=False)
    _linear(out, f"{name}.to_out.0", c, c)


def _resnet(out: dict, name: str, c_in: int, c_out: int, temb: int, video: bool) -> None:
    _norm(out, f"{name}.norm1", c_in)
    _conv(out, f"{name}.conv1", c_out, c_in, 3)
    _linear(out, f"{name}.time_emb_proj", c_out, temb)
    _norm(out, f"{name}.norm2", c_out)
    _conv(out, f"{name}.conv2", c_out, c_out, 3)
    if c_in != c_out:
        _conv(out, f"{name}.conv_shortcut", c_out, c_in, 1)
    if video:
        _conv1d(out, f"{name}.temp_conv1", c_out, c_out, 3)
        _conv1d(out, f"{name}.temp_conv2", c_out, c_out, 3)


def _transformer(out: dict, name: str, c: int, video: bool, cross: int) -> None:
    _norm(out, f"{name}.norm", c)
    _conv(out, f"{name}.proj_in", c, c, 1)
    b = f"{name}.transformer_blocks.0"
    _norm(out, f"{b}.norm1", c)
    _attention(out, f"{b}.attn1", c, c)
    _norm(out, f"{b}.norm2", c)
    _attention(out, f"{b}.attn2", c, cross)
    _norm(out, f"{b}.norm3", c)
    _linear(out, f"{b}.ff.net.0.proj", 8 * c, c)
    _linear(out, f"{b}.ff.net.2", c, 4 * c)
    if video:
        _norm(out, f"{b}.norm_temp", c)
        _attention(out, f"{b}.attn_temp", c, c)
    _conv(out, f"{name}.proj_out", c, c, 1)


def _encoder(out: dict, ch: Sequence[int], layers: int, in_ch: int, video: bool,
             cross: int) -> None:
    temb = 4 * ch[0]
    _conv(out, "conv_in", ch[0], in_ch, 3)
    _linear(out, "time_embedding.linear_1", temb, ch[0])
    _linear(out, "time_embedding.linear_2", temb, temb)
    c_out = ch[0]
    for i in range(len(ch)):
        c_in, c_out = c_out, ch[i]
        for j in range(layers):
            _resnet(out, f"down_blocks.{i}.resnets.{j}", c_in if j == 0 else c_out, c_out,
                    temb, video)
            if i < len(ch) - 1:
                _transformer(out, f"down_blocks.{i}.attentions.{j}", c_out, video, cross)
        if i < len(ch) - 1:
            _conv(out, f"down_blocks.{i}.downsamplers.0.conv", c_out, c_out, 3)
    for j in range(2):
        _resnet(out, f"mid_block.resnets.{j}", ch[-1], ch[-1], temb, video)
    _transformer(out, "mid_block.attentions.0", ch[-1], video, cross)


def adapter_channels(ch: Sequence[int], layers: int) -> List[int]:
    """The channels of the 12 down residuals (conv_in, each resnet, each
    downsampler), which the ControlNet's zero convs and the adapter take."""
    chans = [ch[0]]
    for i, c in enumerate(ch):
        chans += [c] * layers
        if i < len(ch) - 1:
            chans.append(c)
    return chans


def unet_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of the video UNet with its motion adapter."""
    ch, layers = cfg["block_out_channels"], cfg["layers_per_block"]
    out: Dict[str, Tuple[int, ...]] = {}
    _encoder(out, ch, layers, cfg["in_channels"], True, cfg["cross_attention_dim"])
    temb = 4 * ch[0]
    rev = list(reversed(ch))
    c_out = rev[0]
    for i in range(len(rev)):
        prev, c_out = c_out, rev[i]
        c_in = rev[min(i + 1, len(rev) - 1)]
        for j in range(layers + 1):
            skip = c_in if j == layers else c_out
            _resnet(out, f"up_blocks.{i}.resnets.{j}", (prev if j == 0 else c_out) + skip,
                    c_out, temb, True)
            if i > 0:
                _transformer(out, f"up_blocks.{i}.attentions.{j}", c_out, True,
                             cfg["cross_attention_dim"])
        if i < len(rev) - 1:
            _conv(out, f"up_blocks.{i}.upsamplers.0.conv", c_out, c_out, 3)
    _norm(out, "conv_norm_out", ch[0])
    _conv(out, "conv_out", cfg["out_channels"], ch[0], 3)
    for i, c in enumerate(adapter_channels(ch, layers)):
        b = f"controlnet_adapter.body.{i}"
        _conv1d(out, f"{b}.block1", c, c, 3)
        _conv1d(out, f"{b}.block2", c, c, 1)
        _norm(out, f"{b}.norm_temp", c)
        _attention(out, f"{b}.attn_temp", c, c)
        _norm(out, f"{b}.cross_pose_norm", c)
        _attention(out, f"{b}.attn_pose", c, c)
        _norm(out, f"{b}.ff_norm", c)
        _linear(out, f"{b}.ff.net.0.proj", 8 * c, c)
        _linear(out, f"{b}.ff.net.2", c, 4 * c)
        _norm(out, f"{b}.norm_self_temp", c)
        _attention(out, f"{b}.attn_self_temp", c, c)
    return out


def controlnet_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of the 2D openpose ControlNet."""
    ch, layers = cfg["block_out_channels"], cfg["layers_per_block"]
    out: Dict[str, Tuple[int, ...]] = {}
    _encoder(out, ch, layers, cfg["in_channels"], False, cfg["cross_attention_dim"])
    e = COND_EMBED_CHANNELS
    _conv(out, "controlnet_cond_embedding.conv_in", e[0], 3, 3)
    for i in range(len(e) - 1):
        _conv(out, f"controlnet_cond_embedding.blocks.{2 * i}", e[i], e[i], 3)
        _conv(out, f"controlnet_cond_embedding.blocks.{2 * i + 1}", e[i + 1], e[i], 3)
    _conv(out, "controlnet_cond_embedding.conv_out", ch[0], e[-1], 3)
    for i, c in enumerate(adapter_channels(ch, layers)):
        _conv(out, f"controlnet_down_blocks.{i}", c, c, 1)
    _conv(out, "controlnet_mid_block", ch[-1], ch[-1], 1)
    return out


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and back; float8 with a per-tensor scale."""
    if dtype == torch.bfloat16:
        return x.to(dtype).to(x.dtype)
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX[dtype], torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Round(torch.autograd.Function):
    """Forward rounded to one dtype, the gradient to another."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


# (product operands forward, backward), or None for float32
PRODUCTS = {"fp32": None, "bf16": (torch.bfloat16, torch.bfloat16),
            "fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
    *lead, n, c = x.shape
    return x.reshape(*lead, n, heads, c // heads).movedim(-2, -3)


def _merge(x: torch.Tensor) -> torch.Tensor:
    x = x.movedim(-3, -2)
    *lead, n, h, d = x.shape
    return x.reshape(*lead, n, h * d)


def _prev_frames(f: int, device) -> torch.Tensor:
    """The frame before each frame; frame 0's is frame 0."""
    idx = torch.arange(f, device=device) - 1
    idx[0] = 0
    return idx


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of [..., H, W] to ``size``: source index floor(i * H / h)."""
    h, w = x.shape[-2:]
    rows = torch.floor(torch.arange(size[0], dtype=torch.float32) * np.float32(h / size[0]))
    cols = torch.floor(torch.arange(size[1], dtype=torch.float32) * np.float32(w / size[1]))
    x = x.index_select(-2, rows.long().to(x.device))
    return x.index_select(-1, cols.long().to(x.device))


class Reference:
    """The reference model over ``params`` ({name: tensor}, float32);
    ``cfg`` is the configuration file's ``model`` group."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, precision: str = "fp32",
                 sites: Optional[list] = None):
        self.p = params
        self.cfg = cfg
        self.products = PRODUCTS[precision]
        self.precision = precision
        self.sites = sites
        self.heads = cfg["attention_heads"]
        self.remat = True  # under autograd, recompute blocks and score slices in the backward

    # -- products ---------------------------------------------------------------

    def q8(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand in the product precision."""
        return x if self.products is None else _Round.apply(x, *self.products)

    def st(self, x: torch.Tensor) -> torch.Tensor:
        """A stored activation: bfloat16 below float32."""
        if self.products is None:
            return x
        return _Round.apply(x, torch.bfloat16, torch.bfloat16)

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.st(F.linear(self.q8(x), self.q8(self.p[f"{name}.weight"]),
                                self.p.get(f"{name}.bias")))

    def conv(self, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        """Per-image 2D conv of [..., H, W, C]; padding k // 2."""
        w = self.p[f"{name}.weight"]
        lead, (h, wd, c) = x.shape[:-3], x.shape[-3:]
        y = F.conv2d(self.q8(x.reshape(-1, h, wd, c).permute(0, 3, 1, 2)), self.q8(w),
                     self.p[f"{name}.bias"], stride=stride, padding=w.shape[-1] // 2)
        return self.st(y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], y.shape[1]))

    def temporal_conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Conv over the frame axis of [B, F, H, W, C] at every site; padding k // 2."""
        w = self.p[f"{name}.weight"]
        b, f, h, wd, c = x.shape
        xt = x.permute(0, 2, 3, 4, 1).reshape(b * h * wd, c, f)
        y = F.conv1d(self.q8(xt), self.q8(w), self.p[f"{name}.bias"], padding=w.shape[-1] // 2)
        return self.st(y.reshape(b, h, wd, -1, f).permute(0, 4, 1, 2, 3))

    def group_norm(self, name: str, x: torch.Tensor, eps: float, per_frame: bool = False):
        """GroupNorm of [B, F, H, W, C]: statistics over the frames too, or per frame."""
        g = self.cfg["norm_num_groups"]
        shape = x.shape
        lead = shape[0] * shape[1] if per_frame else shape[0]
        xg = x.reshape(lead, -1, g, shape[-1] // g)
        var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, unbiased=False)
        y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(shape)
        return self.st(y * self.p[f"{name}.weight"] + self.p[f"{name}.bias"])

    def layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.st(F.layer_norm(x, (x.shape[-1],), self.p[f"{name}.weight"],
                                    self.p[f"{name}.bias"], 1e-5))

    # -- attention --------------------------------------------------------------

    def _record(self, kind: str, lead: int, nq: int, nk: float, c: int, elems: int,
                tokens: int) -> None:
        """One site: 2 products of lead x nq x nk x c multiply-adds each."""
        if self.sites is not None:
            self.sites.append({"kind": kind, "nq": nq, "tokens": tokens,
                               "flops": 4 * lead * nq * nk * c, "elems": elems})

    def _softmax_pv(self, logits_fn, v_fn, lead_shape, heads, nq, nk):
        """softmax(logits) @ v over leading-dim slices within SCORE_BUDGET.
        ``logits_fn(sl)`` / ``v_fn(sl)`` give a slice's scores [..., H, nq, K]
        and its value product; each slice is checkpointed under autograd."""
        lead = int(np.prod(lead_shape))
        per = heads * nq * nk
        step = max(1, SCORE_BUDGET // per)
        outs = []
        for lo in range(0, lead, step):
            sl = slice(lo, min(lo + step, lead))
            if self.remat and torch.is_grad_enabled():
                outs.append(torch.utils.checkpoint.checkpoint(
                    lambda s=sl: v_fn(s, torch.softmax(logits_fn(s), dim=-1)),
                    use_reentrant=False))
            else:
                outs.append(v_fn(sl, torch.softmax(logits_fn(sl), dim=-1)))
        return torch.cat(outs, dim=0)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """softmax(q k^T / sqrt(d) + bias) v over [L, Nq, C] x [L, Nk, C]
        (heads packed in C); returns [L, Nq, C]."""
        h = self.heads
        scale = (q.shape[-1] // h) ** -0.5
        qh, kh, vh = _split(self.q8(q), h), _split(self.q8(k), h), _split(self.q8(v), h)

        def logits(s):
            z = torch.matmul(qh[s], kh[s].transpose(-1, -2)) * scale
            return z if bias is None else z + bias

        def pv(s, probs):
            return torch.matmul(self.q8(probs), vh[s])

        out = self._softmax_pv(logits, pv, qh.shape[:1], h, q.shape[-2], k.shape[-2])
        return self.st(_merge(out))

    def self_attention(self, name: str, x: torch.Tensor, mode: str) -> torch.Tensor:
        """attn over [B, F, N, C] with K/V from the same frame (normal), the
        previous and the same frame (motion_frame) or the first and the
        previous frame (sparse_causal)."""
        b, f, n, c = x.shape
        q, k, v = (self.linear(f"{name}.{t}", x) for t in ("to_q", "to_k", "to_v"))
        prev = _prev_frames(f, x.device)
        if mode == "normal":
            ks, vs = k, v
        elif mode == "motion_frame":
            ks, vs = torch.cat([k[:, prev], k], dim=2), torch.cat([v[:, prev], v], dim=2)
        elif mode == "sparse_causal":
            first = torch.zeros_like(prev)
            ks = torch.cat([k[:, first], k[:, prev]], dim=2)
            vs = torch.cat([v[:, first], v[:, prev]], dim=2)
        else:
            raise ValueError(mode)
        self._record("spatial", b * f, n, ks.shape[2], c, 4 * b * f * n * c, n)
        out = self.attend(q.reshape(b * f, n, c), ks.reshape(b * f, -1, c),
                          vs.reshape(b * f, -1, c))
        return self.linear(f"{name}.to_out.0", out.reshape(b, f, n, c))

    def cross_attention(self, name: str, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """Per-frame attention of [B, F, N, C] to ``kv`` [B, L, D] (text, shared
        by the frames) or [B, F, M, D] (the same frame's tokens)."""
        b, f, n, c = x.shape
        q = self.linear(f"{name}.to_q", x)
        k, v = self.linear(f"{name}.to_k", kv), self.linear(f"{name}.to_v", kv)
        kv_elems = 2 * k.numel()
        if k.dim() == 3:
            k, v = (t[:, None].expand(b, f, *t.shape[1:]) for t in (k, v))
        m = k.shape[2]
        self._record("spatial" if m == n else "cross", b * f, n, m, c,
                     2 * b * f * n * c + kv_elems, n)
        out = self.attend(q.reshape(b * f, n, c), k.reshape(b * f, m, c),
                          v.reshape(b * f, m, c))
        return self.linear(f"{name}.to_out.0", out.reshape(b, f, n, c))

    def temporal_attention(self, name: str, x: torch.Tensor,
                           kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Causal attention over the frames at every site of [B, F, N, C];
        ``kv`` substitutes the K/V source."""
        b, f, n, c = x.shape
        src = x if kv is None else kv
        q = self.linear(f"{name}.to_q", x)
        k, v = self.linear(f"{name}.to_k", src), self.linear(f"{name}.to_v", src)
        causal = torch.triu(torch.full((f, f), -1e4, device=x.device), diagonal=1)
        # causal: query frame i reads i + 1 keys
        self._record("temporal", b * n, f, (f + 1) / 2, c, 4 * b * f * n * c, n)
        t = (lambda z: z.transpose(1, 2).reshape(b * n, f, c))
        out = self.attend(t(q), t(k), t(v), bias=causal)
        return self.linear(f"{name}.to_out.0", out.reshape(b, n, f, c).transpose(1, 2))

    def injected_attention(self, name: str, x: torch.Tensor, mask: Optional[torch.Tensor]):
        """attn1 of the 4 branch rows [recon_u, edit_u, recon_c, edit_c]: the
        recon rows attend over their own [previous | current] frame; each edit
        row over the recon row's [previous | current] keys taken once with the
        fg mask and once with the bg mask, and its own current frame. A key
        multiplied by a mask value m scores m (q . k), so the masked logits
        are the recon logits times m and 1 - m; the two masked key sets read
        the same values. ``mask`` [F, N] of this resolution; None: the edit
        rows read the recon rows' keys wholesale."""
        _, f, n, c = x.shape
        q, k, v = (self.linear(f"{name}.{t}", x) for t in ("to_q", "to_k", "to_v"))
        prev = _prev_frames(f, x.device)
        k_mf = torch.cat([k[:, prev], k], dim=2)  # [4, F, 2N, C]
        v_mf = torch.cat([v[:, prev], v], dim=2)
        src, tgt = [0, 2], [1, 3]
        self._record("spatial", 2 * f, n, 2 * n, c, 8 * f * n * c, n)
        out_src = self.attend(q[src].reshape(2 * f, n, c), k_mf[src].reshape(2 * f, 2 * n, c),
                              v_mf[src].reshape(2 * f, 2 * n, c))
        if mask is None:
            self._record("spatial", 2 * f, n, 2 * n, c, 4 * f * n * c, n)
            out_tgt = self.attend(q[tgt].reshape(2 * f, n, c),
                                  k_mf[src].reshape(2 * f, 2 * n, c),
                                  v_mf[src].reshape(2 * f, 2 * n, c))
        else:
            m2 = torch.cat([mask[prev], mask], dim=1)  # [F, 2N]
            out_tgt = self._masked_attention(q[tgt], k_mf[src], v_mf[src], k[tgt], v[tgt], m2)
            self._record("spatial", 2 * f, n, 3 * n, c, 8 * f * n * c + 2 * f * n, n)
        out = torch.stack([out_src.reshape(2, f, n, c)[0], out_tgt[0],
                           out_src.reshape(2, f, n, c)[1], out_tgt[1]])
        return self.linear(f"{name}.to_out.0", out)

    def _masked_attention(self, q, k_src, v_src, k_tgt, v_tgt, m2):
        """softmax over [s m | s (1 - m) | q . k_tgt] of the edit rows, with s
        = q . k_src the recon keys' logits; values [v_src | v_src | v_tgt]."""
        r, f, n, c = q.shape
        h = self.heads
        scale = (c // h) ** -0.5
        qh = _split(self.q8(q).reshape(r * f, n, c), h)
        ks = _split(self.q8(k_src).reshape(r * f, 2 * n, c), h)
        vs = _split(self.q8(v_src).reshape(r * f, 2 * n, c), h)
        kt = _split(self.q8(k_tgt).reshape(r * f, n, c), h)
        vt = _split(self.q8(v_tgt).reshape(r * f, n, c), h)
        mm = m2.repeat(r, 1)[:, None, None, :]  # [r F, 1, 1, 2N]

        def logits(s):
            z = torch.matmul(qh[s], ks[s].transpose(-1, -2)) * scale
            zt = torch.matmul(qh[s], kt[s].transpose(-1, -2)) * scale
            return torch.cat([z * mm[s], z * (1 - mm[s]), zt], dim=-1)

        def pv(s, probs):
            p = self.q8(probs)
            return (torch.matmul(p[..., :2 * n] + p[..., 2 * n:4 * n], vs[s])
                    + torch.matmul(p[..., 4 * n:], vt[s]))

        out = self._softmax_pv(logits, pv, (r * f,), h, n, 5 * n)
        return self.st(_merge(out).reshape(r, f, n, c))

    # -- blocks -----------------------------------------------------------------

    def resnet(self, name: str, x, temb, video: bool, per_frame: bool = False):
        eps = self.cfg["norm_eps"]
        st = self.st
        h = self.conv(f"{name}.conv1", st(F.silu(self.group_norm(f"{name}.norm1", x, eps,
                                                                   per_frame))))
        if video:
            h = st(h + self.temporal_conv(f"{name}.temp_conv1", h))
        h = st(h + self.linear(f"{name}.time_emb_proj", F.silu(temb))[:, None, None, None, :])
        h = self.conv(f"{name}.conv2", st(F.silu(self.group_norm(f"{name}.norm2", h, eps,
                                                                   per_frame))))
        if video:
            h = st(h + self.temporal_conv(f"{name}.temp_conv2", h))
        if f"{name}.conv_shortcut.weight" in self.p:
            x = self.conv(f"{name}.conv_shortcut", x)
        return st(x + h)

    def transformer(self, name: str, x, text, layer: int, mode: str, video: bool,
                    inject=None):
        """Per-frame GN, proj_in, the transformer block, proj_out, + x.
        ``inject`` (masks by token count, or {} for none) turns on the fg/bg
        attn1 and the temporal K/V of the recon rows at this block."""
        b, f, hh, ww, c = x.shape
        y = self.conv(f"{name}.proj_in", self.group_norm(
            f"{name}.norm", x, self.cfg["transformer_norm_eps"], per_frame=True))
        tok = y.reshape(b, f, hh * ww, c)
        blk = f"{name}.transformer_blocks.0"
        h = self.layer_norm(f"{blk}.norm1", tok)
        if inject is not None:
            a1 = self.injected_attention(f"{blk}.attn1", h, inject.get(hh * ww))
        else:
            a1 = self.self_attention(f"{blk}.attn1", h, mode)
        st = self.st
        tok = st(tok + a1)
        tok = st(tok + self.cross_attention(f"{blk}.attn2", self.layer_norm(f"{blk}.norm2", tok),
                                            text))
        tok = st(tok + self.feed_forward(f"{blk}.ff", self.layer_norm(f"{blk}.norm3", tok)))
        if video:
            ht = self.layer_norm(f"{blk}.norm_temp", tok)
            kv = ht[[0, 0, 2, 2]] if inject is not None else None
            tok = st(tok + self.temporal_attention(f"{blk}.attn_temp", ht, kv))
        y = self.conv(f"{name}.proj_out", tok.reshape(b, f, hh, ww, c))
        return st(y + x)

    def feed_forward(self, name: str, x):
        h, gate = self.linear(f"{name}.net.0.proj", x).chunk(2, dim=-1)
        return self.linear(f"{name}.net.2", self.st(h * self.st(F.gelu(gate))))

    @staticmethod
    def _timesteps(t, sample: torch.Tensor) -> torch.Tensor:
        """A timestep per batch row from an int or a [B] tensor."""
        if isinstance(t, torch.Tensor):
            return t
        return torch.full((sample.shape[0],), t, device=sample.device)

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """diffusers' sinusoidal embedding (cos first, shift 0) and its MLP."""
        half = self.cfg["block_out_channels"][0] // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                            device=t.device) / half)
        arg = t.float()[:, None] * freqs[None]
        emb = torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)
        return self.linear("time_embedding.linear_2",
                           F.silu(self.linear("time_embedding.linear_1", emb)))

    def _checkpointed(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # -- the networks -------------------------------------------------------------

    def adapter_block(self, i: int, x, source):
        """The motion adapter's block i on a ControlNet residual x and the
        UNet's feature ``source`` (both [B, F, H, W, C])."""
        name = f"controlnet_adapter.body.{i}"
        b, f, hh, ww, c = x.shape
        st = self.st
        conv = st(self.temporal_conv(f"{name}.block2",
                                     F.relu(self.temporal_conv(f"{name}.block1", x))) + x)
        tok = x.reshape(b, f, hh * ww, c)
        tok = st(tok + self.self_attention(f"{name}.attn_temp",
                                           self.layer_norm(f"{name}.norm_temp", tok),
                                           "sparse_causal"))
        tok = st(tok + self.cross_attention(f"{name}.attn_pose",
                                            self.layer_norm(f"{name}.cross_pose_norm", tok),
                                            source.reshape(b, f, hh * ww, c)))
        tok = st(tok + self.feed_forward(f"{name}.ff", self.layer_norm(f"{name}.ff_norm", tok)))
        tok = st(tok + self.temporal_attention(f"{name}.attn_self_temp",
                                               self.layer_norm(f"{name}.norm_self_temp", tok)))
        return st(tok.reshape(b, f, hh, ww, c) + conv)

    def _down(self, h, temb, text, mode, video, per_frame, inject_from, masks):
        cfg = self.cfg
        ch, layers = cfg["block_out_channels"], cfg["layers_per_block"]
        skips, layer = [h], 0
        for i in range(len(ch)):
            for j in range(layers):
                h = self._checkpointed(
                    lambda hh, n=f"down_blocks.{i}.resnets.{j}": self.resnet(
                        n, hh, temb, video, per_frame), h)
                if i < len(ch) - 1:
                    inj = masks if layer >= inject_from else None
                    h = self._checkpointed(
                        lambda hh, n=f"down_blocks.{i}.attentions.{j}", l=layer, ij=inj:
                        self.transformer(n, hh, text, l, mode, video, ij), h)
                    layer += 1
                skips.append(h)
            if i < len(ch) - 1:
                h = self.conv(f"down_blocks.{i}.downsamplers.0.conv", h, stride=2)
                skips.append(h)
        return h, skips, layer

    def _mid(self, h, temb, text, mode, video, per_frame, layer, inject_from, masks):
        h = self.resnet("mid_block.resnets.0", h, temb, video, per_frame)
        h = self.transformer("mid_block.attentions.0", h, text, layer, mode, video,
                             masks if layer >= inject_from else None)
        return self.resnet("mid_block.resnets.1", h, temb, video, per_frame)

    def unet(self, sample, t, text, mode: str = "motion_frame", injection=None,
             control=None):
        """The video UNet on [B, F, h, w, 4]. ``injection``: (first injected
        block, {token count: mask [F, N]}) over the 4 branch rows.
        ``control``: (12 down residuals, mid residual) of the ControlNet on
        the edit rows [1, 3], which the adapter takes against those rows'
        features; the recon rows get none."""
        inject_from, masks = injection if injection is not None else (1 << 30, None)
        temb = self.time_embedding(self._timesteps(t, sample))
        h = self.conv("conv_in", sample)
        h, skips, layer = self._down(h, temb, text, mode, True, False, inject_from, masks)
        mid_res = None
        if control is not None:
            down_res, mid2 = control
            rows = [1, 3]
            adapted = [self.adapter_block(i, r, s[rows])
                       for i, (r, s) in enumerate(zip(down_res, skips))]
            skips = [s + torch.stack([torch.zeros_like(a[0]), a[0], torch.zeros_like(a[0]), a[1]])
                     for s, a in zip(skips, adapted)]
            mid_res = torch.stack([torch.zeros_like(mid2[0]), mid2[0], torch.zeros_like(mid2[0]),
                                   mid2[1]])
        h = self._checkpointed(lambda hh: self._mid(hh, temb, text, mode, True, False, layer,
                                                    inject_from, masks), h)
        if mid_res is not None:
            h = h + mid_res
        layer += 1
        cfg = self.cfg
        ch, layers = cfg["block_out_channels"], cfg["layers_per_block"]
        for i in range(len(ch)):
            for j in range(layers + 1):
                x = torch.cat([h, skips.pop()], dim=-1)
                h = self._checkpointed(
                    lambda hh, n=f"up_blocks.{i}.resnets.{j}": self.resnet(n, hh, temb, True), x)
                if i > 0:
                    inj = masks if layer >= inject_from else None
                    h = self._checkpointed(
                        lambda hh, n=f"up_blocks.{i}.attentions.{j}", l=layer, ij=inj:
                        self.transformer(n, hh, text, l, mode, True, ij), h)
                    layer += 1
            if i < len(ch) - 1:
                bb, f, hh, ww, c = h.shape
                up = h.reshape(bb * f, hh, ww, c).repeat_interleave(2, 1).repeat_interleave(2, 2)
                h = self.conv(f"up_blocks.{i}.upsamplers.0.conv", up.reshape(bb, f, 2 * hh,
                                                                             2 * ww, c))
        h = F.silu(self.group_norm("conv_norm_out", h, cfg["norm_eps"]))
        return self.conv("conv_out", h)

    def cond_embedding(self, image):
        """The ControlNet's conditioning CNN: [..., H, W, 3] -> [..., H/8, W/8, C0]."""
        n = "controlnet_cond_embedding"
        x = F.silu(self.conv(f"{n}.conv_in", image))
        for i in range(2 * (len(COND_EMBED_CHANNELS) - 1)):
            x = F.silu(self.conv(f"{n}.blocks.{i}", x, stride=2 if i % 2 else 1))
        return self.conv(f"{n}.conv_out", x)

    def controlnet(self, sample, t, text, cond_emb, scale: float):
        """The 2D ControlNet per frame: (12 down residuals, mid residual)."""
        temb = self.time_embedding(self._timesteps(t, sample))
        h = self.conv("conv_in", sample) + cond_emb
        h, skips, layer = self._down(h, temb, text, "normal", False, True, 1 << 30, None)
        h = self._mid(h, temb, text, "normal", False, True, layer, 1 << 30, None)
        down = [self.conv(f"controlnet_down_blocks.{i}", s) * scale for i, s in enumerate(skips)]
        return down, self.conv("controlnet_mid_block", h) * scale


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------


def alphas_cumprod(sched: dict) -> torch.Tensor:
    """SD-1.5's scaled-linear schedule: cumprod(1 - beta), beta from
    linspace(sqrt(beta_start), sqrt(beta_end), T) squared (float64, then float32)."""
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5,
                        sched["num_train_timesteps"], dtype=np.float64) ** 2
    return torch.as_tensor(np.cumprod(1.0 - betas), dtype=torch.float32)


def timesteps(sched: dict, steps: int) -> List[int]:
    """DDIM's descending timesteps: [T/steps * i + offset] reversed."""
    ratio = sched["num_train_timesteps"] // steps
    return [int(i * ratio + sched["steps_offset"]) for i in reversed(range(steps))]


def ddim_step(acp: torch.Tensor, sched: dict, eps, t: int, x, steps: int):
    """x_t -> x_{t - T/steps}, eta 0; below 0 the final alpha is acp[0]."""
    prev = t - sched["num_train_timesteps"] // steps
    a_t = float(acp[t])
    a_prev = float(acp[prev]) if prev >= 0 else float(acp[0])
    x0 = (x - math.sqrt(1 - a_t) * eps) / math.sqrt(a_t)
    return math.sqrt(a_prev) * x0 + math.sqrt(1 - a_prev) * eps


def ddim_inverse_step(acp: torch.Tensor, sched: dict, eps, t: int, x, steps: int):
    """x_{t - T/steps} -> x_t, the model evaluated at (x, t)."""
    frm = min(t - sched["num_train_timesteps"] // steps, sched["num_train_timesteps"] - 1)
    a_from = float(acp[frm]) if frm >= 0 else float(acp[0])
    a_to = float(acp[t])
    x0 = (x - math.sqrt(1 - a_from) * eps) / math.sqrt(a_from)
    return math.sqrt(a_to) * x0 + math.sqrt(1 - a_to) * eps


def edit_step(ref: Reference, cn: Reference, acp, sched: dict, lat, t: int, cond, uncond,
              cond_emb, masks, inject_from: Optional[int], guidance: float, cn_scale: float,
              steps: int):
    """One two-branch edit step on lat [2, F, h, w, 4] = [recon, edit]: the
    ControlNet on the edit rows under [uncond, target] text, the UNet on the
    4 rows [recon_u, edit_u, recon_c, edit_c] with the adapter and, from
    block ``inject_from`` (None: none), the fg/bg injection; CFG; DDIM."""
    x4 = torch.cat([lat, lat])
    text4 = torch.cat([uncond, cond])
    control = cn.controlnet(x4[[1, 3]], t, text4[[1, 3]], cond_emb, cn_scale)
    injection = None if inject_from is None else (inject_from, masks)
    eps = ref.unet(x4, t, text4, "motion_frame", injection, control)
    eps_u, eps_c = eps[:2], eps[2:]
    return ddim_step(acp, sched, eps_u + guidance * (eps_c - eps_u), t, lat, steps)


def stage1_loss(ref: Reference, acp, latents, text, noise, t: torch.Tensor):
    """The epsilon-prediction loss of stage 1: the UNet on the latents noised
    at ``t`` against the noise, mean squared, with motion-frame attn1."""
    a = acp.to(latents.device)[t].reshape(-1, 1, 1, 1, 1)
    noisy = a.sqrt() * latents + (1 - a).sqrt() * noise
    pred = ref.unet(noisy, t, text, "motion_frame")
    return ((pred - noise) ** 2).mean()
