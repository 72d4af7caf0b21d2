"""Attention injection as static dispatch (port of
motioneditor_tpu/control/injection.py: the mask, mutual and auto modes).

Branch-axis convention (size-4 leading axis): [recon_u, edit_u, recon_c,
edit_c]. Source rows are (0, 2), target (edit) rows (1, 3), and the temporal
K/V of every row comes from the reconstruction row of its CFG half
(0, 0, 2, 2). ``InjectionSpec`` carries per-transformer-block gates in
forward order (down 0-5, mid 6, up 7-15).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from motioneditor_tpu_torch.models.layers import nearest_resize
from motioneditor_tpu_torch.ops.attention import (
    _FLASH_MIN_Q,
    MOTION_FRAME,
    Attention,
    local_heads,
    merge_heads,
    project_out,
    project_qkv,
    sdpa,
    select_kv,
    split_heads,
)

NUM_TRANSFORMER_BLOCKS = 16  # SD-1.5

SRC_ROWS = (0, 2)  # reconstruction branch (uncond, cond)
TGT_ROWS = (1, 3)  # editing branch
TGT_TO_SRC = (0, 0, 2, 2)  # temporal K/V source row per branch row


@dataclasses.dataclass(frozen=True)
class InjectionSpec:
    """Static injection configuration for one timestep segment; the same
    fields and defaults as the JAX ``InjectionSpec``. ``mask_mode`` "mask"
    is the fg/bg K/V decomposition, "mutual" reads source K/V wholesale,
    "auto" recomposes fg and bg attention with a mask derived from the
    current step's 16x16 cross-attention maps (``auto_token_idx`` picks the
    anchor tokens, ``auto_thres`` binarizes)."""

    active: bool = False
    spatial_layers: Tuple[bool, ...] = (False,) * NUM_TRANSFORMER_BLOCKS
    temporal_layers: Tuple[bool, ...] = (False,) * NUM_TRANSFORMER_BLOCKS
    mask_mode: str = "mask"
    auto_token_idx: Tuple[int, ...] = (1,)
    auto_thres: float = 0.1

    @property
    def mask_fgbg(self) -> bool:
        return self.mask_mode == "mask"

    @property
    def collect_cross_maps(self) -> bool:
        return self.mask_mode == "auto"

    @staticmethod
    def from_start_layer(
        start_layer: int = 10,
        total_layers: int = NUM_TRANSFORMER_BLOCKS,
        mask_fgbg: bool = True,
        layer_idx: Optional[Tuple[int, ...]] = None,
        mask_mode: Optional[str] = None,
        auto_token_idx: Tuple[int, ...] = (1,),
        auto_thres: float = 0.1,
    ) -> "InjectionSpec":
        layers = tuple(
            (i in layer_idx) if layer_idx is not None else (i >= start_layer)
            for i in range(total_layers)
        )
        if mask_mode is None:
            mask_mode = "mask" if mask_fgbg else "mutual"
        return InjectionSpec(
            active=True,
            spatial_layers=layers,
            temporal_layers=layers,
            mask_mode=mask_mode,
            auto_token_idx=tuple(auto_token_idx),
            auto_thres=auto_thres,
        )


def segment_step_ranges(num_steps: int, start_step: int = 4,
                        step_idx: Optional[Tuple[int, ...]] = None):
    """Split [0, num_steps) into contiguous (lo, hi, injected) segments."""
    gate = [
        (i in step_idx) if step_idx is not None else (i >= start_step)
        for i in range(num_steps)
    ]
    segments = []
    lo = 0
    for i in range(1, num_steps + 1):
        if i == num_steps or gate[i] != gate[lo]:
            segments.append((lo, i, gate[lo]))
            lo = i
    return tuple(segments)


def prepare_injection_masks(
    source_masks: torch.Tensor,
    num_frames: int,
    resolutions: Tuple[Tuple[int, int], ...] = ((64, 64), (32, 32), (16, 16), (8, 8)),
) -> Dict[Tuple[int, int], torch.Tensor]:
    """[F, H, W] binary masks -> {(h, w): [F, h*w, 1]} nearest-resized."""
    f = source_masks.shape[0]
    if f != num_frames:
        raise ValueError(f"{f} masks for {num_frames} frames")
    out = {}
    for (h, w) in resolutions:
        m = nearest_resize(source_masks[..., None], (h, w))
        out[(h, w)] = m.reshape(f, h * w, 1)
    return out


def motion_frame_mask(mask_n: torch.Tensor) -> torch.Tensor:
    """[F, N, 1] -> [F, 2N, 1]: [prev-frame mask, current mask]."""
    f = mask_n.shape[0]
    former = torch.arange(f, device=mask_n.device) - 1
    former[0] = 0
    return torch.cat([mask_n[former], mask_n], dim=1)


def injected_spatial_attention(p: Attention, x: torch.Tensor, heads: int,
                               mask_n: Optional[torch.Tensor], mask_fgbg: bool = True,
                               use_flash: bool = True, shard=None) -> torch.Tensor:
    """FullySelfAttentionControlMask forward. x: [4, F, N, C].

    Source rows: motion-frame attention over their own [prev, cur] K/V.
    Target rows: Q unchanged; K = [K_src*m, K_src*(1-m), K_tgt_cur],
    V = [V_src, V_src, V_tgt_cur]. Without a mask (or mask_fgbg=False) the
    target rows read the source rows' [prev, cur] K/V wholesale.

    ``shard`` (a FrameShardingCtx): x and mask_n hold the local frames; the
    source rows' [prev, cur] K/V and the mask are built over the frame halo
    once, the source rows run K12 on them and the masked edit rows K13 (JAX
    injection.py:195-224). The branch axis stays local. Under a model group
    (parallel/tp.py) every route runs on this rank's heads."""
    from motioneditor_tpu_torch.ops.injection_flash import fused_injection_attention
    from motioneditor_tpu_torch.ops.video_flash import (
        video_flash_attention,
        video_flash_supported,
        video_injection_attention,
    )

    b, f, n, c = x.shape
    if b != 4:
        raise ValueError("injection requires the 4-row branch axis")
    q, k, v = project_qkv(p, x)
    heads = local_heads(p, heads)
    inner = q.shape[-1]
    scale = (inner // heads) ** -0.5
    src = list(SRC_ROWS)
    tgt = list(TGT_ROWS)
    use_mask = mask_fgbg and mask_n is not None

    if shard is not None:
        from motioneditor_tpu_torch.parallel import flash_sharding as fs

        kernel = use_flash and n >= _FLASH_MIN_Q and video_flash_supported(inner, heads)
        k_mf = fs.build_kv(k[src], MOTION_FRAME, shard)  # [2, F, 2N, C]
        v_mf = fs.build_kv(v[src], MOTION_FRAME, shard)
        out_src = fs.kv_attention(q[src], k_mf, v_mf, scale, heads, kernel)
        if use_mask:
            m2 = fs.motion_frame_mask(mask_n[..., 0], shard)
            out_tgt = fs.injection_attention(q[tgt], k_mf, v_mf, k[tgt], v[tgt], m2, scale,
                                             heads, kernel)
        else:
            out_tgt = fs.kv_attention(q[tgt], k_mf, v_mf, scale, heads, kernel)
        out = torch.stack([out_src[0], out_tgt[0], out_src[1], out_tgt[1]], dim=0)
        return project_out(p, out)

    if use_flash and n >= _FLASH_MIN_Q and video_flash_supported(inner, heads):
        # packed-head kernels: head split, motion-frame K/V selection and
        # the fg/bg decomposition all happen in-kernel
        out_src = video_flash_attention(q[src], k[src], v[src], MOTION_FRAME, scale, heads)
        if use_mask:
            out_tgt = video_injection_attention(
                q[tgt], k[src], v[src], k[tgt], v[tgt], mask_n[..., 0], scale, heads)
        else:
            out_tgt = video_flash_attention(q[tgt], k[src], v[src], MOTION_FRAME, scale,
                                            heads)
        out = torch.stack([out_src[0], out_tgt[0], out_src[1], out_tgt[1]], dim=0)
        return project_out(p, out)

    # split-head branch, for head dims the packed kernels decline: K8 for
    # the source rows (through sdpa) and K9 for the masked edit rows
    k_mf = select_kv(k[src], MOTION_FRAME)  # [2, F, 2N, C]
    v_mf = select_kv(v[src], MOTION_FRAME)
    q_t = split_heads(q[tgt], heads)
    out_src = sdpa(split_heads(q[src], heads), split_heads(k_mf, heads),
                   split_heads(v_mf, heads), scale, use_flash=use_flash)
    if not use_mask:
        out_tgt = sdpa(q_t, split_heads(k_mf, heads), split_heads(v_mf, heads), scale,
                       use_flash=use_flash)
    elif use_flash and n >= _FLASH_MIN_Q:
        out_tgt = fused_injection_attention(
            q_t, split_heads(k_mf, heads), split_heads(v_mf, heads),
            motion_frame_mask(mask_n)[..., 0], split_heads(k[tgt], heads),
            split_heads(v[tgt], heads), scale)
    else:
        m = motion_frame_mask(mask_n).to(k.dtype)  # [F, 2N, 1]
        k_inj = torch.cat([k_mf * m, k_mf * (1.0 - m), k[tgt]], dim=2)
        v_inj = torch.cat([v_mf, v_mf, v[tgt]], dim=2)
        out_tgt = sdpa(q_t, split_heads(k_inj, heads), split_heads(v_inj, heads), scale)
    out = torch.stack([out_src[0], out_tgt[0], out_src[1], out_tgt[1]], dim=0)
    return project_out(p, merge_heads(out))


def injected_temporal_kv(x: torch.Tensor) -> torch.Tensor:
    """Every branch row reads the reconstruction row of its CFG half."""
    return x[list(TGT_TO_SRC)]


def aggregate_cross_attn_mask(cross_maps, token_idx: Tuple[int, ...], res: int,
                              thres: float) -> torch.Tensor:
    """The auto mask from the collected 16x16 cross-attention maps, a list
    of [4F, 256, L] mean-over-heads probabilities: averaged over the list,
    summed over ``token_idx``, min-max normalized per map, the cond-edit rows
    (3F:) nearest-resized to res x res and binarized at ``>= thres``.
    Returns [F, res*res, 1]."""
    agg = torch.stack(list(cross_maps), dim=1).mean(dim=1)  # [4F, 256, L]
    img = agg[..., list(token_idx)].sum(-1)  # [4F, 256]
    n16 = int(round(img.shape[-1] ** 0.5))
    img = img.reshape(-1, n16, n16)
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    img = (img - lo) / torch.clamp(hi - lo, min=1e-8)
    f = img.shape[0] // 4
    tgt = nearest_resize(img[3 * f:, :, :, None], (res, res))[..., 0]
    return (tgt >= thres).to(img.dtype).reshape(f, res * res, 1)


def injected_spatial_attention_auto(p: Attention, x: torch.Tensor, heads: int,
                                    source_mask_n: Optional[torch.Tensor], cross_maps,
                                    token_idx: Tuple[int, ...], thres: float,
                                    use_flash: bool = True, shard=None) -> torch.Tensor:
    """FullySelfAttentionControlMaskAuto forward. x: [4, F, N, C].

    Source rows: motion-frame attention over their own [prev, cur] K/V.
    Target rows attend only to the source rows' [prev, cur] K/V, twice: once
    with K and V multiplied by the fg mask, once by the bg mask (masked keys
    score 0 and keep their softmax weight), and the two outputs are
    recomposed with the auto mask from ``cross_maps``. Without maps or
    without a source mask the target rows read the source K/V wholesale.

    ``shard`` (a FrameShardingCtx): x, the source mask and the maps hold the
    local frames; the motion-frame K/V and the source mask are built over
    the frame halo. The auto mask is frame-local (each frame's map is
    normalized on its own). The caller passes ``use_flash`` off under a
    shard, as JAX does (unet.py:333-336). Under a model group every sdpa
    runs on this rank's heads (K8 at H / T heads of C / T channels), and
    ``cross_maps`` are the full width's (ops/attention.py ``head_mean``)."""
    b, f, n, c = x.shape
    if b != 4:
        raise ValueError("injection requires the 4-row branch axis")
    q, k, v = project_qkv(p, x)
    heads = local_heads(p, heads)
    scale = (q.shape[-1] // heads) ** -0.5
    if shard is not None:
        from motioneditor_tpu_torch.parallel import flash_sharding as fs

        k_mf = fs.build_kv(k[list(SRC_ROWS)], MOTION_FRAME, shard)  # [2, F, 2N, C]
        v_mf = fs.build_kv(v[list(SRC_ROWS)], MOTION_FRAME, shard)
    else:
        k_mf = select_kv(k[list(SRC_ROWS)], MOTION_FRAME)
        v_mf = select_kv(v[list(SRC_ROWS)], MOTION_FRAME)
    out_src = sdpa(split_heads(q[list(SRC_ROWS)], heads), split_heads(k_mf, heads),
                   split_heads(v_mf, heads), scale, use_flash=use_flash)
    q_t = split_heads(q[list(TGT_ROWS)], heads)
    if not cross_maps or source_mask_n is None:
        out_tgt = sdpa(q_t, split_heads(k_mf, heads), split_heads(v_mf, heads), scale,
                       use_flash=use_flash)
    else:
        if shard is not None:
            m = fs.motion_frame_mask(source_mask_n[..., 0], shard)[..., None].to(k.dtype)
        else:
            m = motion_frame_mask(source_mask_n).to(k.dtype)  # [F, 2N, 1]
        out_fg = sdpa(q_t, split_heads(k_mf * m, heads), split_heads(v_mf * m, heads), scale,
                      use_flash=use_flash)
        out_bg = sdpa(q_t, split_heads(k_mf * (1 - m), heads),
                      split_heads(v_mf * (1 - m), heads), scale, use_flash=use_flash)
        sm = aggregate_cross_attn_mask(cross_maps, token_idx, int(round(n ** 0.5)), thres)
        sm = sm.reshape(1, f, 1, n, 1).to(out_fg.dtype)  # over rows and heads
        out_tgt = out_fg * sm + out_bg * (1 - sm)
    out = torch.stack([out_src[0], out_tgt[0], out_src[1], out_tgt[1]], dim=0)
    return project_out(p, merge_heads(out))
