"""Attention injection as static dispatch (port of
motioneditor_tpu/control/injection.py, mask and mutual modes).

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

from motioneditor_tpu_torch.models.layers import linear, nearest_resize
from motioneditor_tpu_torch.ops.attention import (
    _FLASH_MIN_Q,
    MOTION_FRAME,
    Attention,
    merge_heads,
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
    is the fg/bg K/V decomposition, "mutual" reads source K/V wholesale;
    "auto" is not ported yet."""

    active: bool = False
    spatial_layers: Tuple[bool, ...] = (False,) * NUM_TRANSFORMER_BLOCKS
    temporal_layers: Tuple[bool, ...] = (False,) * NUM_TRANSFORMER_BLOCKS
    mask_mode: str = "mask"
    auto_token_idx: Tuple[int, ...] = (1,)
    auto_thres: float = 0.1

    @property
    def mask_fgbg(self) -> bool:
        return self.mask_mode == "mask"

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
                               use_flash: bool = True) -> torch.Tensor:
    """FullySelfAttentionControlMask forward. x: [4, F, N, C].

    Source rows: motion-frame attention over their own [prev, cur] K/V.
    Target rows: Q unchanged; K = [K_src*m, K_src*(1-m), K_tgt_cur],
    V = [V_src, V_src, V_tgt_cur]. Without a mask (or mask_fgbg=False) the
    target rows read the source rows' [prev, cur] K/V wholesale."""
    from motioneditor_tpu_torch.ops.video_flash import (
        video_flash_attention,
        video_flash_supported,
        video_injection_attention,
    )

    b, f, n, c = x.shape
    if b != 4:
        raise ValueError("injection requires the 4-row branch axis")
    q = linear(p.to_q, x)
    k = linear(p.to_k, x)
    v = linear(p.to_v, x)
    inner = q.shape[-1]
    scale = (inner // heads) ** -0.5
    src = list(SRC_ROWS)
    tgt = list(TGT_ROWS)
    use_mask = mask_fgbg and mask_n is not None

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
        return linear(p.to_out[0], out)

    k_mf = select_kv(k, MOTION_FRAME)  # [4, F, 2N, C]
    v_mf = select_kv(v, MOTION_FRAME)
    out_src = sdpa(split_heads(q[src], heads), split_heads(k_mf[src], heads),
                   split_heads(v_mf[src], heads), scale)
    if use_mask:
        m = motion_frame_mask(mask_n).to(k.dtype)  # [F, 2N, 1]
        k_src = k_mf[src]
        v_src = v_mf[src]
        k_inj = torch.cat([k_src * m, k_src * (1.0 - m), k[tgt]], dim=2)
        v_inj = torch.cat([v_src, v_src, v[tgt]], dim=2)
    else:
        k_inj = k_mf[src]
        v_inj = v_mf[src]
    out_tgt = sdpa(split_heads(q[tgt], heads), split_heads(k_inj, heads),
                   split_heads(v_inj, heads), scale)
    out = torch.stack([out_src[0], out_tgt[0], out_src[1], out_tgt[1]], dim=0)
    return linear(p.to_out[0], merge_heads(out))


def injected_temporal_kv(x: torch.Tensor) -> torch.Tensor:
    """Every branch row reads the reconstruction row of its CFG half."""
    return x[list(TGT_TO_SRC)]
