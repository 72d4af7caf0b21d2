"""Prompt-to-prompt attention control as probability editors (port of
motioneditor_tpu/control/p2p.py).

A controller is a static spec; ``P2PController.prob_editor(step)`` returns
the function ``(probs, is_cross) -> probs`` that the UNet's attention sites
apply to their softmax probabilities [4, F, H, Q, KV] (rows [recon_u,
edit_u, recon_c, edit_c]): the conditional edit row (3) is blended toward
the conditional source row (2) through the word mapper (cross-attention) or
replaced by it (self-attention at Q <= 256, early steps). ``LocalBlend``
keeps the source latents outside the region where chosen words attend, read
from the running sum of the 16x16 cross-attention maps.

The editors work on fp32 probabilities (``ops.attention.attention_probs``)
and the callers cast to the value dtype afterwards. They are frame and head
local: a frame-sharded run applies them to its own frames unchanged, and a
model rank to its own heads; LocalBlend reads the full width's maps
(``ops.attention.head_mean``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from motioneditor_tpu_torch.control.seq_aligner import (
    get_refinement_mapper,
    get_replacement_mapper,
    get_word_inds,
)


def get_time_words_attention_alpha(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: Union[float, Dict[str, Tuple[float, float]]],
    tokenizer,
    max_num_words: int = 77,
) -> np.ndarray:
    """Per-(step, word) replacement gate [T + 1, n_edit, 1, 1, 77]: 1 inside
    the word's window of the schedule, 0 outside. ``cross_replace_steps`` is
    a float (the window [0, x)), or a dict of per-word windows with the
    window of the other words under ``default_``."""

    def update_alpha(alpha, bounds, prompt_ind, word_inds=None):
        if isinstance(bounds, float):
            bounds = (0.0, bounds)
        start, end = int(bounds[0] * num_steps), int(bounds[1] * num_steps)
        if word_inds is None:
            word_inds = np.arange(alpha.shape[2])
        alpha[:start, prompt_ind, word_inds] = 0
        alpha[start:end, prompt_ind, word_inds] = 1
        alpha[end:, prompt_ind, word_inds] = 0
        return alpha

    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)
    alpha_time_words = np.zeros((num_steps + 1, len(prompts) - 1, max_num_words))
    for i in range(len(prompts) - 1):
        alpha_time_words = update_alpha(alpha_time_words, cross_replace_steps["default_"], i)
    for key, item in cross_replace_steps.items():
        if key != "default_":
            inds = [get_word_inds(prompts[i], key, tokenizer) for i in range(1, len(prompts))]
            for i, ind in enumerate(inds):
                if len(ind) > 0:
                    alpha_time_words = update_alpha(alpha_time_words, item, i, ind)
    return alpha_time_words.reshape(
        num_steps + 1, len(prompts) - 1, 1, 1, max_num_words).astype(np.float32)


class _DeviceArrays:
    """A spec's numpy arrays as tensors, copied to each (device, dtype) once:
    a copy from host memory waits for the device's queue to drain, which at
    every attention site of every step would stall the host-bound step."""

    def __init__(self):
        self._tensors = {}

    def get(self, name: str, a: np.ndarray, like: torch.Tensor, dtype=None) -> torch.Tensor:
        dtype = dtype or like.dtype
        key = (name, like.device, dtype)
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(a, dtype=dtype, device=like.device)
        return self._tensors[key]


@dataclasses.dataclass(frozen=True, eq=False)
class P2PController:
    """Static p2p spec. kind: "replace" | "refine" | "reweight".

    ``mapper`` / ``refine_alphas`` come from seq_aligner (replace: [n, 77,
    77]; refine: [n, 77] each); ``cross_alpha`` is the per-step word gate
    [T + 1, n, 1, 1, 77]; ``self_replace_until`` the step bound of the
    self-attention map replacement; ``equalizer`` [n, 77] the reweight
    factors."""

    kind: str
    num_steps: int
    cross_alpha: np.ndarray
    self_replace_until: int
    mapper: Optional[np.ndarray] = None
    refine_alphas: Optional[np.ndarray] = None
    equalizer: Optional[np.ndarray] = None
    _on_device: _DeviceArrays = dataclasses.field(default_factory=_DeviceArrays, init=False,
                                                  repr=False)

    def replace_cross_attention(self, attn_base: torch.Tensor, attn_edit: torch.Tensor,
                                edit_idx: int = 0) -> torch.Tensor:
        """attn_*: [..., Q, 77] probabilities."""
        on = self._on_device.get
        if self.kind == "replace":
            return torch.matmul(attn_base, on("mapper", self.mapper, attn_base)[edit_idx])
        if self.kind == "refine":
            index = on("index", np.maximum(self.mapper, 0), attn_base, torch.int64)[edit_idx]
            alphas = on("refine_alphas", self.refine_alphas, attn_base)[edit_idx]
            return attn_base.index_select(-1, index) * alphas + attn_edit * (1 - alphas)
        if self.kind == "reweight":
            # reweight scales the base branch's map, not the edit branch's
            return attn_base * on("equalizer", self.equalizer, attn_base)[edit_idx]
        raise ValueError(self.kind)

    def edit_cross_probs(self, probs_base, probs_edit, step: int, edit_idx: int = 0):
        """The word-gated blend of one step toward the mapped base maps."""
        alpha = self._on_device.get("cross_alpha", self.cross_alpha, probs_base)[step, edit_idx]
        replaced = self.replace_cross_attention(probs_base, probs_edit, edit_idx)
        return alpha * replaced + (1 - alpha) * probs_edit

    def edit_self_probs(self, probs_base, probs_edit, step: int):
        """Self-attention map replacement while step < self_replace_until."""
        if step < self.self_replace_until:
            return probs_base.expand(probs_edit.shape)
        return probs_edit

    def prob_editor(self, step: int, edit_idx: int = 0):
        """The (probs, is_cross) -> probs editor of denoise step ``step`` (a
        Python int). probs: [4, F, H, Q, KV], rows [recon_u, edit_u, recon_c,
        edit_c]; only the conditional half is edited, base row 2 and edit
        row 3. Self-attention maps are replaced only at Q <= 16^2 and only
        inside [0, self_replace_until)."""

        def editor(probs: torch.Tensor, is_cross: bool) -> torch.Tensor:
            if probs.shape[0] != 4:
                raise ValueError(f"p2p editing needs the 4 branch rows, got {probs.shape[0]}")
            base, edit = probs[2], probs[3]
            if is_cross:
                new_edit = self.edit_cross_probs(base, edit, step, edit_idx)
            elif probs.shape[-2] > 256:
                return probs
            else:
                new_edit = self.edit_self_probs(base, edit, step)
            return torch.stack([probs[0], probs[1], base, new_edit])

        return editor


@dataclasses.dataclass(frozen=True, eq=False)
class LocalBlend:
    """Word-localized latent blending: outside the thresholded map of the
    selected words the edited latents are replaced by the source branch's.

    ``alpha_layers``: [n_prompts, 77] one-hot word selection (built by
    ``make_local_blend``); ``threshold``: mask binarization."""

    alpha_layers: np.ndarray
    threshold: float = 0.3
    pool_k: int = 3
    _on_device: _DeviceArrays = dataclasses.field(default_factory=_DeviceArrays, init=False,
                                                  repr=False)

    def __call__(self, latents: torch.Tensor, cross_maps) -> torch.Tensor:
        """latents: [B, F, h, w, 4] (row 0 the source branch); cross_maps: a
        list of [(B F), 256, 77] 16x16 attention maps."""
        b, f, h, w, _ = latents.shape
        sel = self.selection(cross_maps, b, f, h, w)
        mask = (sel > self.threshold).to(latents.dtype)[..., None]
        mask = torch.maximum(mask, mask[:1])  # union with the source mask
        return latents[:1] + mask * (latents - latents[:1])

    def selection(self, cross_maps, b: int, f: int, h: int, w: int) -> torch.Tensor:
        """The max-normalized map [B, F, h, w] of the selected words that
        the blend thresholds."""
        maps = torch.stack(list(cross_maps), dim=1)  # [(B F), L, 256, 77]
        maps = maps.reshape(b, f, maps.shape[1], 16, 16, maps.shape[-1])
        alpha = self._on_device.get("alpha_layers", self.alpha_layers, maps)  # [B, 77]
        sel = (maps * alpha[:, None, None, None, None, :]).sum(-1).mean(dim=2)  # [B, F, 16, 16]
        # smooth (max pool, -inf padding), resize to the latents, max-normalize
        k = self.pool_k
        sel = F.max_pool2d(sel, k, stride=1, padding=k // 2)
        sel = F.interpolate(sel, size=(h, w), mode="bilinear", align_corners=False)
        return sel / sel.amax(dim=(2, 3), keepdim=True).clamp_min(1e-8)


def make_local_blend(prompts: Sequence[str], words: Sequence[Sequence[str]], tokenizer,
                     threshold: float = 0.3) -> LocalBlend:
    alpha = np.zeros((len(prompts), 77), np.float32)
    for i, (p, ws) in enumerate(zip(prompts, words)):
        if isinstance(ws, str):
            ws = [ws]
        for w in ws:
            alpha[i, get_word_inds(p, w, tokenizer)] = 1.0
    return LocalBlend(alpha_layers=alpha, threshold=threshold)


def make_controller(
    prompts: Sequence[str],
    tokenizer,
    num_steps: int,
    cross_replace_steps: Union[float, Dict] = 0.8,
    self_replace_steps: float = 0.4,
    equalizer_words: Optional[Sequence[str]] = None,
    equalizer_values: Optional[Sequence[float]] = None,
) -> P2PController:
    """Reweight when an equalizer is given, else replace when both prompts
    have as many words, else refine."""
    cross_alpha = get_time_words_attention_alpha(prompts, num_steps, cross_replace_steps,
                                                 tokenizer)
    self_until = int(num_steps * self_replace_steps)
    common = dict(num_steps=num_steps, cross_alpha=cross_alpha, self_replace_until=self_until)
    if equalizer_words is not None:
        eq = np.ones((1, 77), np.float32)
        for w, v in zip(equalizer_words, equalizer_values):
            eq[:, get_word_inds(prompts[1], w, tokenizer)] = v
        return P2PController(kind="reweight", equalizer=eq, **common)
    if len(prompts[0].split(" ")) == len(prompts[1].split(" ")):
        return P2PController(kind="replace", mapper=get_replacement_mapper(prompts, tokenizer),
                             **common)
    mapper, alphas = get_refinement_mapper(prompts, tokenizer)
    return P2PController(kind="refine", mapper=mapper, refine_alphas=alphas, **common)
