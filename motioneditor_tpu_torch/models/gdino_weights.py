"""The official GroundingDINO checkpoint into ``GroundingDINO`` (port of
motioneditor_tpu/models/gdino_weights.py).

The module already holds the checkpoint's names, packed attention
projections included, so the mapping only drops what the forward never
reads:

- ``relative_position_index``: Swin's index buffers, recomputed from the
  window;
- ``bert.pooler.*``: frozen at construction (groundingdino.py:109) and
  unused by the grounding forward, which reads the sequence output;
- ``bbox_embed.{1..5}`` and ``transformer.decoder.bbox_embed.{0..5}``:
  with dec_pred_bbox_embed_share=True every entry is the one MLP stored
  as ``bbox_embed.0``, so each copy must equal it.

Every other key must match the module's, by name and shape, both ways
(``weights.load_into``).
"""

from __future__ import annotations

import os.path as osp
import re
from typing import Dict

import torch

from motioneditor_tpu_torch.models.grounding_dino import (
    GDINO_SWINB,
    GDINO_SWINT,
    GroundingDINO,
    GroundingDINOConfig,
)

_BOX_ALIAS = re.compile(r"^(?:bbox_embed\.[1-9]\d*|transformer\.decoder\.bbox_embed\.\d+)\.(.+)$")


def _unused(key: str) -> bool:
    return key.endswith(".relative_position_index") or key.startswith("bert.pooler.")


def map_groundingdino_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict (under a top-level ``"model"`` or not,
    keys with or without ``module.``) -> the ``GroundingDINO`` state dict.
    Raises where a copy of the shared box head differs from ``bbox_embed.0``."""
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    out = {}
    for k, v in sd.items():
        if _unused(k):
            continue
        m = _BOX_ALIAS.match(k)
        if m:
            canonical = sd.get(f"bbox_embed.0.{m.group(1)}")
            if canonical is None or not torch.equal(canonical, v):
                raise ValueError(f"{k} is not a copy of bbox_embed.0.{m.group(1)}: the port "
                                 "reads one box head shared by every decoder layer")
            continue
        out[k] = v
    return out


def config_for(path: str) -> GroundingDINOConfig:
    """SwinB's config for a file named like ``groundingdino_swinb_*``, else SwinT's."""
    return GDINO_SWINB if "swinb" in osp.basename(path).lower() else GDINO_SWINT


def load_groundingdino_checkpoint(path: str, cfg: GroundingDINOConfig = None,
                                  device="cuda") -> GroundingDINO:
    """The official ``.pth`` (``groundingdino_swint_ogc.pth``) into a
    ``GroundingDINO`` of ``cfg`` (by default ``config_for(path)``) on
    ``device``, fp32, strictly. The file is read with ``torch.load(...,
    weights_only=True)`` (``weights.load_state_dict``)."""
    from motioneditor_tpu_torch.inference import resolve_device
    from motioneditor_tpu_torch.models.weights import load_into, load_state_dict

    device = resolve_device(device)  # before any file is read

    with torch.device(device):
        model = GroundingDINO(cfg or config_for(path))
    return load_into(model, map_groundingdino_state_dict(load_state_dict(path)), path).eval()


def released_state_dict(model: GroundingDINO) -> Dict[str, torch.Tensor]:
    """The module's state dict in the released file's layout: the box head
    under every name the shared module has there, Swin's index buffers,
    and a zero BERT pooler (which no forward reads); the inverse of
    ``map_groundingdino_state_dict``."""
    from motioneditor_tpu_torch.models.swin import _rel_position_index

    sd = dict(model.state_dict())
    c = model.config
    for k in [k for k in sd if k.startswith("bbox_embed.0.")]:
        rest = k[len("bbox_embed.0."):]
        for i in range(c.dec_layers):
            if i:
                sd[f"bbox_embed.{i}.{rest}"] = sd[k]
            sd[f"transformer.decoder.bbox_embed.{i}.{rest}"] = sd[k]
    index = torch.from_numpy(_rel_position_index(c.swin.window_size))
    for i, depth in enumerate(c.swin.depths):
        for j in range(depth):
            sd[f"backbone.0.layers.{i}.blocks.{j}.attn.relative_position_index"] = index
    h = c.bert.hidden
    sd["bert.pooler.dense.weight"] = torch.zeros(h, h)
    sd["bert.pooler.dense.bias"] = torch.zeros(h)
    return sd
