"""CLIP image tower (ViT-L/14) of the edit-quality metrics, the CLIP score
and the frame consistency (port of motioneditor_tpu/models/clip_image.py).

``CLIPVisionModel`` holds the parameters under the key names of a Hugging
Face ``CLIPVisionModelWithProjection`` checkpoint (``vision_model.*`` and
``visual_projection.weight``, which a whole openai CLIP checkpoint also
has); ``port_clip_image`` reads one. ``preprocess_clip`` resizes frames to
224 with the weights of ``jax.image.resize``'s bilinear filter (widened,
antialiased, when it downsamples) and normalizes them; ``clip_image_embed``
returns the projected embeddings.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from motioneditor_tpu_torch.models.clip_text import CLIPLayer, clip_encoder
from motioneditor_tpu_torch.models.layers import init_params, layer_norm, linear

# openai CLIP normalization
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPImageConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class CLIPVisionModel(nn.Module):
    def __init__(self, config: CLIPImageConfig = CLIPImageConfig()):
        super().__init__()
        c = self.config = config
        vm = self.vision_model = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(torch.empty(c.hidden_size))
        vm.embeddings.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size,
                                                  stride=c.patch_size, bias=False)
        vm.embeddings.position_embedding = nn.Embedding(c.num_patches + 1, c.hidden_size)
        vm.embeddings.position_embedding.init_std = 0.01  # as JAX's init_clip_image
        vm.embeddings.register_buffer("position_ids", torch.arange(c.num_patches + 1)[None])
        vm.pre_layrnorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)  # the HF key name
        vm.encoder = nn.Module()
        vm.encoder.layers = nn.ModuleList([CLIPLayer(c) for _ in range(c.num_layers)])
        vm.post_layernorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.visual_projection = nn.Linear(c.hidden_size, c.projection_dim, bias=False)


@torch.no_grad()
def init_clip_image(model: CLIPVisionModel, generator: torch.Generator) -> CLIPVisionModel:
    """Random init: ``layers.init_params`` and the class embedding normal
    with std 0.02, as JAX's init_clip_image."""
    init_params(model, generator)
    model.vision_model.embeddings.class_embedding.normal_(0.0, 0.02, generator=generator)
    return model


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """[in_size, out_size] fp32 weights of a bilinear resize with half-pixel
    centers, whose triangle filter is widened by the scale when it
    downsamples (antialiasing): the weights ``jax.image.resize(...,
    "bilinear")`` computes, in its order of operations. (F.interpolate's
    antialias=True differs from them by up to 1.4e-5 of the pixel range at a
    300 -> 224 scale.)"""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    pos = torch.arange(in_size, dtype=torch.float32, device=device)
    w = torch.clamp(1.0 - (sample[None, :] - pos[:, None]).abs() / kernel_scale, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def preprocess_clip(video: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[..., H, W, 3] in [0, 1] -> CLIP-normalized [..., size, size, 3]:
    the antialiased bilinear resize of ``resize_weights``, in fp32."""
    h, w = video.shape[-3:-1]
    x = video.float()
    if (h, w) != (size, size):
        x = torch.einsum("...hwc,hp,wq->...pqc", x, resize_weights(h, size, x.device),
                         resize_weights(w, size, x.device))
    mean = torch.as_tensor(CLIP_MEAN, device=x.device)
    std = torch.as_tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def clip_image_embed(model: CLIPVisionModel, pixels: torch.Tensor) -> torch.Tensor:
    """pixels: [B, 224, 224, 3] normalized -> projected embeddings [B, 768],
    in the model's dtype (the model's config)."""
    c, vm = model.config, model.vision_model
    emb = vm.embeddings
    dtype = emb.patch_embedding.weight.dtype
    patches = emb.patch_embedding(pixels.to(dtype).permute(0, 3, 1, 2))  # [B, D, g, g]
    tokens = patches.flatten(2).transpose(1, 2)  # [B, g*g, D]
    cls = emb.class_embedding.to(dtype).expand(tokens.shape[0], 1, -1)
    x = torch.cat([cls, tokens], dim=1) + emb.position_embedding.weight.to(dtype)
    x = layer_norm(vm.pre_layrnorm, x, eps=c.layer_norm_eps)
    x = clip_encoder(vm.encoder.layers, x, c.num_heads, c.layer_norm_eps)
    pooled = layer_norm(vm.post_layernorm, x[:, 0], eps=c.layer_norm_eps)
    return linear(model.visual_projection, pooled)


def port_clip_image(sd, config: CLIPImageConfig = CLIPImageConfig()) -> CLIPVisionModel:
    """A ``CLIPVisionModel`` from a Hugging Face CLIP state dict (a
    ``CLIPVisionModelWithProjection`` or a whole CLIP checkpoint, whose text
    keys it ignores; ``pre_layrnorm`` or ``pre_layernorm``). The widths,
    depth and patch grid come from the shapes; ``config`` gives what they
    cannot: the head count and the LayerNorm eps."""
    keys = {}
    for k, v in sd.items():
        if k.startswith("vision_model.") or k == "visual_projection.weight":
            keys[k.replace("vision_model.pre_layernorm.", "vision_model.pre_layrnorm.")] = v
    layers = sum(1 for k in keys if k.endswith(".self_attn.q_proj.weight"))
    proj = keys["visual_projection.weight"]
    patch = keys["vision_model.embeddings.patch_embedding.weight"]
    n_pos = keys["vision_model.embeddings.position_embedding.weight"].shape[0]
    config = dataclasses.replace(
        config, hidden_size=proj.shape[1], projection_dim=proj.shape[0], num_layers=layers,
        patch_size=patch.shape[-1], image_size=int(round((n_pos - 1) ** 0.5)) * patch.shape[-1],
        intermediate_size=keys["vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0])
    model = CLIPVisionModel(config)
    keys.setdefault("vision_model.embeddings.position_ids",
                    model.vision_model.embeddings.position_ids)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in keys.items()})
    return model.eval()
