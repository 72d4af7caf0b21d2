"""Checkpoint readers: the pretrained stacks the reference runs on, loaded
into this package's modules (port of motioneditor_tpu/models/weights.py).

- ``load_state_dict`` reads a torch ``.bin`` / ``.pth`` or a
  ``.safetensors`` file; the latter through ``read_safetensors``, this
  package's own reader, so no ``safetensors`` package is needed.
- ``load_sd15_unet``, ``load_sd15_vae``, ``load_sd15_text_encoder``:
  the ``unet`` / ``vae`` / ``text_encoder`` subfolders of a diffusers
  SD-1.5 directory; ``load_sdxl_unet``: the ``unet`` subfolder of a
  diffusers SDXL directory (Linear ``proj_in`` / ``proj_out``,
  ``add_embedding``), into the video UNet without the adapter;
  ``load_controlnet``: a diffusers ControlNet directory
  (sd-controlnet-openpose); ``load_adapter_checkpoint``: the stand-alone
  adapter ``.pth`` of the reference's train_adaptor.py:397-399.

The modules already hold diffusers key names, so each loader is
``load_into`` plus the key fix-ups the JAX ``port_*`` functions make.
Every load is strict: a key the module lacks, or a shape that differs,
raises and names the key. A key of the module that the file lacks raises
too, except for the modules SD-1.5 does not have (the temporal inflation
``temp_conv1/2``, ``attn_temp`` / ``norm_temp`` and the
``controlnet_adapter``), which keep the module's init when the file holds
none of their keys: zero-init temporal outputs keep a fresh video UNet
equal to per-frame SD-1.5 (weights.py:9-12).
"""

from __future__ import annotations

import json
import mmap
import os.path as osp
import re
import struct
from typing import Callable, Dict, Optional

import torch
from torch import nn

_MODEL_FILES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
    "model.safetensors",
    "pytorch_model.bin",
)
# the weights' dtypes, and I64 for the position_ids buffer some text encoders carry
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                       "I64": torch.int64}
# the video UNet's modules that a 2D SD-1.5 checkpoint does not hold
_VIDEO_ONLY = re.compile(
    r"^(controlnet_adapter|.*?\.(?:temp_conv1|temp_conv2|attn_temp|norm_temp))\.")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors: an 8-byte little-endian header
    length, a JSON header of ``dtype`` / ``shape`` / ``data_offsets`` per
    tensor (offsets into the buffer after the header), then the buffer. The
    tensors share a copy-on-write map of the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which this "
                             "reader does not know")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        if count != (torch.Size(shape).numel()):
            raise ValueError(f"{path}: tensor {name} holds {end - start} bytes for shape {shape}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=8 + n + start).reshape(shape)
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a ``.safetensors`` file (``read_safetensors``) or a
    torch ``.bin`` / ``.pth`` (``torch.load`` with ``weights_only``), on the
    CPU in the file's dtypes; an object with ``state_dict()`` is unwrapped
    (JAX weights.py:25-36)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd)


def find_model_file(model_dir: str) -> str:
    """The weights file of a diffusers / transformers model directory, in
    JAX's order (weights.py:39-49)."""
    for name in _MODEL_FILES:
        p = osp.join(model_dir, name)
        if osp.isfile(p):
            return p
    raise FileNotFoundError(f"no model weights ({', '.join(_MODEL_FILES)}) in {model_dir}")


def load_into(module: nn.Module, sd: Dict[str, torch.Tensor], source: str,
              optional: Optional[Callable[[str], Optional[str]]] = None) -> nn.Module:
    """Copy ``sd`` into ``module``'s parameters and buffers (cast to their
    dtype and device). Raises on a key the module lacks, a shape that
    differs, or a key of the module that ``sd`` lacks; ``optional(key)``
    names the module group a missing key may belong to (None: not
    optional), and a group may be missing only as a whole."""
    own = module.state_dict()
    unexpected = sorted(k for k in sd if k not in own)
    if unexpected:
        raise KeyError(f"{source}: {len(unexpected)} keys the model does not have, "
                       f"first {unexpected[:3]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{source}: {k} has shape {tuple(v.shape)} in the file and "
                             f"{tuple(own[k].shape)} in the model")
    missing = [k for k in own if k not in sd]
    present = {optional(k) for k in sd} if optional else set()
    bad = [k for k in missing if optional is None or optional(k) is None
           or optional(k) in present]
    if bad:
        raise KeyError(f"{source}: {len(bad)} keys of the model missing from the file, "
                       f"first {bad[:3]}")
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(v)
    return module


def _attention_out(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``to_out.weight`` -> ``to_out.0.weight`` (JAX ``_attn``, weights.py:79)."""
    return {re.sub(r"\.to_out\.(weight|bias)$", r".to_out.0.\1", k): v for k, v in sd.items()}


def _video_group(key: str) -> Optional[str]:
    m = _VIDEO_ONLY.match(key)
    return m.group(1) if m else None


def load_sd15_unet(pretrained_model_path: str, config=None,
                   generator: Optional[torch.Generator] = None, device="cuda") -> nn.Module:
    """The video UNet of ``config`` (SD-1.5's by default) on ``device``,
    fp32: initialized from ``generator`` (seed 0 without one), then filled
    from ``<path>/unet``. The temporal modules and the adapter keep their
    init where the file has none of their keys; a file with
    ``controlnet_adapter.*`` fills the adapter (JAX weights.py:369-379,
    :205-209)."""
    from motioneditor_tpu_torch.inference import resolve_device
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig

    device = resolve_device(device)  # before any file is read

    path = find_model_file(osp.join(pretrained_model_path, "unet"))
    with torch.device(device):
        unet = UNet3DConditionModel(config or UNetConfig())
    init_params(unet, generator or torch.Generator(device=device).manual_seed(0))
    return load_into(unet, _attention_out(load_state_dict(path)), path, _video_group)


def load_sdxl_unet(pretrained_model_path: str, config=None,
                   generator: Optional[torch.Generator] = None, device="cuda") -> nn.Module:
    """SDXL's UNet inflated to video (``config``: ``unet.SDXL_BASE`` by
    default, a text_time configuration), without the motion adapter, on
    ``device``, fp32: initialized from ``generator`` (seed 0 without one),
    then filled from ``<path>/unet``. The temporal modules keep their init
    where the file has none of their keys, as in ``load_sd15_unet``."""
    from motioneditor_tpu_torch.inference import resolve_device
    from motioneditor_tpu_torch.models.layers import init_params
    from motioneditor_tpu_torch.models.unet import SDXL_BASE, UNet3DConditionModel

    device = resolve_device(device)  # before any file is read

    path = find_model_file(osp.join(pretrained_model_path, "unet"))
    with torch.device(device):
        unet = UNet3DConditionModel(config or SDXL_BASE, include_adapter=False)
    init_params(unet, generator or torch.Generator(device=device).manual_seed(0))
    return load_into(unet, _attention_out(load_state_dict(path)), path, _video_group)


_VAE_ATTN = re.compile(r"^((?:en|de)coder\.mid_block\.attentions\.0)\.(.+)\.(weight|bias)$")
_VAE_NAMES = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn",
              "norm": "group_norm"}


def vae_key_fixups(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """diffusers' two VAE attention namings onto the module's legacy ones:
    ``to_q / to_k / to_v / to_out.0`` -> ``query / key / value /
    proj_attn``, ``norm`` -> ``group_norm``, and 1x1-conv projection weights
    [C, C, 1, 1] squeezed to [C, C] (JAX weights.py:261-281)."""
    out = {}
    for k, v in sd.items():
        m = _VAE_ATTN.match(k)
        if m:
            name = _VAE_NAMES.get(m.group(2), m.group(2))
            k = f"{m.group(1)}.{name}.{m.group(3)}"
            if name != "group_norm" and v.ndim == 4 and v.shape[2:] == (1, 1):
                v = v[:, :, 0, 0]
        out[k] = v
    return out


def load_sd15_vae(pretrained_model_path: str, config=None, device="cuda") -> nn.Module:
    """The VAE of ``config`` from ``<path>/vae`` on ``device``, fp32."""
    from motioneditor_tpu_torch.inference import resolve_device
    from motioneditor_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    device = resolve_device(device)  # before any file is read

    path = find_model_file(osp.join(pretrained_model_path, "vae"))
    with torch.device(device):
        vae = AutoencoderKL(config or VAEConfig())
    return load_into(vae, vae_key_fixups(load_state_dict(path)), path)


def text_key_fixups(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A CLIP text state dict with or without the ``text_model.`` prefix,
    onto the prefixed names, without the ``embeddings.position_ids`` buffer
    some files carry (JAX weights.py:337-366)."""
    out = {}
    for k, v in sd.items():
        if k != "text_projection.weight" and not k.startswith("text_model."):
            k = "text_model." + k
        if k != "text_model.embeddings.position_ids":
            out[k] = v
    return out


def load_sd15_text_encoder(pretrained_model_path: str, config=None, device="cuda") -> nn.Module:
    """The CLIP text encoder from ``<path>/text_encoder`` on ``device``, fp32,
    with ``text_projection`` when the file has one; its widths, depth and
    vocabulary come from the file, the heads and the LayerNorm eps from
    ``config`` (``load_clip_text``)."""
    from motioneditor_tpu_torch.inference import resolve_device
    from motioneditor_tpu_torch.models.clip_text import CLIPTextConfig, load_clip_text

    device = resolve_device(device)  # before any file is read

    path = find_model_file(osp.join(pretrained_model_path, "text_encoder"))
    model = load_clip_text(text_key_fixups(load_state_dict(path)), config or CLIPTextConfig())
    return model.to(device)


def load_controlnet(controlnet_path: str, config=None, device="cuda") -> nn.Module:
    """The ControlNet of ``config`` (sd-controlnet-openpose's by default)
    from the directory ``controlnet_path`` on ``device``, fp32. A diffusers
    ControlNet has no ``conv_norm_out``, ``conv_out`` or ``up_blocks``, and
    neither has the module (JAX weights.py:236-258)."""
    from motioneditor_tpu_torch.inference import resolve_device
    from motioneditor_tpu_torch.models.controlnet import ControlNetModel, controlnet_config

    device = resolve_device(device)  # before any file is read

    path = find_model_file(controlnet_path)
    with torch.device(device):
        cn = ControlNetModel(config or controlnet_config())
    return load_into(cn, _attention_out(load_state_dict(path)), path)


def load_adapter_checkpoint(path: str, adapter: nn.Module) -> nn.Module:
    """Fill ``adapter`` (a ``ControlAdapter``) from the reference's
    stand-alone adapter ``.pth`` (keys ``body.N.*``; JAX weights.py:212-233,
    :399-401)."""
    return load_into(adapter, _attention_out(load_state_dict(path)), path)
