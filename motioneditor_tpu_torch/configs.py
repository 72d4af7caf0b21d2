"""YAML run configs (a copy of motioneditor_tpu/configs.py for the port).

The YAML keys of configs/case-N/*.yaml and configs/smoke/*.yaml map 1:1
onto the dataclass fields here, as in the JAX package. ``yaml`` is imported
inside ``load_config`` / ``save_config`` only, and ``compute_dtype`` maps
``mixed_precision`` to a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class InputDataConfig:
    """input_data subtree (train-bg.yaml:4-17) -> data/dataset.py kwargs."""

    video_dir: str = "data/case-1"
    prompt: str = ""
    n_sample_frames: int = 8
    width: int = 512
    height: int = 512
    sample_start_idx: int = 0
    sample_frame_rate: int = 1
    condition: Tuple[str, ...] = ("openposefull",)
    video_suffix: str = ".png"
    condition_suffix: str = ".png"
    source_mask_dir: Optional[str] = None
    random_sample: bool = False
    # accepted-but-unused reference keys
    noise_level: int = 0
    image_embed_drop: float = 0.0


@dataclasses.dataclass
class ValidationDataConfig:
    """validation_data subtree (eval-motion.yaml:20-37)."""

    prompts: Tuple[str, ...] = ()
    video_length: int = 8
    width: int = 512
    height: int = 512
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    num_inv_steps: int = 50
    use_null_inv: bool = True
    null_inner_steps: int = 1
    null_base_lr: float = 1e-2
    # inner-loop early stop (null_text_optimization.py:159-162 / invert():
    # break when loss < early_stop_epsilon + i * 2e-5)
    early_stop_epsilon: float = 1e-5
    null_uncond_ratio: float = -0.5
    null_normal_infer: bool = True
    controlnet_conditioning_scale: float = 1.0
    noise_level: int = 0
    # prompt-to-prompt editing (the prepare_control surface,
    # inference.py:74-99; dead-by-default in the reference too)
    use_p2p: bool = False
    p2p_cross_replace_steps: float = 0.8
    p2p_self_replace_steps: float = 0.4
    p2p_blend_words: Tuple[str, ...] = ()  # enables LocalBlend when non-empty
    p2p_blend_threshold: float = 0.3
    p2p_eq_words: Tuple[str, ...] = ()  # enables AttentionReweight
    p2p_eq_values: Tuple[float, ...] = ()


@dataclasses.dataclass
class RunConfig:
    """Top-level config: union of inference.py:102-119 and
    train_bg.py:83-110 / train_adaptor.py kwargs."""

    pretrained_model_path: str = "checkpoints/stable-diffusion-v1-5"
    controlnet_path: str = "checkpoints/sd-controlnet-openpose"
    output_dir: str = "outputs/run"
    input_data: InputDataConfig = dataclasses.field(default_factory=InputDataConfig)
    validation_data: ValidationDataConfig = dataclasses.field(
        default_factory=ValidationDataConfig
    )
    input_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    gradient_checkpointing: bool = True
    mixed_precision: str = "no"  # "no" | "bf16" (fp16 maps to bf16)
    seed: Optional[int] = 33
    use_sc_attn: bool = True
    use_st_attn: bool = False
    st_attn_idx: int = 0
    fps: int = 8
    resume_from_checkpoint: Optional[str] = None
    adapter_weight_path: Optional[str] = None
    one_stage_checkpoint: Optional[str] = None

    # training (train_bg.py:99-118)
    trainable_modules: Tuple[str, ...] = ("attn1.to_q", "attn2.to_q", "attn_temp")
    trainable_params: Tuple[str, ...] = ()
    train_batch_size: int = 1
    max_train_steps: int = 300
    learning_rate: float = 3e-5
    scale_lr: bool = False
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    checkpointing_steps: int = 300
    validation_steps: int = 300
    use_8bit_adam: bool = False  # blockwise 8-bit Adam state (training/adam8bit.py)
    enable_xformers_memory_efficient_attention: bool = True  # -> the flash kernels

    # accepted from the JAX package's configs; the port runs on one device
    mesh_shape: Tuple[int, ...] = (1, 1)  # (data, frames)
    use_flash_attention: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.mixed_precision in ("bf16", "fp16", "bfloat16"):
            return torch.bfloat16
        return torch.float32


def _coerce(cls, data: Dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    defaults = {
        f.name: (f.default if f.default is not dataclasses.MISSING else None)
        for f in dataclasses.fields(cls)
    }
    kwargs = {}
    for k, v in (data or {}).items():
        if k not in fields:
            continue  # tolerate unknown reference keys
        if isinstance(v, list):
            v = tuple(v)
        # PyYAML 1.1 parses "3e-5" (no dot) as a string — coerce numerics by
        # the dataclass default's type.
        d = defaults.get(k)
        if isinstance(v, str) and isinstance(d, float):
            v = float(v)
        elif isinstance(v, str) and isinstance(d, int) and not isinstance(d, bool):
            v = int(float(v))
        kwargs[k] = v
    return cls(**kwargs)


def load_config(path: str) -> RunConfig:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    raw = dict(raw or {})
    input_data = _coerce(InputDataConfig, raw.pop("input_data", {}))
    validation_data = _coerce(ValidationDataConfig, raw.pop("validation_data", {}))
    cfg = _coerce(RunConfig, raw)
    cfg.input_data = input_data
    cfg.validation_data = validation_data
    return cfg


def save_config(cfg: RunConfig, path: str) -> None:
    import yaml

    def enc(o):
        if dataclasses.is_dataclass(o):
            return {k: enc(v) for k, v in dataclasses.asdict(o).items()}
        if isinstance(o, tuple):
            return [enc(x) for x in o]
        if isinstance(o, dict):
            return {k: enc(v) for k, v in o.items()}
        return o

    with open(path, "w") as f:
        yaml.safe_dump(enc(cfg), f, sort_keys=False)
