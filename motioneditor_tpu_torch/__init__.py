"""MotionEditor on PyTorch + CUDA (NVIDIA Hopper).

The PyTorch port of ``motioneditor_tpu``: the same video-editing math, with
the Pallas TPU kernels of the edit and of training rewritten as hand-written CUDA C++
kernels for ``sm_90a`` (``csrc/``), built from source at first use
(``_build.py``).

Layout mirrors the JAX package so every counterpart sits at the same path:

  configs.py              <- motioneditor_tpu/configs.py (a copy)
  schedulers.py           <- motioneditor_tpu/schedulers.py
  inference.py            <- scripts/inference.py (an entry point)
  data/dataset.py         <- motioneditor_tpu/data/dataset.py (a copy, PIL path)
  utils/video.py          <- motioneditor_tpu/utils/video.py (a copy)
  models/layers.py        <- motioneditor_tpu/models/layers.py
  models/unet.py          <- motioneditor_tpu/models/unet.py
  models/adapter.py       <- motioneditor_tpu/models/adapter.py
  models/controlnet.py    <- motioneditor_tpu/models/controlnet.py
  models/vae.py           <- motioneditor_tpu/models/vae.py
  models/clip_text.py     <- motioneditor_tpu/models/clip_text.py
  models/from_jax.py      JAX parameter trees -> this package's state_dicts
  ops/attention.py        <- motioneditor_tpu/ops/attention.py
  ops/video_flash.py      <- motioneditor_tpu/ops/video_flash.py (CUDA kernels)
  ops/video_flash_bwd.py  <- motioneditor_tpu/ops/video_flash_bwd.py (CUDA kernels)
  ops/temporal_flash.py   <- motioneditor_tpu/ops/temporal_flash.py (CUDA kernels)
  ops/flash_attention.py  <- motioneditor_tpu/ops/flash_attention.py (CUDA kernel)
  ops/injection_flash.py  <- motioneditor_tpu/ops/injection_flash.py (CUDA kernel)
  ops/gn_stats.py         <- motioneditor_tpu/ops/gn_stats.py (CUDA kernel)
  ops/fused_norm.py       <- motioneditor_tpu/ops/fused_norm.py (CUDA kernel)
  control/injection.py    <- motioneditor_tpu/control/injection.py
  pipelines/editor.py     <- motioneditor_tpu/pipelines/editor.py
  training/common.py      <- motioneditor_tpu/training/common.py
  training/adam8bit.py    <- motioneditor_tpu/training/adam8bit.py
  training/stage1.py      <- motioneditor_tpu/training/stage1.py
  training/stage2.py      <- motioneditor_tpu/training/stage2.py
  training/checkpoint.py  <- motioneditor_tpu/training/checkpoint.py (torch.save)
  train_bg.py             <- scripts/train_bg.py (an entry point)
  train_adaptor.py        <- scripts/train_adaptor.py (an entry point)
  utils/runtime.py        <- motioneditor_tpu/utils/runtime.py (env_flag only)

Public functions keep the JAX layouts: videos are [B, F, H, W, C] and
tokens [B, F, N, C]. This package never imports ``jax`` or anything of
``motioneditor_tpu``: it keeps its own copies of the modules it needs.
Nothing here needs ``nvcc`` or a GPU until a kernel is launched on a CUDA
tensor; ``yaml``, PIL, ``imageio`` and ``transformers`` are imported only by
the functions that read configs, frames, videos and tokenizer files.
"""

__version__ = "0.1.0"
