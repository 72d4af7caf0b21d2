"""MotionEditor on PyTorch + CUDA (NVIDIA Hopper).

The PyTorch port of ``motioneditor_tpu``: the same video-editing math, with
the Pallas TPU kernels of the injected two-branch denoise step rewritten as
hand-written CUDA C++ kernels for ``sm_90a`` (``csrc/``), built from source
at first use (``_build.py``).

Layout mirrors the JAX package so every counterpart sits at the same path:

  schedulers.py         <- motioneditor_tpu/schedulers.py
  models/layers.py      <- motioneditor_tpu/models/layers.py
  models/unet.py        <- motioneditor_tpu/models/unet.py
  models/adapter.py     <- motioneditor_tpu/models/adapter.py
  models/controlnet.py  <- motioneditor_tpu/models/controlnet.py
  models/from_jax.py    JAX parameter trees -> this package's state_dicts
  ops/attention.py      <- motioneditor_tpu/ops/attention.py
  ops/video_flash.py    <- motioneditor_tpu/ops/video_flash.py (CUDA kernels)
  ops/temporal_flash.py <- motioneditor_tpu/ops/temporal_flash.py (CUDA kernel)
  control/injection.py  <- motioneditor_tpu/control/injection.py
  pipelines/editor.py   <- motioneditor_tpu/pipelines/editor.py (denoise segment)

Public functions keep the JAX layouts: videos are [B, F, H, W, C] and
tokens [B, F, N, C]. This package never imports ``jax``; nothing here needs
``nvcc`` or a GPU until a kernel is launched on a CUDA tensor.
"""

__version__ = "0.1.0"
