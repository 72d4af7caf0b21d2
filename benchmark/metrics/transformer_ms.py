"""Device ms per traced step of the program's ``me.transformer`` spans
(each ``Transformer2D`` call in models/unet.py: its per-frame GroupNorm,
proj_in, transformer blocks and proj_out), between CUDA events at their
entry and exit, summed; under checkpointing the backward's recompute adds
its calls."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "me.transformer")
