"""Device ms per traced step of the program's ``me.adapter`` span, between
CUDA events at its entry and exit: the motion adapter's 12 blocks, inside
the UNet's forward."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "me.adapter")
