"""Device ms per traced step of the program's ``me.controlnet`` span, between
CUDA events at its entry and exit: the ControlNet's forward."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "me.controlnet")
