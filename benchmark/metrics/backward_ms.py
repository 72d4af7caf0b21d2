"""Device ms per traced step of the program's ``me.backward`` span (the
training step's ``.backward()``, the checkpoint's recompute in it), between
CUDA events at its entry and exit."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "me.backward")
