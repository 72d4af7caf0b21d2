"""Device ms per traced step of the program's ``me.optimizer`` span (the
global-norm clip and AdamW's step), between CUDA events at its entry and
exit."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "me.optimizer")
