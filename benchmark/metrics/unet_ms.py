"""Device ms per traced step of the program's ``me.unet`` span, between CUDA
events at its entry and exit: the UNet's forward, the adapter inside it
(training: the forward alone; the recompute runs in ``me.backward``)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "me.unet")
