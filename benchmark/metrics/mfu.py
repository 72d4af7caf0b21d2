"""The model flops of the measured window's steps, counted once per step
kind by FlopCounterMode over the reference on the meta device, per second
of the window, as a share of the card's bf16 peak."""


def read(run):
    if not run.peaks:
        return None
    flops = sum(run.phase.work(kind)["flops"] * n for kind, n in run.kinds.items())
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops"]
