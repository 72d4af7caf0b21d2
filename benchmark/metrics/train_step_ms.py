"""The measured window's wall time over the optimizer steps it completed."""


def read(run):
    return 1e3 * run.window_s / run.steps
