"""Device operations (kernels, copies, sets) per step in the traced window:
the host's dispatch work, as a count."""


def read(run):
    steps = sum(run.traced_kinds.values())
    if run.trace is None or not steps:
        return None
    return len(run.trace.device) / steps
