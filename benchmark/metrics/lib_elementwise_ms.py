"""Device ms per step in PyTorch's elementwise, copy, cat and index kernels."""

from benchmark import trace

BUCKETS = ("elementwise", "copy")


def read(run):
    steps = sum(run.traced_kinds.values())
    if run.trace is None or not steps:
        return None
    return 1e3 * run.trace.seconds_where(lambda n: trace.bucket(n) in BUCKETS) / steps
