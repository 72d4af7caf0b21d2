"""Host ms per traced step inside the program's step spans (a denoise,
inversion or training step), as the profiler's host events give them: the
host's dispatch of a step, an upper figure (the profiler slows the host)."""

from benchmark import spans


def read(run):
    return spans.host_ms(run, spans.STEP_SPANS)
