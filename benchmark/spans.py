"""The program's spans (``span`` in motioneditor_tpu_torch/utils/profiling.py)
as the per-layer readers take them: the device milliseconds of a span from
its records (two CUDA events on the stream), and its host intervals from the
traced window's host events (the profiler's clock, which the device trace
shares).

A program without spans gives neither records nor ``me.`` host events, and
every reader then reads nothing. The names are the yardstick's own copy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark import trace

STEP_SPANS = ("me.denoise_step", "me.invert_step", "me.train_step")


def records() -> list:
    """The program's span records of the traced window (the only profiled
    stretch of a run); none from a program without them."""
    try:
        from motioneditor_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "span_records", None)
    return read() if read is not None else []


def traced_steps(run) -> int:
    return sum(run.traced_kinds.values()) if run.trace is not None else 0


def device_ms(run, name: str) -> Optional[float]:
    """Device ms per traced step between the entry and exit of span ``name``."""
    steps = traced_steps(run)
    got = [r.device_ms for r in records() if r.name == name and r.device_ms is not None]
    if not steps or not got:
        return None
    return sum(got) / steps


def host_intervals(run, names) -> List[Tuple[float, float]]:
    """The disjoint union of the host intervals (us) of the spans ``names``
    inside the traced window."""
    lo, hi = run.trace.lo, run.trace.hi
    out: List[Tuple[float, float]] = []
    for _, s, e in sorted((h for h in run.trace.host if h[0] in names), key=lambda h: h[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def host_ms(run, names) -> Optional[float]:
    """Host ms per traced step inside the spans ``names``."""
    steps = traced_steps(run)
    spans = host_intervals(run, names) if steps else []
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / steps


def starved_ms(run, name: str) -> Optional[float]:
    """Ms per traced step of the device's idle gaps that fall inside the host
    intervals of span ``name``: the card waiting while the host runs it."""
    steps = traced_steps(run)
    spans = host_intervals(run, (name,)) if steps else []
    if not spans:
        return None
    gaps = trace.idle_gaps([(s, e) for _, s, e in run.trace.device], run.trace.lo, run.trace.hi)
    idle = sum(max(0.0, min(b, e) - max(a, s)) for a, b in gaps for s, e in spans)
    return idle / 1e3 / steps
