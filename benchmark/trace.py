"""The traced window: device and host intervals from torch.profiler, and the
arithmetic the per-layer readers share (a copy of the program's
``union_seconds`` and ``PROFILE_BUCKETS`` rules, kept here so that the
yardstick does not move with the program).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Tuple

import numpy as np

SPAN_PREFIX = "bench."  # the benchmark's own spans around its calls into the program
WINDOW_SPAN = SPAN_PREFIX + "traced_window"

# device-time buckets: the first whose substrings the kernel's name
# contains (lower case)
BUCKETS = (
    ("attention_tc_lse", ("attention_tc_lse",)),
    ("attention_tc_dq", ("attention_tc_dq",)),
    ("attention_tc_dkv", ("attention_tc_dkv",)),
    ("temporal_bwd", ("temporal_bwd",)),
    ("attention_tc_inj", ("attention_tc_inj",)),
    ("attention_tc", ("attention_tc",)),
    ("video_attention", ("video_attention_kernel",)),
    ("temporal_attention", ("temporal_attention",)),
    ("split_attention", ("split_attention",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "matmul")),
    ("conv", ("conv", "cudnn", "implicit", "nchw", "nhwc")),
    ("copy", ("copy", "cat", "index", "gather", "scatter")),
    ("pair_stats", ("pair_stats",)),
    ("add_layer_norm", ("add_layer_norm",)),
    ("norm", ("norm", "welford", "reduce")),
    ("softmax", ("softmax",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)

# kernels that compute attention, whoever wrote them: the program's and
# PyTorch's SDPA backends (flash, memory-efficient, cuDNN)
ATTENTION_NAMES = ("attention", "temporal_bwd", "dq_kernel", "dkv_kernel", "combine_partials",
                   "flash_fwd", "flash_bwd", "fmha", "sdpa", "mha_", "_mha")

# the backward's attention kernels (the program's dq / dkv and temporal
# backward, SDPA's flash, memory-efficient and cuDNN backward); every other
# attention kernel runs a forward
BACKWARD_NAMES = ("bwd", "backward", "bprop", "_dq", "dkv", "cutlassb", "combine_partials")

# host calls that only launch or wait: an idle gap is labelled by the
# innermost host operation around them
RUNTIME_PREFIXES = ("cuda", "cu", "Memcpy", "Memset")


def bucket(name: str) -> str:
    low = name.lower()
    return next((b for b, keys in BUCKETS if any(k in low for k in keys)), "other")


def is_attention(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in ATTENTION_NAMES)


def is_backward(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in BACKWARD_NAMES)


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals given in microseconds."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e6


def idle_gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] (microseconds) that no interval covers."""
    gaps, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]


@dataclasses.dataclass
class Trace:
    """Device operations (name, start, end) and host operations (name,
    start, end), microseconds on one clock, of the traced window [lo, hi]."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    lo: float
    hi: float

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_s(self) -> float:
        return union_seconds([(max(s, self.lo), min(e, self.hi)) for _, s, e in self.device
                              if e > self.lo and s < self.hi])

    def seconds_where(self, pred) -> float:
        return sum(e - s for n, s, e in self.device if pred(n)) / 1e6

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = 10, longest: int = 400) -> List[list]:
        """Idle seconds by the innermost host operation in flight at each
        gap's middle, over the ``longest`` gaps; the ``k`` largest labels."""
        gaps = idle_gaps([(s, e) for _, s, e in self.device], self.lo, self.hi)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
        ops = [h for h in self.host if not h[0].startswith(RUNTIME_PREFIXES)]
        if not ops:
            return []
        starts = np.array([s for _, s, _ in ops])
        ends = np.array([e for _, _, e in ops])
        by: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = ops[inside[np.argmax(starts[inside])]][0] if len(inside) else "(none)"
            by[label] = by.get(label, 0.0) + (b - a) / 1e6
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


@contextlib.contextmanager
def traced(sync):
    """torch.profiler over the block, CPU and CUDA; the block runs inside
    the span ``WINDOW_SPAN`` and ends in ``sync()``. Yields a list that
    receives the ``Trace``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    out: list = []
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield out
            sync()
    device, host, lo, hi = [], [], None, None
    for e in prof.events():
        r = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN_PREFIX):  # the spans' device-side copies
                device.append(r)
        elif e.name == WINDOW_SPAN:
            lo, hi = r[1], r[2]
        else:
            host.append(r)
    if lo is None:
        raise RuntimeError("the profiler returned no window span")
    out.append(Trace(device, host, lo, hi))
