"""Tracing and profiling utilities (the port of
motioneditor_tpu/utils/profiling.py): torch.profiler in place of
jax.profiler, the same per-op-family summary, the per-step profile
chip_smoke.py prints (``profile_step`` over ``PROFILE_BUCKETS``), and the
program's spans (``span``).

Typical use:

    from motioneditor_tpu_torch.utils.profiling import trace, summarize_trace
    with trace("build/my_trace"):
        out = step(...)
    print(summarize_trace("build/my_trace"))

``trace`` synchronizes the card before it stops, so the trace holds every
kernel of the block; ``timeit`` synchronizes the output's device and reads
no value back to the host.

Spans mark the program's layers: the steps of the denoise loop, the
inversion and training (``STEP_SPANS``), training's ``me.forward``,
``me.backward`` and ``me.optimizer``, and the ``me.unet``,
``me.controlnet`` and ``me.adapter`` forwards.
Outside a torch profiler ``span`` is one flag check and a shared null
context. Inside one (``trace`` or any ``torch.profiler.profile``) a span
is a host-only range of the profiler's trace (function scope: the
profiler gives it no device-side copy), and ``span_records()`` returns
each span's record with its device time between two CUDA events:

    with trace("build/my_trace"):
        step(...)
    for r in span_records():
        print(r.name, r.parent, r.step, r.device_ms)
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import glob
import gzip
import json
import re
import threading
import time
from typing import List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# the chrome-trace categories of work on the card; a trace with none of
# them (a CPU run) has its operators summarized instead
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORY = "cpu_op"


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, CPU and (when present) CUDA
    activities; writes a ``*.pt.trace.json.gz`` chrome trace under
    ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir, use_gzip=True)):
        yield
        if cuda:
            torch.cuda.synchronize()


# the spans around one step of the denoise loop, the inversion and training;
# the spans inside one share its ordinal
STEP_SPANS = ("me.denoise_step", "me.invert_step", "me.train_step")

_NULL_SPAN = contextlib.nullcontext()


@dataclasses.dataclass
class SpanRecord:
    """One span entered under a profiler: its name, the name of the span it
    opened in (None at the top), the ordinal of its step span (shared by the
    step's spans; None outside a step), its host interval
    (``time.perf_counter_ns``) and, on the card, the device milliseconds
    between CUDA events recorded on the current stream at its entry and exit
    (``span_records`` resolves them)."""

    name: str
    parent: Optional[str]
    step: Optional[int]
    host_start_ns: int
    host_end_ns: int = 0
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)


class _SpanState(threading.local):
    def __init__(self):
        self.open: List[SpanRecord] = []


_records: List[SpanRecord] = []
_state = _SpanState()
_step = 0  # step spans entered since the last clear_span_records()


class _Span:
    """A profiled span: a function-scope ``_RecordFunctionFast`` range and a
    ``SpanRecord``."""

    __slots__ = ("name", "range", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _step
        open_ = _state.open
        parent = open_[-1] if open_ else None
        if self.name in STEP_SPANS:
            _step += 1
            step = _step
        else:
            step = parent.step if parent is not None else None
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        rec = SpanRecord(self.name, parent.name if parent is not None else None, step, 0)
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        rec.host_start_ns = time.perf_counter_ns()
        open_.append(rec)
        _records.append(rec)
        self.record = rec

    def __exit__(self, *exc):
        rec = self.record
        rec.host_end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        _state.open.pop()
        self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer of the program. Outside a torch
    profiler: a shared null context. Under one: a host-only range named
    ``name`` in the profiler's trace, and a ``SpanRecord``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _Span(name)


def spanned(name: str):
    """Decorates a function to run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def span_records() -> List[SpanRecord]:
    """The records of the spans entered under a profiler since the last
    ``clear_span_records()``, in order of entry, each closed span's device
    milliseconds resolved (waiting for its exit event)."""
    for rec in _records:
        if rec.events is not None and rec.device_ms is None and rec.host_end_ns:
            rec.events[1].synchronize()
            rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
    return list(_records)


def clear_span_records() -> None:
    """Forget the records and restart the step ordinals."""
    global _step
    _records.clear()
    _step = 0


def summarize_trace(log_dir: str, top: int = 20) -> str:
    """Aggregate device-op durations by op family (trailing digits and dots
    stripped from the name) over the chrome traces under ``log_dir``: the
    kernels and copies on the card, or the operators of a CPU run."""
    events = []
    for fpath in glob.glob(f"{log_dir}/**/*.trace.json.gz", recursive=True):
        with gzip.open(fpath, "rt") as fh:
            data = json.load(fh)
        events += [ev for ev in data.get("traceEvents", [])
                   if ev.get("ph") == "X" and "dur" in ev and "args" in ev]
    cats = set(DEVICE_CATEGORIES) if any(
        ev.get("cat") in DEVICE_CATEGORIES for ev in events) else {HOST_CATEGORY}
    fam = collections.Counter()
    for ev in events:
        name = ev.get("name", "?")
        if "cat" in ev and ev["cat"] not in cats or name.startswith(("$", "jit_", "Pjit")):
            continue
        fam[re.sub(r"[.\d]+$", "", name)] += ev["dur"]
    lines = [f"{'ms':>10}  op family"]
    for name, dur in fam.most_common(top):
        lines.append(f"{dur / 1e3:10.1f}  {name}")
    return "\n".join(lines)


def timeit(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then ``iters``
    timed ones; on the card the clock stops after the output's device has
    finished (a synchronize, no value read back)."""
    for _ in range(warmup):
        out = fn(*args)
    _sync(out if warmup else None)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    for x in out if isinstance(out, (list, tuple)) else ():
        t = _first_tensor(x)
        if t is not None:
            return t
    return None


def _sync(out):
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals given in microseconds."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e6


# device-time buckets of a profiled step: the first whose substrings the
# kernel's name contains (lower case)
K10_BUCKET = "K10 GroupNorm pair statistics (pair_stats)"
PROFILE_BUCKETS = (
    ("K4 forward with lse (attention_tc_lse)", ("attention_tc_lse",)),
    ("K5 dq (attention_tc_dq)", ("attention_tc_dq",)),
    ("K6 dk/dv (attention_tc_dkv)", ("attention_tc_dkv",)),
    ("K7 temporal backward (temporal_bwd)", ("temporal_bwd",)),
    ("K2/K13 injection (attention_tc_inj)", ("attention_tc_inj",)),
    ("tensor-core attention, K1/K8/K12 (attention_tc)", ("attention_tc",)),
    ("CUDA-core K1/K2/K4/K12/K13, fp32 (video_attention_kernel)", ("video_attention_kernel",)),
    ("K3/K14 temporal forward (temporal_attention_tma)", ("temporal_attention",)),
    ("K8/K9 CUDA-core body (split_attention_kernel)", ("split_attention",)),
    ("cuBLAS / CUTLASS matmuls", ("gemm", "xmma", "cutlass", "nvjet", "matmul")),
    ("cuDNN convs (+ layout kernels)", ("conv", "cudnn", "implicit", "nchw", "nhwc")),
    ("copies / cat / index", ("copy", "cat", "index", "gather", "scatter")),
    (K10_BUCKET, ("pair_stats",)),
    ("K11 add + LayerNorm (add_layer_norm)", ("add_layer_norm",)),
    ("norm and other reductions", ("norm", "welford", "reduce")),
    ("softmax", ("softmax",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
)


def profile_step(fn, top: int = 0) -> dict:
    """One call of ``fn`` (one step, ending in a synchronize) under
    torch.profiler on the card: wall ms, the device's busy share (the union
    of kernel intervals over the wall time), kernel time in ms and kernels
    per bucket; with ``top``, the ``top`` kernels by total time (ms,
    launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    buckets: dict = {}
    launches: dict = {}
    for e in kernels:
        name = e.name.lower()
        bucket = next((b for b, keys in PROFILE_BUCKETS if any(k in name for k in keys)),
                      "other")
        buckets[bucket] = buckets.get(bucket, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
        launches[bucket] = launches.get(bucket, 0) + 1
    busy = union_seconds([(e.time_range.start, e.time_range.end) for e in kernels]) / wall
    out = {"wall_ms": wall * 1e3, "busy_share": busy, "kernel_ms": sum(buckets.values()),
           "buckets_ms": dict(sorted(buckets.items(), key=lambda kv: -kv[1])),
           "launches": launches}
    if top:
        by_name: dict = {}
        for e in kernels:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
        out["top_kernels"] = {name[:80]: v for name, v in
                              sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]}
    return out
