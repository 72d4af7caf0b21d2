"""The port's profiling utilities (utils/profiling.py): the op-family
summary against the JAX package's on the same synthetic traces, a trace of a
tiny CPU forward, ``timeit`` and ``union_seconds``."""

import gzip
import json
import os

import pytest
import torch

from motioneditor_tpu.utils.profiling import summarize_trace as jax_summarize_trace

from motioneditor_tpu_torch.utils.profiling import (
    summarize_trace,
    timeit,
    trace,
    union_seconds,
)


def write_trace(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)


def kernel(name, dur, **extra):
    return {"ph": "X", "name": name, "dur": dur, "args": {}, "cat": "kernel", **extra}


@pytest.mark.parametrize("top", [20, 2])
def test_summary_matches_jax(tmp_path, top):
    """Two files, one nested; families by trailing digits and dots; events
    that are not complete, carry no args or duration, or name a JAX program
    are left out by both."""
    write_trace(str(tmp_path / "a" / "host.pt.trace.json.gz"), [
        kernel("fusion.12", 1500.0), kernel("fusion.3", 250.5), kernel("convolution", 4000.0),
        kernel("attention_tc_kernel", 900.0), kernel("copy.1.2", 10.0),
        kernel("$main", 99.0), kernel("jit_step", 50.0), kernel("PjitFunction", 5.0),
        {"ph": "X", "name": "no_args", "dur": 7.0, "cat": "kernel"},
        {"ph": "i", "name": "instant", "dur": 7.0, "args": {}, "cat": "kernel"},
        {"ph": "X", "name": "no_dur", "args": {}, "cat": "kernel"},
    ])
    write_trace(str(tmp_path / "a" / "b" / "more.trace.json.gz"), [
        kernel("fusion.7", 100.0), kernel("temporal_attention_tma_kernel", 321.0),
    ])
    got = summarize_trace(str(tmp_path), top=top)
    assert got == jax_summarize_trace(str(tmp_path), top=top)
    lines = [line.split() for line in got.splitlines()[1:]]
    assert len(lines) == min(top, 5)
    assert lines[:2] == [["4.0", "convolution"], ["1.9", "fusion"]]


def test_summary_keeps_the_card_and_else_the_host(tmp_path):
    """A trace with kernels sums the kernels and copies (not the CPU
    operators that launched them); a CPU run's trace sums its operators."""
    write_trace(str(tmp_path / "gpu" / "x.pt.trace.json.gz"), [
        kernel("attention_tc_kernel", 2000.0),
        {"ph": "X", "name": "Memcpy HtoD", "dur": 300.0, "args": {}, "cat": "gpu_memcpy"},
        {"ph": "X", "name": "aten::mm", "dur": 5000.0, "args": {}, "cat": "cpu_op"},
        {"ph": "X", "name": "cudaLaunchKernel", "dur": 40.0, "args": {}, "cat": "cuda_runtime"},
    ])
    lines = summarize_trace(str(tmp_path / "gpu")).splitlines()
    assert [line.split(None, 1)[1] for line in lines[1:]] == ["attention_tc_kernel", "Memcpy HtoD"]
    write_trace(str(tmp_path / "cpu" / "x.pt.trace.json.gz"), [
        {"ph": "X", "name": "aten::mm", "dur": 5000.0, "args": {}, "cat": "cpu_op"},
        {"ph": "X", "name": "forward", "dur": 9000.0, "args": {}, "cat": "python_function"},
    ])
    lines = summarize_trace(str(tmp_path / "cpu")).splitlines()
    assert [line.split() for line in lines[1:]] == [["5.0", "aten::mm"]]


def test_trace_of_a_cpu_forward(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(), torch.nn.Linear(32, 4))
    x = torch.randn(8, 16)
    with trace(str(tmp_path)):
        with torch.no_grad():
            model(x)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json.gz")]
    assert len(files) == 1
    summary = summarize_trace(str(tmp_path))
    families = [line.split(None, 1)[1] for line in summary.splitlines()[1:]]
    assert "aten::linear" in families and "aten::gelu" in families


def test_timeit_returns_seconds_per_call():
    calls = []

    def fn(a, b):
        calls.append(1)
        return {"out": (a @ b, None)}

    a = torch.randn(64, 64)
    seconds = timeit(fn, a, a, iters=4, warmup=2)
    assert seconds > 0 and len(calls) == 6
    assert timeit(lambda: None, iters=2, warmup=0) >= 0


def test_union_seconds():
    assert union_seconds([]) == 0.0
    assert union_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)
    assert union_seconds([(5, 20), (0, 100)]) == pytest.approx(100e-6)
