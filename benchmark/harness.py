"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, the metrics, the result line.

Everything that belongs to one configuration, traffic mix, phase or metric
is found by name in files of its own:

  BENCHMARK.json                       the cells and metrics
  benchmark/configs/<config>.json      sizes, dtype, optimizer, weights' init
  benchmark/traffic/<traffic>.json     frames, resolution, schedule; its "phase"
  benchmark/phases/<phase>.py          ``Phase``: builds, drives and checks the program
  benchmark/limits/<workload>.json     the limit of each number the check compares
  benchmark/metrics/<metric>.py        ``read(run)``; a metric "a.b" without a
                                       file of its own takes "a.py"
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "motioneditor_tpu")
PEAKS = BENCH / "peaks.json"


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    """A workload with everything its name leads to."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, spec: Optional[dict] = None) -> Cell:
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    limits = BENCH / "limits" / f"{workload}.json"
    return Cell(
        name=workload, chips=w["chips"],
        config=load_json(ROOT / config["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=(load_json(limits)["limits"] if limits.is_file() else {}),
        end_to_end=[m for m in spec["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if reports(m, workload)])


def phase_class(cell: Cell):
    name = cell.traffic["phase"]
    return load_module(BENCH / "phases" / f"{name}.py", f"bench_phase_{name}").Phase


def reader(metric: str):
    for stem in (metric, metric.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.is_file():
            return load_module(path, f"bench_metric_{stem.replace('.', '_')}").read
    raise FileNotFoundError(f"no reader for metric {metric!r} under {BENCH / 'metrics'}")


@dataclasses.dataclass
class Context:
    """What a phase is given: where and from what seed to build."""

    device: object
    seed: int
    cell: Cell

    @property
    def model(self) -> dict:
        return self.cell.config["model"]


@dataclasses.dataclass
class Run:
    """What the readers read."""

    phase: object
    setup_s: float
    window_s: float
    steps: int
    kinds: collections.Counter
    trace: object = None
    traced_kinds: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    peaks: dict = dataclasses.field(default_factory=dict)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(phase, device, seconds: float) -> Tuple[float, int, collections.Counter]:
    """Chunks of the phase's work until ``seconds`` have passed on the host's
    clock, then a synchronize: (window seconds, steps, steps by kind)."""
    kinds: collections.Counter = collections.Counter()
    steps = 0
    t0 = time.perf_counter()
    while True:
        n, kind = phase.run_chunk()
        steps += n
        kinds[kind] += n
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return time.perf_counter() - t0, steps, kinds


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run_cell(cell: Cell, device, seed: int, seconds: float, trace: bool, t_start: float) -> dict:
    """Set up, measure, trace, check; returns the result line's object."""
    import torch

    from benchmark import trace as tracing

    ctx = Context(device=device, seed=seed, cell=cell)
    phase = phase_class(cell)(ctx)
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[bench] {cell.name} seed {seed}: set-up {setup_s:.3f} s")
    phase.reset_counts()
    window_s, steps, kinds = measure(phase, device, seconds)
    log(f"[bench] window {window_s:.3f} s, {steps} steps {dict(kinds)}, "
        f"{1e3 * window_s / max(steps, 1):.3f} ms/step")
    run = Run(phase=phase, setup_s=setup_s, window_s=window_s, steps=steps, kinds=kinds)
    on_card = torch.device(device).type == "cuda"
    if trace and on_card:
        with tracing.traced(lambda: sync(device)) as got:
            for _ in range(cell.traffic["trace_chunks"]):
                n, kind = phase.trace_chunk()
                run.traced_kinds[kind] += n
        run.trace = got[0]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    launches = phase.launch_counts()
    if launches:
        log(f"[bench] kernel launches in the windows: {json.dumps(launches)}")
    phase.free_program()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = [(name, v, cell.limits[name]) for name, v in phase.check()]
    log(f"[bench] check {time.perf_counter() - t0:.3f} s")
    result = {"correct": all(v <= lim for _, v, lim in checks), "attempted": steps,
              "failed": sum(v > lim for _, v, lim in checks)}
    if on_card:
        run.peaks = peaks_for(torch.cuda.get_device_name(device))
        log(f"[bench] card: {card_line()}")
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if on_card else "cpu",
                        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.top_gaps()}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def peaks_for(kind: str) -> dict:
    """The published peaks of the card named ``kind``."""
    table = load_json(PEAKS)
    for key, peaks in table.items():
        if key in kind:
            return peaks
    raise KeyError(f"no peaks for {kind!r} in {PEAKS}")


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"[bench] {cell.name} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, torch.device("cuda", 0), args.seed, args.seconds,
                      bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        log(f"[bench] modules that must not load in a run were loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"[bench] check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
