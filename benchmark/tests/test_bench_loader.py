"""BENCHMARK.json against the benchmark's contract, every name it holds
loading from its own file, and a new configuration, traffic mix, phase
module and metric added as new files and entries alone."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_and_paths():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (ROOT / p).is_dir()
    assert len(SPEC["command"]) <= 32 and all(LINE.match(w) for w in SPEC["command"])
    files = [w for w in SPEC["command"] if w.endswith(".py")]
    assert files and all(any(f.startswith(p + "/") for p in SPEC["paths"]) for f in files)
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_configs_and_cells():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert list(c) == ["name", "source", "file", "reduced", "why"]
        assert NAME.match(c["name"]) and c["name"] in used
        assert LINE.match(c["why"]) and c["source"].startswith("https://")
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert (ROOT / c["file"]).is_file() and len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    cells = [w["name"] for w in SPEC["workloads"]]
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(cells) // 4)
    for w in SPEC["workloads"]:
        assert list(w) == ["name", "config", "traffic", "chips", "why"]
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and LINE.match(w["why"])


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    per = {m["name"]: m for m in SPEC["per_layer"]}
    assert len(e2e) == len(SPEC["end_to_end"]) and len(per) == len(SPEC["per_layer"])
    assert not set(e2e) & set(per) and "setup_s" in e2e
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in SPEC["per_layer"]:
        assert list(m) == ["name", "unit", "better", "source", "layer", "moves", "workloads"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        # every listed cell reports the metric this one moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        reported = [m for m in SPEC["end_to_end"] if harness.reports(m, cell)]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(harness.reports(m, cell) for m in SPEC["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_name_loads(workload):
    cell = harness.load_cell(workload)
    assert callable(harness.phase_class(cell))
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))
    reduced = next(c["reduced"] for c in SPEC["configs"] if c["name"] ==
                   next(w["config"] for w in SPEC["workloads"] if w["name"] == workload))
    assert set(reduced) <= set(cell.config["model"])


DUMMY_PHASE = '''
import torch


class Phase:
    """A phase module that drives no program: it only multiplies."""

    kind = "infer"

    def __init__(self, ctx):
        self.x = torch.ones(ctx.cell.traffic["size"])

    def run_chunk(self):
        self.x = self.x * 1.0
        return 1, "only"

    trace_chunk = run_chunk

    def reset_counts(self):
        pass

    def launch_counts(self):
        return {}

    def free_program(self):
        pass

    def check(self):
        return [("dummy_err", float((self.x - 1).abs().max()))]

    def work(self, kind):
        return {"flops": 1.0, "sites": []}
'''

RUN_DUMMY = '''
import json, sys, time
sys.path.insert(0, ".")
import torch
from benchmark import harness
cell = harness.load_cell("dummy-cell")
print(json.dumps(harness.run_cell(cell, torch.device("cpu"), 2**33 + 1, 0.05, False,
                                  time.perf_counter())))
'''


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    """A later change adds a configuration, a traffic mix, its phase module,
    limits and a metric as files of their own, and entries in
    BENCHMARK.json; no file the benchmark has changes, and the harness runs
    the new cell."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    (b / "configs" / "dummy.json").write_text(json.dumps({"model": {}, "dtype": "float32"}))
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps({"phase": "dummy", "size": 3,
                                                              "trace_chunks": 1}))
    (b / "phases" / "dummy.py").write_text(DUMMY_PHASE)
    (b / "limits" / "dummy-cell.json").write_text(json.dumps({"limits": {"dummy_err": 0.5}}))
    (b / "metrics" / "dummy_step_ms.py").write_text(
        "def read(run):\n    return 1e3 * run.window_s / run.steps\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                            "file": "benchmark/configs/dummy.json", "reduced": [],
                            "why": "a stand-in"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy", "traffic": "dummy-mix",
                              "chips": 1, "why": "a stand-in"})
    spec["end_to_end"].append({"name": "dummy_step_ms", "unit": "ms", "better": "lower",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    added = set(digest(b)) - set(before)
    assert {k: v for k, v in digest(b).items() if k not in added} == before
    out = subprocess.run([sys.executable, "-c", RUN_DUMMY], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["checks"] == {"dummy_err": {"value": 0.0, "limit": 0.5}}
    assert set(result["metrics"]) == {"setup_s", "dummy_step_ms"}
