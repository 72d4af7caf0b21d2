"""On the card: each cell once through the command BENCHMARK.json names, with a
short window (run with ``python -m pytest -m cuda benchmark/tests``; skips
without an NVIDIA GPU)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_correct(cuda_device, workload, trace):
    out = subprocess.run(SPEC["command"][:1] + [str(ROOT / SPEC["command"][1]), "--workload",
                                                workload, "--seed", str(2 ** 32 + 7),
                                                "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    wanted = [m for m in SPEC["per_layer" if trace else "end_to_end"]
              if "workloads" not in m or workload in m["workloads"]]
    assert set(result["metrics"]) == {m["name"] for m in wanted}
    assert list(result)[-1] == "checks"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name, m in result["metrics"].items():
            if m["unit"] == "%":
                assert 0 < m["value"] <= 100, (name, m)


def test_no_card_no_result():
    """Without the cell's CUDA devices a run exits non-zero and prints no result."""
    code = ("import sys, runpy, torch; torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['run.py', '--workload', {SPEC['workloads'][0]['name']!r}, "
            "'--seed', '1', '--seconds', '1', '--trace', '0']; "
            "runpy.run_path('benchmark/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
