"""What a run may load: no JAX and no JAX package in the process after a
run, and a reference that imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
PROGRAM = "motioneditor_tpu_torch"

TINY_RUNS = '''
import sys, time
sys.path.insert(0, "benchmark/tests")
sys.path.insert(0, ".")
import torch
from conftest import tiny_cell
from benchmark import harness
for w in ("edit-mask-8f", "invert-24f", "train-stage1-24f"):
    harness.run_cell(tiny_cell(w), torch.device("cpu"), 3, 0.01, False, time.perf_counter())
print(sorted({m.split(".")[0] for m in sys.modules}))
print(harness.forbidden_modules())
'''


def test_no_jax_after_a_run():
    out = subprocess.run([sys.executable, "-c", TINY_RUNS], cwd=ROOT, capture_output=True,
                         text=True, timeout=900, env={"PATH": "/usr/bin:/bin",
                                                      "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert f"'{PROGRAM}'" in loaded  # the port ran, and its name is not the JAX package's


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "motioneditor_tpu_torch_extra", sys)
    assert "motioneditor_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "motioneditor_tpu.ops", sys)
    assert "motioneditor_tpu" in harness.forbidden_modules()


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert files
    for path in files:
        assert not imported_roots(path) & {PROGRAM, "motioneditor_tpu", "jax", "flax"}, path
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.sd15_video; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and PROGRAM not in out.stdout, out.stderr[-2000:]
