"""Import hygiene of the port: every module of motioneditor_tpu_torch
imports with JAX and Triton blocked, leaves neither in sys.modules and
builds no kernel. Runs in a subprocess because tests/conftest.py imports
JAX into this one."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "triton"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import motioneditor_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from motioneditor_tpu_torch import _build
assert _build.kernels.cache_info().currsize == 0, "a kernel was built at import"
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "triton"))
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_without_jax_or_triton():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 17  # every module of the port was imported
    assert {"motioneditor_tpu_torch.ops.video_flash_bwd",
            "motioneditor_tpu_torch.ops.temporal_flash",
            "motioneditor_tpu_torch.pipelines.editor"} <= names
