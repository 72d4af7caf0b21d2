"""Import hygiene of the port: every module of motioneditor_tpu_torch
imports with JAX, Triton and the JAX package (motioneditor_tpu) blocked,
leaves none of them in sys.modules and builds no kernel; nor does importing
a module pull in yaml, PIL, imageio or transformers, which the port imports
only inside the functions that use them. Runs in a subprocess because
tests/conftest.py imports JAX into this one."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "triton", "motioneditor_tpu")
LAZY = ("yaml", "PIL", "imageio", "transformers")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import motioneditor_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from motioneditor_tpu_torch import _build
assert _build.kernels.cache_info().currsize == 0, "a kernel was built at import"
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + LAZY)
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_without_jax_or_triton():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 62  # every module of the port was imported
    assert {f"motioneditor_tpu_torch.{m}" for m in (
        "ops.video_flash_bwd", "ops.temporal_flash", "pipelines.editor", "models.vae",
        "models.clip_text", "ops.flash_attention", "ops.injection_flash", "configs",
        "inference", "data.dataset", "utils.video", "utils.runtime", "ops.gn_stats",
        "ops.fused_norm", "training.common", "training.adam8bit", "training.stage1",
        "training.stage2", "training.checkpoint", "train_bg", "train_adaptor",
        "parallel", "parallel.mesh", "parallel.flash_sharding", "parallel.frame_ops",
        "control.p2p", "control.seq_aligner", "models.clip_image", "eval", "eval.metrics",
        "eval.lpips", "evaluate", "models.weights", "models.openpose", "models.midas", "prep",
        "prep.skeletons", "prep.alignment", "ops.ms_deform_attn", "models.swin",
        "models.grounding_dino", "models.gdino_weights", "models.sam", "prep.masks",
        "prep.tokenizer")} <= names
