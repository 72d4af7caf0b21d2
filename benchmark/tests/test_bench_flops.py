"""The benchmark's work counts against the program's own kernel flop counter
(ops/flop_count.py, JAX's formulas) on the same step at a tiny size where
the kernels' call sites are reached (32 x 32 latents: the top level holds
1,024 tokens), and the full-width step's model flops on the meta device."""

import pytest
import torch
from conftest import tiny_cell

from benchmark import harness, work
from benchmark.phases.common import PhaseBase
from benchmark.reference import sd15_video as R


@pytest.fixture(scope="module")
def edit_phase():
    cell = tiny_cell("edit-mask-8f", resolution=256, frames=2)
    cell.config["dtype"] = "float32"
    return harness.phase_class(cell)(harness.Context(device=torch.device("cpu"), seed=5,
                                                     cell=cell))


@pytest.mark.parametrize("step,kind", [(0, "vanilla"), (4, "injected")])
def test_attention_sites_count_as_the_kernels(edit_phase, step, kind):
    """K1 + K2 count what the reference's kernel sites count; K3 counts all
    F x F frame pairs where the reference counts the causal F (F + 1) / 2."""
    from motioneditor_tpu_torch.ops.flop_count import kernel_flop_counter

    with torch.no_grad(), kernel_flop_counter() as counter:
        edit_phase._step(step, edit_phase.x["x_t"])
    sites = work.kernel_sites(edit_phase.work(kind)["sites"])
    spatial = sum(s["flops"] for s in sites if s["kind"] == "spatial")
    temporal = sum(s["flops"] for s in sites if s["kind"] == "temporal")
    by = counter.by_entry
    assert spatial == by["video_flash_attention"] + by["video_injection_attention"]
    assert (kind == "injected") == (by["video_injection_attention"] > 0)
    f = edit_phase.traffic["frames"]
    assert temporal == pytest.approx(by["temporal_flash_attention"] * (f + 1) / (2 * f))


def bare_phase(workload: str):
    """A phase module without the program's models: enough to count work."""
    cell = harness.load_cell(workload)
    cls = harness.phase_class(cell)
    phase = cls.__new__(cls)
    PhaseBase.__init__(phase, harness.Context(device=torch.device("cpu"), seed=1, cell=cell))
    t = cell.traffic
    phase.steps, phase.start_step = t.get("steps", 50), t.get("start_step", 4)
    phase.ref_ts = R.timesteps(phase.sched, phase.steps)
    phase.mode = "normal"
    phase.modules = cell.config.get("trainable_modules")
    return phase


@pytest.mark.parametrize("workload,kind,tflop", [
    # the program's own count of one injected step (its kernel counter and
    # FlopCounterMode over the program): 45.8863 TFLOP
    ("edit-mask-8f", "injected", 45.886),
    ("edit-mask-8f", "vanilla", 44.727),
    ("invert-24f", "invert", 22.487),
    # forward + backward, weight gradients of the trainables only
    ("train-stage1-24f", "train", 57.003),
])
def test_full_width_model_flops(workload, kind, tflop):
    assert bare_phase(workload).work(kind)["flops"] / 1e12 == pytest.approx(tflop, rel=1e-4)
