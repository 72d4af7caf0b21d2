"""The cell train-stage2-24f at a tiny cut on the CPU (``conftest``'s tiny
model; 3 frames of 64 px; ``conftest.TINY_TRAFFIC`` is keyed to the other
phases): a sound float32 run is correct under the cell's own limits,
planted faults and the float8 control are not; the full-width step's model
flops; the trainables are the program's stage-2 adapter."""

import copy
import time

import pytest
import torch
from conftest import TINY_MODEL

from benchmark import harness
from benchmark.phases.common import PhaseBase

WORKLOAD = "train-stage2-24f"
SEED = 2 ** 31 + 8209
TINY_TRAFFIC = {"frames": 3, "resolution": 64,
                "check": {"steps": 3, "window_steps": [[0, 1], [1, 2]]}}


def tiny_cell() -> harness.Cell:
    cell = harness.load_cell(WORKLOAD)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(TINY_MODEL)
    cell.config["dtype"] = "float32"
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC}
    return cell


def run() -> dict:
    return harness.run_cell(tiny_cell(), torch.device("cpu"), SEED, 0.5, False,
                            time.perf_counter())


def stage2_fault(kind, real):
    def step(state, controlnet, latents, skeleton, text, generator, *args, **kwargs):
        if kind == "half_batch":  # half of the frames left out of the loss
            f = latents.shape[1] // 2
            return real(state, controlnet, latents[:, :f], skeleton[:, :f], text, generator,
                        *args, **kwargs)
        before = {n: p.detach().clone() for n, p in state.trainable.items()}
        state, out = real(state, controlnet, latents, skeleton, text, generator, *args, **kwargs)
        with torch.no_grad():
            if kind == "unchanged":
                for n, p in state.trainable.items():
                    p.copy_(before[n])
            else:  # the largest leaf's update computed from twice its gradient
                inner = state.optimizer.inner
                p = max(state.trainable.values(), key=lambda q: inner.state[q]["exp_avg"].norm())
                inner.state[p]["exp_avg"].mul_(2)
        return state, out
    return step


def test_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_fault_is_not_correct(kind, monkeypatch):
    import motioneditor_tpu_torch.training.stage2 as module

    monkeypatch.setattr(module, "train_step_stage2", stage2_fault(kind, module.train_step_stage2))
    result = run()
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_float8_control_is_not_correct():
    cell = tiny_cell()
    phase = harness.phase_class(cell)(harness.Context(device=torch.device("cpu"), seed=SEED,
                                                      cell=cell))
    harness.measure(phase, torch.device("cpu"), 0.5)
    phase.free_program()
    numbers = dict(phase.control("fp8"))
    assert any(v > cell.limits[name] for name, v in numbers.items()), numbers


def test_full_width_model_flops():
    """The ControlNet's forward, the UNet's forward and backward with the
    adapter at 24 frames of 64x64 latents, weight gradients of the adapter
    only."""
    cell = harness.load_cell(WORKLOAD)
    cls = harness.phase_class(cell)
    phase = cls.__new__(cls)
    PhaseBase.__init__(phase, harness.Context(device=torch.device("cpu"), seed=1, cell=cell))
    assert phase.work("train")["flops"] / 1e12 == pytest.approx(81.112, rel=1e-4)


def test_trainables_are_the_programs_stage2():
    from motioneditor_tpu_torch.training.stage2 import TRAINABLE_MODULES

    from benchmark.phases import stage2

    assert tuple(stage2.STAGE2_MODULES) == tuple(TRAINABLE_MODULES)
    phase = harness.phase_class(tiny_cell())(harness.Context(
        device=torch.device("cpu"), seed=SEED, cell=tiny_cell()))
    assert phase.state.trainable and all(".controlnet_adapter." in f".{n}"
                                         for n in phase.state.trainable)
