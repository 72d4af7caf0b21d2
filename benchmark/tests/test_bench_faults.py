"""The check fails what it must: a run with the timed path broken
underneath (the chip's look skipped, the rest of a run driven on the CPU)
comes out not correct under the cell's own limits, once for each fault the
cell can have; the float8 control comes out not correct too. The program
runs in float32 here, so the sound run must come out correct."""

import itertools
import time

import pytest
import torch
from conftest import tiny_cell

from benchmark import harness

SEED = 2 ** 31 + 4099


def cell_of(workload: str) -> harness.Cell:
    """The tiny cell; the edit's first injected step is its second, so that
    a short window holds a vanilla and an injected step."""
    return tiny_cell(workload, **({"start_step": 1} if workload.startswith("edit") else {}))


def run(workload: str) -> dict:
    cell = cell_of(workload)
    cell.config["dtype"] = "float32"
    return harness.run_cell(cell, torch.device("cpu"), SEED, 0.5, False, time.perf_counter())


# -- the faults, planted where the program produces its answer ---------------------


def edit_fault(kind, real):
    def segment(*args, **kwargs):
        latents = args[9]
        if kind == "unchanged":
            return latents.clone()
        out = real(*args, **kwargs)
        if kind == "half_batch":  # the edit row left out, the recon row's result in its place
            out[1] = out[0]
        else:  # one frame of the edit row answers with its neighbour's latents
            out[1, 0] = out[1, 1]
        return out
    return segment


def invert_fault(kind, real):
    def invert(unet, config, schedule, latents, cond, steps, **kwargs):
        if kind == "unchanged":
            return latents, torch.stack([latents] * (steps + 1))
        x_t, lat = real(unet, config, schedule, latents, cond, steps, **kwargs)
        lat = lat.clone()
        f = lat.shape[2]
        if kind == "half_batch":  # the second half of the frames: the mean of the first's
            lat[1:, :, f // 2:] = lat[1:, :, :f // 2].mean(dim=2, keepdim=True)
        else:
            lat[1:, :, 0] = lat[1:, :, 1]
        return lat[-1], lat
    return invert


def train_fault(kind, real):
    def step(state, latents, text, generator, *args, **kwargs):
        if kind == "half_batch":  # half of the frames left out of the loss
            return real(state, latents[:, :latents.shape[1] // 2], text, generator, *args,
                        **kwargs)
        before = {n: p.detach().clone() for n, p in state.trainable.items()}
        state, out = real(state, latents, text, generator, *args, **kwargs)
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


FAULTS = {
    "edit-mask-8f": ("motioneditor_tpu_torch.pipelines.editor", "denoise_segment", edit_fault),
    "invert-24f": ("motioneditor_tpu_torch.pipelines.editor", "ddim_invert", invert_fault),
    "train-stage1-24f": ("motioneditor_tpu_torch.training.stage1", "train_step_stage1",
                         train_fault),
}


@pytest.mark.parametrize("workload", list(FAULTS))
def test_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", list(FAULTS))
def test_fault_is_not_correct(workload, kind, monkeypatch):
    import importlib

    module_name, fn, fault = FAULTS[workload]
    module = importlib.import_module(module_name)
    monkeypatch.setattr(module, fn, fault(kind, getattr(module, fn)))
    result = run(workload)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_fault_in_the_window_alone_is_not_correct(kind, monkeypatch):
    """A training fault that starts after set-up's steps, as a path that a
    warm-up turns on would: set-up's numbers pass, the window's checked
    steps fail."""
    import motioneditor_tpu_torch.training.stage1 as module

    real = module.train_step_stage1
    faulty = train_fault(kind, real)
    calls = itertools.count()
    steps = cell_of("train-stage1-24f").traffic["check"]["steps"]
    monkeypatch.setattr(module, "train_step_stage1",
                        lambda *a, **k: (faulty if next(calls) >= steps else real)(*a, **k))
    result = run("train-stage1-24f")
    checks = result["checks"]
    assert all(checks[n]["value"] <= checks[n]["limit"]
               for n in ("grad_err", "change_err")), checks
    assert not result["correct"], checks


# a wrong timestep table in the program: DDIM's order reversed, its stride
# halved, every step one schedule step late, or the offset dropped
TABLES = {
    "reversed": lambda ts: ts[::-1].copy(),
    "half_stride": lambda ts: ts // 2,
    "one_step_late": lambda ts: ts - ts[0] + ts[1],
    "dropped_offset": lambda ts: ts - 1,
}


@pytest.mark.parametrize("workload,table", [
    *(("edit-mask-8f", t) for t in ("reversed", "half_stride", "one_step_late")),
    *(("invert-24f", t) for t in TABLES),
])
def test_wrong_timestep_table_is_not_correct(workload, table, monkeypatch):
    """The reference takes its own timesteps: a program whose table is
    wrong evaluates its steps at other timesteps than the reference. (A
    dropped offset moves an edit step's update by ~7%, under the edit's
    limit; the inversion, on the same table, catches it.)"""
    from motioneditor_tpu_torch.schedulers import DiffusionSchedule

    real = DiffusionSchedule.inference_timesteps
    monkeypatch.setattr(DiffusionSchedule, "inference_timesteps",
                        lambda self, n: TABLES[table](real(self, n)))
    result = run(workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", list(FAULTS))
def test_float8_control_is_not_correct(workload):
    """The control: the reference in float8 in the program's place, on the
    same steps from the same starts, against the cell's limits."""
    cell = cell_of(workload)
    ctx = harness.Context(device=torch.device("cpu"), seed=SEED, cell=cell)
    phase = harness.phase_class(cell)(ctx)
    harness.measure(phase, torch.device("cpu"), 0.5)
    phase.free_program()
    numbers = dict(phase.control("fp8"))
    assert any(v > cell.limits[name] for name, v in numbers.items()), numbers
