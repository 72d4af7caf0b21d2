"""The cell train-sdxl-8f at a tiny SDXL-shaped cut on the CPU (three
levels, the first without attention, depths 1 / 2 / 3, heads of 8 in
per-level counts, 3 frames of 16x16 latents; ``conftest.TINY_TRAFFIC`` is
keyed to the other phases): a sound float32 run is correct under the cell's
own limits, planted faults and the float8 control are not; the full-width
step's model flops; the reference's parameter layout is the program's."""

import copy
import time

import pytest
import torch
from test_bench_faults import train_fault

from benchmark import harness
from benchmark.phases.common import PhaseBase
from benchmark.reference import sdxl_video as X

WORKLOAD = "train-sdxl-8f"
SEED = 2 ** 31 + 8191
TINY_MODEL = {"block_out_channels": [16, 32, 48], "cross_attention_dim": 24,
              "transformer_layers_per_block": [1, 2, 3], "attention_head_dim": [2, 4, 6],
              "norm_num_groups": 8, "addition_time_embed_dim": 8,
              "projection_class_embeddings_input_dim": 12 + 6 * 8}
TINY_TRAFFIC = {"frames": 3, "resolution": 128,
                "check": {"steps": 3, "window_steps": [[0, 1], [1, 2]]}}


def tiny_cell() -> harness.Cell:
    cell = harness.load_cell(WORKLOAD)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(TINY_MODEL)
    cell.config.update(text_embeds_dim=12, dtype="float32")
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC}
    return cell


def run() -> dict:
    return harness.run_cell(tiny_cell(), torch.device("cpu"), SEED, 0.5, False,
                            time.perf_counter())


def test_sound_run_is_correct():
    result = run()
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_fault_is_not_correct(kind, monkeypatch):
    import motioneditor_tpu_torch.training.stage1 as module

    monkeypatch.setattr(module, "train_step_stage1", train_fault(kind, module.train_step_stage1))
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
    """Forward and backward of SDXL's video UNet at 8 frames of 128x128
    latents, weight gradients of the trainables only; the attention sites
    the kernels run: 70 attn1 and 70 attn_temp."""
    from benchmark import work

    cell = harness.load_cell(WORKLOAD)
    cls = harness.phase_class(cell)
    phase = cls.__new__(cls)
    PhaseBase.__init__(phase, harness.Context(device=torch.device("cpu"), seed=1, cell=cell))
    phase.modules = cell.config["trainable_modules"]
    got = phase.work("train")
    assert got["flops"] / 1e12 == pytest.approx(160.624, rel=1e-4)
    kinds = [s["kind"] for s in work.kernel_sites(got["sites"])]
    assert (kinds.count("spatial"), kinds.count("temporal")) == (70, 70)


def test_parameter_layout_is_the_programs():
    from benchmark.phases import stage1_sdxl

    cell = tiny_cell()
    model = stage1_sdxl.build(harness.Context(device=torch.device("cpu"), seed=SEED, cell=cell),
                              torch.float32)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == X.unet_shapes(
        cell.config["model"])
