"""The benchmark's plain reference against the program in float32 at a tiny
size, one test per phase module: the same weights from the seed and the
same inputs give the same step, loss and gradients (the reference imports
nothing of the program; these tests import both)."""

import pytest
import torch
from conftest import tiny_cell

from benchmark import data, harness
from benchmark.phases import common
from benchmark.phases.stage1 import trainable
from benchmark.reference import sd15_video as R

SEED = 2 ** 31 + 977


def fp32_phase(workload: str):
    cell = tiny_cell(workload)
    cell.config["dtype"] = "float32"
    ctx = harness.Context(device=torch.device("cpu"), seed=SEED, cell=cell)
    return harness.phase_class(cell)(ctx)


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def test_parameter_layout_is_the_programs():
    cell = tiny_cell("edit-mask-8f")
    ctx = harness.Context(device=torch.device("cpu"), seed=SEED, cell=cell)
    for which in ("unet", "controlnet"):
        model = common.build(ctx, which, torch.float32)
        shapes, _ = common.shapes_salt(cell.config["model"], which)
        assert {n: tuple(p.shape) for n, p in model.named_parameters()} == shapes


@pytest.mark.parametrize("step", [0, 4], ids=["vanilla", "injected"])
def test_edit_step(step):
    ph = fp32_phase("edit-mask-8f")
    start = ph.x["x_t"]
    with torch.no_grad():
        got = ph._step(step, start)
    ref, cn, ce, masks = ph._references()
    want = ph._reference_step(ref, cn, ce, masks, step, start)
    assert rel(got - start, want - start) < 1e-4
    # the injection moves the edit row: the check sees it
    if step == 4:
        plain = ph._reference_step(ref, cn, ce, masks, 0, start)
        assert rel(plain[1] - start[1], want[1] - start[1]) > 1e-3


def test_inversion_steps():
    ph = fp32_phase("invert-24f")
    _, lat = ph._invert(ph.steps)
    ref = common.reference(ph.ctx, "unet")
    for i in (0, 3, ph.steps - 1):
        want = ph._reference_step(ref, i, lat[i])
        assert rel(lat[i + 1] - lat[i], want - lat[i]) < 1e-4


def test_stage1_steps():
    """The first steps' losses, the first gradient and the changes after
    them, in float32 on both sides (time embeddings and reductions round
    differently: ~3e-4 of a gradient's norm)."""
    ph = fp32_phase("train-stage1-24f")
    ph.free_program()
    want = ph._replay("fp32", ph.traffic["check"]["steps"])
    numbers = dict(ph._numbers(ph.losses, ph.grad_norms, ph.change_norms, want))
    assert abs(ph.losses[0] - want[0][0]) / want[0][0] < 1e-5
    assert numbers["grad_err"] < 2e-3
    assert numbers["change_err"] < 5e-3
    assert max(abs(a - b) / b for a, b in zip(ph.losses, want[0])) < 1e-4


def test_stage1_trainables_are_the_programs():
    from motioneditor_tpu_torch.training.common import trainable_mask

    cell = tiny_cell("train-stage1-24f")
    ctx = harness.Context(device=torch.device("cpu"), seed=SEED, cell=cell)
    model = common.build(ctx, "unet", torch.float32)
    modules = cell.config["trainable_modules"]
    assert trainable_mask(model, modules) == {n: trainable(n, modules)
                                              for n, _ in model.named_parameters()}


def test_weights_repeat_from_the_seed():
    shapes = {"a.weight": (5, 7), "a.bias": (5,), "n.weight": (7,), "n.bias": (7,)}
    init = {"qk_gain": 1.0, "norm_spread": 0.1}
    one = data.reference_params(shapes, SEED, 1, "cpu", torch.bfloat16, init)
    two = data.reference_params(shapes, SEED, 1, "cpu", torch.bfloat16, init)
    other = data.reference_params(shapes, SEED + 1, 1, "cpu", torch.bfloat16, init)
    assert all(torch.equal(one[n], two[n]) for n in shapes)
    assert not torch.equal(one["a.weight"], other["a.weight"])
    assert one["a.weight"].abs().max() <= 1 / 7 ** 0.5
    assert (one["n.weight"] - 1).abs().max() <= 0.1


def test_precision_modes_order():
    """bf16 and fp8 emulations depart from float32 in that order."""
    ph = fp32_phase("invert-24f")
    ref = common.reference(ph.ctx, "unet")
    start = ph.x["x0"]
    want = ph._reference_step(ref, 2, start)
    err = {p: rel(ph._reference_step(R.Reference(ref.p, ref.cfg, p), 2, start) - start,
                  want - start)
           for p in ("bf16", "fp8")}
    assert 0 < err["bf16"] < err["fp8"]
