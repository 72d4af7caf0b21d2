"""The program's spans (utils/profiling.py ``span``): nothing outside a
profiler; under a CPU torch.profiler, host-only ranges (function scope, no
user annotation) nested as the layers nest, with records that carry their
parent and step ordinal; and the exact spans each step of the benchmarked
entries emits at a tiny size, with the UNet's span once per training step
under gradient checkpointing (the recompute does not re-enter it) and a
``me.transformer`` span for each Transformer2D call, the recompute's too."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from motioneditor_tpu_torch.models.controlnet import (
    ControlNetModel,
    controlnet_config,
    precompute_cond_embedding,
)
from motioneditor_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig, unet_apply
from motioneditor_tpu_torch.pipelines.editor import ddim_invert, denoise_segment
from motioneditor_tpu_torch.schedulers import DiffusionSchedule
from motioneditor_tpu_torch.training import stage1, stage2
from motioneditor_tpu_torch.training.common import make_optimizer, make_train_state
from motioneditor_tpu_torch.utils.profiling import clear_span_records, span, span_records

TINY = UNetConfig(block_out_channels=(32, 64, 64, 64), norm_num_groups=8, attention_heads=4,
                  cross_attention_dim=16, use_sc_attn=True)
F, LAT, L = 2, 8, 5
SCHEDULE = DiffusionSchedule()


@pytest.fixture(autouse=True)
def _fresh():
    torch.set_num_threads(1)
    torch.manual_seed(0)
    clear_span_records()
    yield
    clear_span_records()


def models():
    return (UNet3DConditionModel(TINY).eval(),
            ControlNetModel(controlnet_config(TINY)).eval())


def latents(b):
    return 0.2 * torch.randn(b, F, LAT, LAT, 4)


def text(b):
    return torch.randn(b, L, TINY.cross_attention_dim)


def profiled(fn):
    """``fn()`` under a CPU profiler; (its records, the profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return span_records(), prof


def profiler_spans(prof, records):
    """The program's ranges among the profiler's raw events (faster to read
    than ``prof.events()``): one a record, none a user annotation."""
    got = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("me.")]
    assert sorted(e.name() for e in got) == sorted(r.name for r in records)
    assert not any(e.is_user_annotation() for e in got)


def me_parent(event):
    """The innermost program span around a profiler event."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("me."):
        p = p.cpu_parent
    return None if p is None else p.name


def stacks(parent, n):
    """``n`` Transformer2D spans inside ``parent``."""
    return [("me.transformer", parent)] * n


def by_step(records):
    steps = {}
    for r in records:
        steps.setdefault(r.step, []).append((r.name, r.parent))
    return steps


def test_no_profiler_no_span():
    assert span("me.unet") is span("me.train_step")  # one shared null context
    unet, _ = models()
    with torch.no_grad():
        unet_apply(unet, TINY, latents(1), 10, text(1))
        with span("me.denoise_step"):
            pass
    assert span_records() == []


def test_spans_are_host_ranges_nested_with_their_records():
    def fn():
        with span("me.train_step"):
            with span("me.forward"):
                torch.ones(4).sum()
            with span("me.backward"):
                torch.ones(4).sum()
        with span("me.train_step"):
            with span("me.forward"):
                with span("me.unet"):
                    torch.ones(4).sum()
        with span("me.unet"):
            pass

    records, prof = profiled(fn)
    spans = [e for e in prof.events() if e.name.startswith("me.")]
    assert [e.name for e in spans].count("me.train_step") == 2 and len(spans) == 7
    assert not any(e.is_user_annotation for e in spans)
    assert {e.name: me_parent(e) for e in spans} == {
        "me.train_step": None, "me.forward": "me.train_step",
        "me.backward": "me.train_step", "me.unet": None}  # the last me.unet is top-level
    assert [(r.name, r.parent, r.step) for r in records] == [
        ("me.train_step", None, 1), ("me.forward", "me.train_step", 1),
        ("me.backward", "me.train_step", 1), ("me.train_step", None, 2),
        ("me.forward", "me.train_step", 2), ("me.unet", "me.forward", 2),
        ("me.unet", None, None)]
    for r in records:
        assert 0 < r.host_start_ns <= r.host_end_ns and r.device_ms is None


def test_denoise_segment_spans():
    unet, cn = models()
    cond_emb = precompute_cond_embedding(cn, torch.rand(2, F, 8 * LAT, 8 * LAT, 3))
    ts = SCHEDULE.inference_timesteps(4)

    def fn():
        with torch.no_grad():
            denoise_segment(unet, TINY, cn, controlnet_config(TINY), SCHEDULE, 4, None, 7.5,
                            1.0, latents(2), ts[:2], text(2), text(2), cond_emb, None)

    records, prof = profiled(fn)
    # the ControlNet's 7 stacks; the UNet's 6 down stacks, the adapter, the
    # mid and up stacks
    step = [("me.denoise_step", None), ("me.controlnet", "me.denoise_step"),
            *stacks("me.controlnet", 7), ("me.unet", "me.denoise_step"),
            *stacks("me.unet", 6), ("me.adapter", "me.unet"), *stacks("me.unet", 10)]
    assert by_step(records) == {1: step, 2: step}
    profiler_spans(prof, records)


def test_ddim_invert_spans():
    unet, _ = models()
    records, prof = profiled(lambda: ddim_invert(unet, TINY, SCHEDULE, latents(1), text(1), 3))
    step = [("me.invert_step", None), ("me.unet", "me.invert_step"), *stacks("me.unet", 16)]
    assert by_step(records) == {1: step, 2: step, 3: step}
    profiler_spans(prof, records)


def train_state(unet, modules):
    return make_train_state(unet.train(), modules, make_optimizer(1e-4))


@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_spans(stage):
    """Two steps of each stage with gradient checkpointing: one forward,
    backward and optimizer span a step, and the UNet's span once; the
    backward recomputes the stacks that lead to a trainable (stage 1: all
    16; stage 2: the 9 up stacks, which take the adapted skips)."""
    unet, cn = models()
    g = torch.Generator().manual_seed(3)
    lat, txt = latents(1), text(1)
    if stage == 1:
        state = train_state(unet, stage1.TRAINABLE_MODULES)

        def fn():
            for _ in range(2):
                stage1.train_step_stage1(state, lat, txt, g, TINY, SCHEDULE, remat=True)
    else:
        state = train_state(unet, stage2.TRAINABLE_MODULES)
        skeleton = torch.rand(1, F, 8 * LAT, 8 * LAT, 3)

        def fn():
            for _ in range(2):
                stage2.train_step_stage2(state, cn, lat, skeleton, txt, g, TINY,
                                         controlnet_config(TINY), SCHEDULE, remat=True)

    records, prof = profiled(fn)
    models_ = [("me.unet", "me.forward"), *stacks("me.unet", 16)]
    recomputed = 16
    if stage == 2:
        models_ = [("me.controlnet", "me.forward"), *stacks("me.controlnet", 7),
                   ("me.unet", "me.forward"), *stacks("me.unet", 6), ("me.adapter", "me.unet"),
                   *stacks("me.unet", 10)]
        recomputed = 9
    step = [("me.train_step", None), ("me.forward", "me.train_step"), *models_,
            ("me.backward", "me.train_step"), *stacks("me.backward", recomputed),
            ("me.optimizer", "me.train_step")]
    assert by_step(records) == {1: step, 2: step}
    profiler_spans(prof, records)  # so the profiler too holds one me.unet a step
