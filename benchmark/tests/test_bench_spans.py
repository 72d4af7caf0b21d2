"""The readers of the program's spans (benchmark/spans.py) on a synthetic
traced window and synthetic span records: device ms per step from the
records, the host's dispatch per step from the step spans' host events,
the idle gaps that fall inside a phase's host intervals, and nothing read
without a trace, without records or without the spans' host events."""

import collections
import types

import pytest

from benchmark import harness, spans, trace


def two_train_steps() -> trace.Trace:
    """A 2000 us window of two training steps, each forward 400 us,
    backward 400 us and optimizer 200 us on the host; the card idle in
    0-100, 350-500, 900-950, 1000-1100, 1300-1350 and 1900-2000."""
    device = [("k", 100.0, 350.0), ("k", 500.0, 900.0), ("k", 950.0, 1000.0),
              ("k", 1100.0, 1300.0), ("k", 1350.0, 1900.0)]
    host = [("bench.train_step_stage1", 0.0, 1000.0), ("aten::mm", 20.0, 30.0)]
    for t0 in (0.0, 1000.0):
        host += [("me.train_step", t0, t0 + 1000.0), ("me.forward", t0, t0 + 400.0),
                 ("me.unet", t0 + 50.0, t0 + 350.0), ("me.backward", t0 + 400.0, t0 + 800.0),
                 ("me.optimizer", t0 + 800.0, t0 + 1000.0)]
    host.append(("me.train_step", 2100.0, 2500.0))  # after the window: left out
    return trace.Trace(device=device, host=host, lo=0.0, hi=2000.0)


def records(**device_ms):
    return [types.SimpleNamespace(name="me." + name, device_ms=ms)
            for name, values in device_ms.items() for ms in values]


def run(tr, steps=2):
    return harness.Run(phase=None, setup_s=1.0, window_s=1.0, steps=10,
                       kinds=collections.Counter({"train": 10}), trace=tr,
                       traced_kinds=collections.Counter({"train": steps}))


@pytest.fixture
def program(monkeypatch):
    """Stands in for the program's span records."""
    def use(recs):
        monkeypatch.setattr(spans, "records", lambda: recs)
    return use


def test_device_ms_per_step(program):
    program(records(unet=[3.0, 5.0], backward=[10.0, 12.0], optimizer=[1.0, 1.5],
                    adapter=[None, None]))
    r = run(two_train_steps())
    assert harness.reader("unet_ms.train")(r) == pytest.approx(4.0)
    assert harness.reader("unet_ms.infer")(r) == pytest.approx(4.0)
    assert harness.reader("backward_ms.train")(r) == pytest.approx(11.0)
    assert harness.reader("optimizer_ms.train")(r) == pytest.approx(1.25)
    # no record of the span, or records without device time (a CPU run)
    assert harness.reader("controlnet_ms.infer")(r) is None
    assert harness.reader("adapter_ms.infer")(r) is None
    # per traced step: three traced inversion steps
    assert harness.reader("unet_ms.infer")(run(two_train_steps(), steps=3)) == \
        pytest.approx(8.0 / 3)


def test_dispatch_per_step():
    r = run(two_train_steps())
    # the step spans' host time inside the window, 2000 us over 2 steps
    assert harness.reader("dispatch_ms.train")(r) == pytest.approx(1.0)
    assert harness.reader("dispatch_ms.infer")(r) == pytest.approx(1.0)
    tr = two_train_steps()
    tr.host = [h if h[0] != "me.train_step" else ("me.denoise_step", *h[1:]) for h in tr.host]
    tr.host.append(("me.invert_step", 1500.0, 1700.0))  # overlaps a step span: counted once
    assert harness.reader("dispatch_ms.infer")(run(tr)) == pytest.approx(1.0)


def test_starved_is_the_idle_inside_each_phase():
    r = run(two_train_steps())
    forward = harness.reader("starved_ms.forward")(r)
    backward = harness.reader("starved_ms.backward")(r)
    optimizer = harness.reader("starved_ms.optimizer")(r)
    # forward: 0-100, 350-400, 1000-1100, 1300-1350; backward: 400-500;
    # optimizer: 900-950, 1900-2000 (us, over 2 steps)
    assert forward == pytest.approx(0.15)
    assert backward == pytest.approx(0.05)
    assert optimizer == pytest.approx(0.075)
    # the phases tile the steps, so together they hold every idle gap
    idle_ms = (1.0 - r.trace.busy_s() / r.trace.window_s) * r.trace.window_s * 1e3
    assert forward + backward + optimizer == pytest.approx(idle_ms / 2)


def test_host_intervals_are_clipped_and_merged():
    tr = trace.Trace(device=[], host=[("me.forward", -50.0, 100.0), ("me.forward", 80.0, 200.0),
                                      ("me.forward", 300.0, 400.0), ("me.forward", 900.0, 1200.0),
                                      ("me.unet", 0.0, 1000.0)], lo=0.0, hi=1000.0)
    assert spans.host_intervals(run(tr), ("me.forward",)) == [(0.0, 200.0), (300.0, 400.0),
                                                              (900.0, 1000.0)]


NAMES = ["unet_ms.infer", "unet_ms.train", "controlnet_ms.infer", "adapter_ms.infer",
         "backward_ms.train", "optimizer_ms.train", "dispatch_ms.infer", "dispatch_ms.train",
         "starved_ms.forward", "starved_ms.backward", "starved_ms.optimizer"]


@pytest.mark.parametrize("name", NAMES)
def test_nothing_read_without_a_trace_or_spans(program, name):
    program(records(unet=[3.0], controlnet=[1.0], adapter=[1.0], backward=[2.0],
                    optimizer=[1.0]))
    read = harness.reader(name)
    assert read(run(None)) is None
    # a program without spans: no records, no me. host events
    no_spans = two_train_steps()
    no_spans.host = [h for h in no_spans.host if not h[0].startswith("me.")]
    program([])
    assert read(run(no_spans)) is None


def test_a_program_without_span_records(monkeypatch):
    """A program older than the spans has no ``span_records``: no records."""
    from motioneditor_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_records")
    assert spans.records() == []
    assert harness.reader("unet_ms.infer")(run(two_train_steps())) is None


def test_the_names_match_the_program():
    from motioneditor_tpu_torch.utils import profiling

    assert spans.STEP_SPANS == profiling.STEP_SPANS
    assert set(NAMES) == {m["name"] for m in harness.load_json(harness.ROOT / "BENCHMARK.json")
                          ["per_layer"] if m["source"] == "program_span"}
