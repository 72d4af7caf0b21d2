"""``transformer_ms.train``: the device ms per traced step of the
program's ``me.transformer`` spans, summed over the stacks and the
recompute's calls; nothing read without a trace or without the spans (a
program older than the span)."""

import collections
import types

import pytest

from benchmark import harness, spans, trace


def run(traced_steps):
    tr = trace.Trace(device=[("k", 0.0, 10.0)], host=[], lo=0.0, hi=10.0)
    return harness.Run(phase=None, setup_s=1.0, window_s=1.0, steps=4,
                       kinds=collections.Counter({"train": 4}),
                       trace=tr if traced_steps else None,
                       traced_kinds=collections.Counter({"train": traced_steps}))


def records(**device_ms):
    return [types.SimpleNamespace(name="me." + name, device_ms=ms)
            for name, values in device_ms.items() for ms in values]


def test_sum_of_the_stacks_per_step(monkeypatch):
    # two traced steps, each two stacks in the forward and one recomputed
    monkeypatch.setattr(spans, "records", lambda: records(
        transformer=[1.0, 2.0, 1.5, 1.0, 2.0, 1.5], unet=[9.0, 9.0]))
    assert harness.reader("transformer_ms.train")(run(2)) == pytest.approx(4.5)


@pytest.mark.parametrize("recs,steps", [([], 2), (records(unet=[3.0]), 2),
                                        (records(transformer=[None]), 2),
                                        (records(transformer=[1.0]), 0)])
def test_nothing_read(monkeypatch, recs, steps):
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert harness.reader("transformer_ms.train")(run(steps)) is None
