"""Run-time FLOP accounting for the hand-written kernels (the port of
motioneditor_tpu/ops/flop_count.py).

The kernels launch through ``ctypes`` (``_build.py``), so
``torch.utils.flop_counter.FlopCounterMode`` sees none of their work, as
XLA's ``cost_analysis`` sees none of a Pallas custom call. Each kernel entry
calls ``add_kernel_flops`` with the JAX package's analytic model-flop count
(real head dim, score and P.V products), at the same entries and under the
same conditions: before its CPU branch, so a CPU call counts what the
card's launch would. K4-K7 (the backward kernels) and K14 count nothing, as
in JAX. ``kernel_flop_counter`` sums the calls made inside it: ``.flops``
is JAX's total, ``.by_entry`` the same flops by the entry's name in
``_build.launch_counts``.

JAX counts once per trace; the port counts on every call. A
gradient-checkpointed forward runs again inside the backward
(``torch.utils.checkpoint``), where JAX's ``jax.checkpoint`` traces the
function once: ``checkpoint_contexts`` (the ``context_fn`` the UNet passes)
stops the count during the recompute, so a training step counts as JAX's
does. The counter does arithmetic on shapes only: no tensor is read and the
host never waits for the device.
"""

from __future__ import annotations

import collections
import contextlib

_ACTIVE: list = []
_paused = 0  # > 0 inside a checkpointed forward's recompute


class kernel_flop_counter:
    """Context manager accumulating the analytic flops of every kernel
    entry called inside it, in total (``flops``) and by entry
    (``by_entry``)."""

    def __enter__(self):
        self.flops = 0
        self.by_entry = collections.Counter()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False


def add_kernel_flops(n: int, entry: str) -> None:
    if _paused:
        return
    for c in _ACTIVE:
        c.flops += n
        c.by_entry[entry] += n


@contextlib.contextmanager
def paused():
    """Count nothing inside (a recompute of work already counted)."""
    global _paused
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1


def checkpoint_contexts():
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint``: the forward
    counts, its recompute in the backward does not."""
    return contextlib.nullcontext(), paused()
