"""The least time of the traced steps' attention (benchmark/work.py) over
the device time of every attention kernel in the traced window.

The least time counts the sites that the program runs in attention
kernels (``work.kernel_sites``). The reading stands only while the trace
holds one forward attention kernel per such site and pass: a routing that
moves a site into or out of the kernels (a gate, SDPA, a plain path)
would add kernel time without counted work, or the reverse, so then the
metric reads nothing.
"""

from benchmark import trace, work
from benchmark.harness import log


def read(run):
    if run.trace is None or not run.peaks:
        return None
    seconds = run.trace.seconds_where(trace.is_attention)
    if seconds <= 0:
        return None
    sites = {kind: work.kernel_sites(run.phase.work(kind)["sites"]) for kind in run.traced_kinds}
    want = run.phase.forward_passes * sum(n * len(sites[kind])
                                          for kind, n in run.traced_kinds.items())
    got = sum(trace.is_attention(name) and not trace.is_backward(name)
              for name, _, _ in run.trace.device)
    log(f"[attn_roofline] forward attention kernels in the traced steps: {got}, "
        f"counted sites x passes: {want}")
    if got != want:
        return None
    elem = run.phase.dtype.itemsize
    least = sum(n * work.least_seconds(sites[kind], run.peaks, elem, run.phase.kind == "train")
                for kind, n in run.traced_kinds.items())
    return 100.0 * least / seconds
