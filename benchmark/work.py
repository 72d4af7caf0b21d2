"""The least time of a step's attention, from the sites the reference
reports: each site's max(flops / peak flop rate, bytes / peak bandwidth),
its inputs read once and its output written once.

The sites counted are those whose work the program runs in attention
kernels at the cell's shapes: spatial self-attention (attn1, the
injection's, the adapter's sparse-causal and per-frame attention) over at
least ``SPATIAL_MIN_TOKENS`` queries a frame, and temporal attention at
sites of at least ``TEMPORAL_MIN_TOKENS`` tokens a frame. Smaller sites and
the text cross-attention run as plain products and a softmax, whose time
the attention kernels' time does not hold. The thresholds are those of the
program's routing as measured; ``metrics/attn_roofline.py`` reads nothing
when the traced kernels stop matching the sites counted here.
"""

from __future__ import annotations

from typing import Iterable

SPATIAL_MIN_TOKENS = 1024
TEMPORAL_MIN_TOKENS = 512
TRAIN_FACTOR = 3  # a trained site: the forward, then the backward's four products and eight tensors


def kernel_sites(sites: Iterable[dict]) -> list:
    return [s for s in sites
            if (s["kind"] == "spatial" and s["nq"] >= SPATIAL_MIN_TOKENS)
            or (s["kind"] == "temporal" and s["tokens"] >= TEMPORAL_MIN_TOKENS)]


def least_seconds(sites: Iterable[dict], peaks: dict, elem_bytes: int, train: bool) -> float:
    """The least time of the kernel sites of one step on a card with ``peaks``."""
    one = sum(max(s["flops"] / peaks["bf16_flops"], s["elems"] * elem_bytes / peaks["bytes_per_s"])
              for s in kernel_sites(sites))
    return one * (TRAIN_FACTOR if train else 1)
