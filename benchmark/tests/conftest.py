"""Shared pieces of the benchmark's own tests (run from the repository's
root: ``python -m pytest benchmark/tests -q -p no:cacheprovider``)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

# a cut of the cells' sizes that a CPU test can run: the same code paths
# (every level of the UNet, the adapter, the ControlNet, injection at the
# top levels), 64-channel heads of 8 (d = 8), 2-3 frames, 64 px
TINY_MODEL = {"block_out_channels": [64, 64, 64, 64], "cross_attention_dim": 32}
TINY_TRAFFIC = {
    "edit": {"frames": 3, "resolution": 64},
    "invert": {"frames": 3, "resolution": 64, "steps": 6, "trace_steps": 2},
    "stage1": {"frames": 3, "resolution": 64,
               "check": {"steps": 3, "window_steps": [[0, 1], [1, 2]]}},
}


def tiny_cell(workload: str, **traffic) -> harness.Cell:
    """The cell ``workload`` of BENCHMARK.json with its limits, at the tiny size."""
    cell = harness.load_cell(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(TINY_MODEL)
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC[cell.traffic["phase"]], **traffic}
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
