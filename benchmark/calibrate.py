"""Readings that the correctness limits are set from: the program's numbers
over many seeds, and the float8 control's over a few, in one process (set-up
is long; the benchmark's own runs never run this):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 7,8,9 [--seconds 3]

Each seed builds the cell and runs a short window at the cell's load; a
program seed prints its check's numbers, a control seed the same numbers
with the float8 reference in the program's place, from the same starts.
One JSON line per seed on standard output.
"""

import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def readings(cell, device, seed: int, seconds: float, control: bool) -> dict:
    import torch

    t0 = time.perf_counter()
    phase = harness.phase_class(cell)(harness.Context(device=device, seed=seed, cell=cell))
    harness.sync(device)
    out = {"seed": seed, "who": "control" if control else "program",
           "setup_s": time.perf_counter() - t0}
    window_s, steps, _ = harness.measure(phase, device, seconds)
    out["ms_per_step"] = 1e3 * window_s / steps
    phase.free_program()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["numbers"] = dict(phase.control() if control else phase.check())
    out["check_s"] = time.perf_counter() - t0
    del phase
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        harness.log("[calibrate] no CUDA device")
        return 2
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            print(json.dumps(readings(cell, device, int(s), args.seconds, control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
