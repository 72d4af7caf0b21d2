"""Run one cell of the benchmark once and print its result as the last line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (motioneditor_tpu_torch).
Exits non-zero without a result when the cell's CUDA devices are missing.
See benchmark/harness.py for what a run does and where each part is found.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
# a library the program uses must not load JAX by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
