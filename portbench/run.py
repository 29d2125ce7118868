"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload graphtcn-fd-train --seed 12345 --seconds 10 --trace 0

Run from the root of a checkout of the repository on a machine with an
NVIDIA card; the last line of standard output is the result (see
``portbench/core.py``).
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this directory, whose module names are the harness's own
sys.path[0] = str(Path(__file__).resolve().parent.parent)
os.environ.setdefault("OMP_NUM_THREADS", "4")

from portbench import core  # noqa: E402

if __name__ == "__main__":
    core.cache_env()
    sys.exit(core.main(sys.argv[1:], T_PROCESS))
