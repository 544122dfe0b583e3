#!/usr/bin/env python3
"""The benchmark of `pointclouds_tpu_torch`, one cell a run:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The last
line of standard output is the result's JSON object; the numbers the
outputs were compared on, each with its limit, are the last lines of
standard error. Without a card it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, not this directory, leads the import path.
sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
