"""Run one cell of the port's benchmark once, from the repository's root:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line on standard output is the run's result (``harness.py``).
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the root, not this folder, so that the package's modules do not shadow
# the standard library's
sys.path[0] = ROOT

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0, ROOT))
