"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints one JSON result as the last line of
standard output; the compared numbers and their limits are the last
lines of standard error. Exits non-zero, with no result, without a CUDA
device.
"""
import time

T_PROC = time.perf_counter()

import sys                                          # noqa: E402
from pathlib import Path                            # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness                       # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROC))
