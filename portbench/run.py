"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    # The checkout's root goes first on the path in place of this folder:
    # the folder's module names must not shadow the standard library's.
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    from portbench.harness import main
    sys.exit(main(t_start=T_START))
