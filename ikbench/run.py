"""Run one cell of the benchmark on the card and print its result line.

    python3 ikbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (see ``harness.py``)."""

import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

# The checkout's root in place of this script's folder, whose modules
# (trace.py) would shadow the standard library's.
sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from ikbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
