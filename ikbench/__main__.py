import sys
import time

T0 = time.perf_counter()

from ikbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
