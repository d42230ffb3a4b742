"""Helpers of the benchmark's CPU tests: small rehearsals of a cell."""

import time

from ikbench import harness

# Sizes a CPU run holds: the plain loop solves 16 poses in about a second.
SMALL = {
    "ik_stream": {"batch": 16, "pool": 2, "fetch_every": 1,
                  "check_sample": 16, "trace_batches": 2},
    "ik_stream_mesh": {"batch": 16, "pool": 2, "fetch_every": 1,
                       "check_sample": 16, "trace_batches": 2},
    "diffik_calls": {"batch": 64, "pool": 2, "check_sample": 64,
                     "trace_calls": 2},
}

# The differential-IK cell's entry: its files are kept, but BENCHMARK.json
# does not run it (PERF.md says why).
DIFFIK = {"name": "panda7.diffik-calls", "config": "panda7",
          "traffic": "diffik-calls", "chips": 1}

SEED = 2 ** 31 + 12345


def small_context(workload, *, trace=False, patch=None, cell=None,
                  seed=SEED):
    traffic = harness.HERE / "traffic" / f"{_traffic(workload, cell)}.json"
    kind = harness.load(traffic)["kind"]
    return harness.context(workload, seed, 0.3, trace, "cpu",
                           time.perf_counter(), SMALL[kind], patch, cell)


def _traffic(workload, cell):
    if cell is not None:
        return cell["traffic"]
    cells = {w["name"]: w for w in harness.benchmark()["workloads"]}
    return cells[workload]["traffic"]
