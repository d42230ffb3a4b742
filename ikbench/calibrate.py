"""Readings that set a cell's limits: the program on many seeds and the
control on a few, in one process on the card.

    python3 -m ikbench.calibrate --workload <cell> --seconds 2 \
        --seeds 11 12 ... --control-seeds 21 22 23

Each program seed is a whole run (``harness.run``) with a short window;
each control seed makes the inputs and sample a run of that seed makes
and judges the control's answers on them (the drivers' ``control``).  One
JSON line per reading; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA card")
    for seed in args.seeds:
        ctx = harness.context(args.workload, seed, args.seconds, False,
                              "cuda", time.perf_counter())
        out = harness.run(ctx)
        print(json.dumps({"reading": "program", "seed": seed,
                          "correct": out["correct"], "check": out["check"],
                          "metrics": out["metrics"]}), flush=True)
    for seed in args.control_seeds:
        ctx = harness.context(args.workload, seed, args.seconds, False,
                              "cuda", time.perf_counter())
        t0 = time.perf_counter()
        numbers, _ = harness.driver(ctx).control(ctx, torch.device("cuda"))
        print(json.dumps({"reading": "control", "seed": seed,
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
