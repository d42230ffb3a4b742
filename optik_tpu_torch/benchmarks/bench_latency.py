#!/usr/bin/env python3
"""Single-solve and small-batch IK latency on one NVIDIA card: BASELINE's
"p50 solve latency" row.  The counterpart of ``benchmarks/bench_latency.py``
with its workload (the Panda, float32, ``SolverConfig(max_restarts=64,
seed_batch=8, max_iters=32)``, ``default_rng(7)``, its draw order) and rows:

  * ``scalar_ik_p50_us``: ``Robot.ik`` on N random reachable poses, one
    call each (N from argv, 50 by default): the parse, the upload, the
    kernel at B = 1 and the fetch, on the host clock;
  * ``ik_batch_latency_us`` at B = 1, 64 and 256: ``Robot.ik_batch`` and a
    fetch of the found count, 20 calls after a warm one;
  * ``ik_b8_latency_split_ms`` at B = 8 with 8 restarts: ``synced_p50_ms``
    (one fetch per call), ``chained_per_call_ms`` (16 calls, one fetch) and
    ``inprogram_per_solve_ms``.  The JAX script puts 16 kernel calls on the
    inputs tiled x32 inside one ``jax.jit``; here it is the CUDA-event time
    of 16 back-to-back ``lm_kernel.solve_kernel`` launches on the same
    tiled inputs (B = 256; the seed layout's few launches included, the
    winner selection not), over 16.  None where no kernel runs (the CPU).

    python3 -m optik_tpu_torch.benchmarks.bench_latency [N] [--device cuda|cpu]

Without a card the default device raises; ``--device cpu`` times the plain
torch loop at float64.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import numpy as np
import torch

from .. import SolverConfig
from ..ops.cuda import lm_kernel
from .bench import panda, problem
from .timing import device_fields, event_ms

N_SCALAR = 50
CONFIG = dict(max_restarts=64, seed_batch=8, max_iters=32)
BATCHES = (1, 64, 256)
REPS = 20
B_SPLIT = 8
CHAIN = 16
TILE = 32


def draws(rng: np.random.Generator, lo, hi, n: int, batches=BATCHES,
          b_split: int = B_SPLIT) -> dict:
    """Every array the JAX script draws, in its order: the scalar targets'
    configurations, then the scalar seeds; per batch size the targets'
    configurations and the seeds; the B = 8 split's."""
    out = {"scalar_q": [rng.uniform(lo, hi) for _ in range(n)]}
    out["scalar_x0"] = [rng.uniform(lo, hi) for _ in range(n)]
    out["batches"] = [(rng.uniform(lo, hi, size=(b, 7)),
                       rng.uniform(lo, hi, size=(b, 7))) for b in batches]
    out["split"] = (rng.uniform(lo, hi, size=(b_split, 7)),
                    rng.uniform(lo, hi, size=(b_split, 7)))
    return out


def us(seconds: float) -> float:
    return round(1e6 * seconds, 1)


def split_config() -> SolverConfig:
    """The B = 8 split's config: 8 restarts in 8 lanes, 32 iterations."""
    return SolverConfig(max_restarts=8, seed_batch=8, max_iters=32)


def tile(tr, tt, x0):
    """The in-program inputs: the split's batch tiled ``TILE`` times."""
    return tr.repeat(TILE, 1, 1), tt.repeat(TILE, 1), x0.repeat(TILE, 1)


def run(device="cuda", n: int = N_SCALAR, *, batches=BATCHES,
        reps: int = REPS, emit=None) -> List[dict]:
    device = torch.device(device)
    robot = panda(device)
    cfg = SolverConfig(**CONFIG)
    lo, hi = robot.joint_limits()
    d = draws(np.random.default_rng(7), lo, hi, n, batches)
    dev = device_fields(device)
    rows = []

    def add(row):
        rows.append(row)
        if emit is not None:
            emit(row)

    # Scalar Robot.ik: the reference's example loop, one pose at a time.
    targets = [robot.fk(q) for q in d["scalar_q"]]
    robot.ik(cfg, targets[0], d["scalar_x0"][0])  # warm
    lats, ok = [], 0
    for tgt, x0 in zip(targets, d["scalar_x0"]):
        t0 = time.perf_counter()
        out = robot.ik(cfg, tgt, x0)
        lats.append(time.perf_counter() - t0)
        ok += out is not None
    add({"metric": "scalar_ik_p50_us", "value": us(np.median(lats)),
         "unit": "us", "p90_us": us(np.percentile(lats, 90)),
         "success_rate": round(ok / n, 4), "solves": n, **dev})

    # Small batches: the real-time control shape.
    for b, (q, x0_np) in zip(batches, d["batches"]):
        tr, tt, x0 = problem(robot, q, x0_np)

        def solve():
            res = robot.ik_batch(cfg, tr, tt, x0, validate_seeds=False)
            return int(res.found_count)

        solve()
        bl = []
        for _ in range(reps):
            t0 = time.perf_counter()
            found = solve()
            bl.append(time.perf_counter() - t0)
        p50 = float(np.median(bl))
        add({"metric": "ik_batch_latency_us", "batch": b, "value": us(p50),
             "unit": "us", "per_solve_us": round(1e6 * p50 / b, 2),
             "p90_us": us(np.percentile(bl, 90)),
             "success_rate": round(found / b, 4), **dev})

    # B = 8: one fetch per call, chained calls, the kernel alone.
    tr, tt, x0 = problem(robot, *d["split"])
    cfg8 = split_config()

    def solve8():
        return robot.ik_batch(cfg8, tr, tt, x0, validate_seeds=False)

    solve8().cost[0].item()
    lat_sync = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solve8().cost[0].item()
        lat_sync.append(time.perf_counter() - t0)

    def chained():
        t0 = time.perf_counter()
        for _ in range(CHAIN):
            last = solve8()
        last.cost[0].item()
        return (time.perf_counter() - t0) / CHAIN

    chained()
    chained()
    per_call = float(np.median([chained() for _ in range(3)]))
    in_prog = None
    if device.type == "cuda":
        plan = lm_kernel.KernelPlan(robot.spec, cfg8)
        tiled = tile(tr, tt, x0)
        in_prog = event_ms(lambda: lm_kernel.solve_kernel(plan, *tiled),
                           CHAIN)
    add({"metric": "ik_b8_latency_split_ms", "batch": B_SPLIT,
         "synced_p50_ms": round(1e3 * float(np.median(lat_sync)), 2),
         "chained_per_call_ms": round(1e3 * per_call, 2),
         "inprogram_per_solve_ms": (None if in_prog is None
                                    else round(in_prog, 3)), **dev})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=N_SCALAR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.device, args.n,
        emit=lambda row: print(json.dumps(row), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
