#!/usr/bin/env python3
"""Where the LM kernel's time goes on the two solve paths, the kernel alone.

Runs the Speed batch (Panda, 131,072 poses, 64 restarts, 8 lanes, 32
iterations, tol_f 1e-6) and the Quality batch (4,096 poses, 256 restarts, 64
lanes, 48 iterations) of ``chip_smoke.py`` through
``lm_kernel.solve_kernel`` and prints one JSON line per batch: the kernel's
milliseconds (CUDA events, mean of ``--reps`` launches after a warm one), the
schedule probe of one launch (``lm_kernel.schedule_profile``: tail share,
lane-iterations the pose groups ran against the warp slots executed) and the
library's registers, block size and resident warps
(``lm_kernel.library_report``).

Run on a machine with an NVIDIA card, from the repository root:

    python3 -m optik_tpu_torch.benchmarks.exp_lm_schedule [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import Robot, SolverConfig
from ..models import asset_path
from ..ops.cuda import lm_kernel
from .timing import card_line, event_ms

SPEED = dict(max_restarts=64, seed_batch=8, max_iters=32, tol_f=1e-6)
QUALITY = dict(max_restarts=256, seed_batch=64, max_iters=48)
BATCHES = (("speed", 131072, 2), ("quality", 4096, 3))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_lm_schedule: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = card_line()
    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", device="cuda")
    lo, hi = robot.joint_limits()
    for name, b, seed in BATCHES:
        cfg = SolverConfig(**SPEED) if name == "speed" else \
            SolverConfig.create("quality", **QUALITY)
        plan = lm_kernel.KernelPlan(robot.spec, cfg)
        rng = np.random.default_rng(seed)
        tr, tt = robot.fk_batch(rng.uniform(lo, hi, size=(b, 7)))
        x0 = torch.tensor(rng.uniform(lo, hi, size=(b, 7)),
                          dtype=torch.float32, device="cuda")
        ms = event_ms(lambda: lm_kernel.solve_kernel(plan, tr, tt, x0),
                      args.reps)
        lanes = lm_kernel.solve_kernel(plan, tr, tt, x0)
        row = {"batch": name, "b": b, "card": card, "kernel_ms": ms,
               "success": float(lanes.success.any(dim=1).float().mean())}
        row.update(lm_kernel.schedule_profile(lanes))
        row.update(lm_kernel.library_report(*plan.library(plan.freeze)))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
