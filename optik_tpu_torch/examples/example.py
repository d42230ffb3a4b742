#!/usr/bin/env python3
"""Random-pose IK benchmark loop (port of examples/example.py, itself the
port of kylc/optik examples/example.py).

Loads a model, generates random reachable targets, solves them in batches
through ``Robot.ik_batch`` (the Hopper LM kernel on the card), and prints
the average per-solve time and success rate.

Usage:
    python3 optik_tpu_torch/examples/example.py [<robot.urdf> <base_link>
        <ee_link>] [--device cuda|cpu] [--n N]

With no model the bundled Panda is used; ``--device cpu`` runs the plain
torch solver instead of the card.
"""

import argparse
import pathlib
import sys
import time

import numpy as np

# Runnable from a source checkout without installing the package.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from optik_tpu_torch import Robot, SolverConfig  # noqa: E402
from optik_tpu_torch.models import asset_path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="*", help="<robot.urdf> <base> <ee>")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=10_000, help="poses in all")
    args = ap.parse_args(argv)
    if args.model and len(args.model) != 3:
        ap.error("give <robot.urdf> <base_link> <ee_link>, or nothing")
    urdf_path, base_name, ee_name = args.model or (
        asset_path("panda.urdf"), "panda_link0", "panda_hand_tcp")

    robot = Robot.from_urdf_file(urdf_path, base_name, ee_name,
                                 device=args.device)
    config = SolverConfig(max_restarts=16, max_iters=64)
    b = min(1_000, args.n)  # poses per device batch

    rng = np.random.default_rng()
    lo, hi = robot.joint_limits()
    lo = np.where(np.isfinite(lo), lo, -np.pi)
    hi = np.where(np.isfinite(hi), hi, np.pi)
    n = robot.num_positions()

    total_time, total_found, total = 0.0, 0, 0
    for _ in range(0, args.n, b):
        x0 = rng.uniform(lo, hi, size=(b, n))
        tr, tt = robot.fk_batch(rng.uniform(lo, hi, size=(b, n)))
        t0 = time.perf_counter()
        # fk_batch's outputs already live on the Robot's device.
        res = robot.ik_batch(config, tr, tt, x0)
        found = int(res.found.sum())  # waits for the solve
        tf = time.perf_counter()
        total_time += tf - t0
        total_found += found
        total += b
        print(f"Batch of {b}: {1e6 * (tf - t0) / b:.1f}µs/solve, "
              f"{found / b:.1%} success")

    print(f"Average time: {1e6 * total_time / total:.1f}µs")
    print(f"Success rate: {total_found / total:.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
