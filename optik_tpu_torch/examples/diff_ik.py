#!/usr/bin/env python3
"""Differential-IK trajectory integration (port of examples/diff_ik.py,
itself the port of kylc/optik examples/diff_ik.py, with the LP solved
exactly by the zonotope-gauge solver).

Tracks a constant world-frame end-effector velocity under joint velocity
limits, integrating q forward with explicit Euler.

Usage:
    python3 optik_tpu_torch/examples/diff_ik.py [<robot.urdf> <base_link>
        <ee_link>] [--device cuda|cpu]
"""

import argparse
import pathlib
import sys
import time

import numpy as np

# Runnable from a source checkout without installing the package.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from optik_tpu_torch import Robot  # noqa: E402
from optik_tpu_torch.models import asset_path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="*", help="<robot.urdf> <base> <ee>")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model and len(args.model) != 3:
        ap.error("give <robot.urdf> <base_link> <ee_link>, or nothing")
    urdf_path, base_name, ee_name = args.model or (
        asset_path("panda.urdf"), "panda_link0", "panda_hand_tcp")
    np.set_printoptions(precision=2, suppress=True)

    robot = Robot.from_urdf_file(urdf_path, base_name, ee_name,
                                 device=args.device)
    n = robot.num_positions()
    v_cmd = np.array([0.0, 0.0, 0.1, 0.0, 0.0, 0.0])  # desired EE twist
    qd_max = 0.75                                       # joint speed limit
    dt = 0.1

    rng = np.random.default_rng(seed=42)
    lo, hi = robot.joint_limits()
    q = rng.uniform(np.where(np.isfinite(lo), lo, -np.pi),
                    np.where(np.isfinite(hi), hi, np.pi))

    for t in np.arange(0.0, 1.0, step=dt):
        t0 = time.perf_counter()
        sol = robot.diff_ik(q, v_cmd, [qd_max] * n)
        solve_us = 1e6 * (time.perf_counter() - t0)
        assert sol is not None
        alpha, qd_star = sol
        qd_star = np.array(qd_star)

        r_we = robot.fk(q)[:3, :3]
        jac = robot.joint_jacobian(q)
        v_real = np.vstack((r_we @ jac[:3, :], r_we @ jac[3:, :])) @ qd_star
        q = q + qd_star * dt

        print(f"--- t={t:.1f}")
        print("alpha    = ", alpha)
        print("qd*      = ", qd_star)
        print("V*       = ", v_real)
        print("|V* - aV|= ", np.linalg.norm(v_real - alpha * v_cmd))
        print("p_WE     = ", robot.fk(q)[:3, 3])
        print(f"Solve time: {int(solve_us)}µs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
