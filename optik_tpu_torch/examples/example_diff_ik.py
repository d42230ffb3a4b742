#!/usr/bin/env python3
"""Direction-only velocity scaling, checked across a v_max sweep in one
batch (port of examples/example_diff_ik.py).

The diff-IK contract (kylc/optik examples/example_diff_ik.py): the solver
may only *scale* the commanded spatial velocity, never bend it, so for every
solve V_tgt == (J_W v*) / alpha.  Tightening the joint-velocity limit
shrinks alpha; the realized twist stays on the commanded ray.  The four
limit settings are four lanes of one ``diff_ik_batch`` call (same state,
same command), solved by the exact zonotope-gauge solver, and the contract
is asserted on the whole batch.

Usage:
    python3 optik_tpu_torch/examples/example_diff_ik.py [<robot.urdf>
        <base_link> <ee_link>] [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

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
    np.set_printoptions(suppress=True, precision=3)

    robot = Robot.from_urdf_file(urdf_path, base_name, ee_name,
                                 device=args.device)
    n = robot.num_positions()
    rng = np.random.default_rng(seed=42)
    lo, hi = robot.joint_limits()
    x0 = rng.uniform(np.where(np.isfinite(lo), lo, -np.pi),
                     np.where(np.isfinite(hi), hi, np.pi))

    # One commanded twist, four velocity-limit settings -> a 4-lane batch.
    limits = np.array([0.1, 0.5, 1.0, 10.0])
    v_tgt = np.array([0.0, 0.0, 0.5, 0.0, 0.0, 1.0])
    b = len(limits)
    alpha, v_star, ok = robot.diff_ik_batch(
        np.broadcast_to(x0, (b, n)), np.broadcast_to(v_tgt, (b, 6)),
        np.broadcast_to(limits[:, None], (b, n)))
    alpha, v_star, ok = (t.double().cpu().numpy() if t.is_floating_point()
                         else t.cpu().numpy() for t in (alpha, v_star, ok))
    assert ok.all(), "QP failed on some lanes"

    # Realized twist per lane: V* = J_W(x0) v*, the local Jacobian rotated
    # into the world frame (one Jacobian: the state is shared).
    jac = robot.joint_jacobian(x0)
    r_w = robot.fk(x0)[:3, :3]
    j_w = np.vstack((r_w @ jac[:3, :], r_w @ jac[3:, :]))
    v_real = v_star @ j_w.T

    print(f"x0 = {x0}")
    print(f"V_tgt = {v_tgt}")
    print(f"{'v_max':>6} {'alpha':>8}  realized twist V*")
    for k in range(b):
        print(f"{limits[k]:>6} {alpha[k]:>8.4f}  {v_real[k]}")

    # The contract, batched: alpha in [0, 1], |v| within each lane's limit,
    # and the realized twist is exactly the scaled command.
    assert np.all((alpha >= -1e-6) & (alpha <= 1.0 + 1e-6))
    assert np.all(np.abs(v_star) <= limits[:, None] + 1e-6)
    np.testing.assert_allclose(v_real / alpha[:, None],
                               np.broadcast_to(v_tgt, (b, 6)), atol=5e-5,
                               rtol=0)  # f32 solve: tracking residual ~1e-5
    # Tighter limits can only shrink the feasible scaling.
    assert np.all(np.diff(alpha) >= -1e-6)
    print("ok: V_tgt == V*/alpha on every lane; alpha monotone in v_max")
    return 0


if __name__ == "__main__":
    sys.exit(main())
