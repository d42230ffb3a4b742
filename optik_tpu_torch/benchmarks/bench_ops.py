#!/usr/bin/env python3
"""Op-level throughput on one NVIDIA card: the counterpart of
``benchmarks/bench_ops.py`` (the reference's criterion set: fk, objective,
gradient, joint_jacobian, diff_ik, ik), with its workload: the UR3e
(``ur3e.urdf``, ``ur_base_link`` -> ``ur_ee_link``), L = 65,536
configurations and targets from ``default_rng(0)`` in its draw order.

  * ``fk``, ``objective`` (the squared norm of the SE(3) log of the pose
    error, ``soa.se3_log``) and ``gradient`` (2 e^T J from
    ``soa.residual_and_jtask``): the port's SoA functions over (L,) lanes,
    as eager tensor operations;
  * ``joint_jacobian``: ``Robot.jacobian_batch`` on the L configurations;
  * ``diff_ik``: ``Robot.diff_ik_batch(..., rescue=False)`` at B = 4,096
    (random commands, ``v_max`` 1; the inputs uploaded by every call, as the
    JAX script passes numpy arrays);
  * ``ik``: ``Robot.ik_batch`` with ``SolverConfig(max_restarts=8,
    max_iters=48)`` on the first 1,024 targets, seeded by the first 1,024
    configurations (on the card the Hopper kernel).

Each op: one warm call, then ``n`` calls (20; 3 for diff_ik and ik) and one
sync, on the host clock.  TF32 is off (``use_full_f32_matmuls``), as the
JAX script runs each op under ``with_f32_matmuls``.

    python3 -m optik_tpu_torch.benchmarks.bench_ops [--device cuda|cpu]

prints one ``<op>_ops_per_s`` row per op with ``ms_per_batch``.  Without a
card the default device raises; ``--device cpu`` runs at float64.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import Robot, SolverConfig
from ..models import asset_path
from ..ops import soa
from ..utils.precision import use_full_f32_matmuls
from .timing import device_fields, engine_dtype, sync

UR3E = ("ur3e.urdf", "ur_base_link", "ur_ee_link")
L = 65536
B_DIFFIK = 4096
B_IK = 1024
IK_CONFIG = dict(max_restarts=8, max_iters=48)


class Sizes(NamedTuple):
    lanes: int = L
    diff_ik: int = B_DIFFIK
    ik: int = B_IK


def draws(rng: np.random.Generator, lo, hi, a: int, sizes: Sizes) -> dict:
    """The JAX script's draws in order: the configurations, the targets'
    configurations, the diff-IK start configurations and its commands."""
    q = rng.uniform(lo, hi, size=(sizes.lanes, a))
    qt = rng.uniform(lo, hi, size=(sizes.lanes, a))
    x0 = rng.uniform(lo, hi, size=(sizes.diff_ik, a))
    v_we = rng.standard_normal((sizes.diff_ik, 6))
    return {"q": q, "qt": qt, "x0": x0, "v_we": v_we}


def soa_ops(robot: Robot) -> Dict[str, Callable]:
    """fk, objective and gradient over the SoA functions: ``q`` (L, A),
    targets ``tr`` (L, 3, 3), ``tt`` (L, 3)."""
    consts = soa.chain_constants(robot.spec)
    a = robot.num_positions()

    def unpack(q):
        return [q[:, j] for j in range(a)]

    def target(tr, tt):
        return ([[tr[:, i, j] for j in range(3)] for i in range(3)],
                [tt[:, i] for i in range(3)])

    def fk(q):
        _, _, t = soa.fk_joints(consts, unpack(q))
        return sum(t)

    def objective(q, tr, tt):
        tm, tv = target(tr, tt)
        _, r_ee, t_ee = soa.fk_joints(consts, unpack(q))
        xr = soa.mat_mul(soa.mat_t(tm), r_ee)
        xt = soa.mat_tvec(tm, soa.vec_sub(t_ee, tv))
        e = soa.se3_log(xr, xt)
        return soa.vec_dot(e, e)

    def gradient(q, tr, tt):
        tm, tv = target(tr, tt)
        e, jt = soa.residual_and_jtask(consts, unpack(q), tm, tv)
        return [2.0 * sum(e[i] * jt[i][p] for i in range(6))
                for p in range(a)]

    return {"fk": fk, "objective": objective, "gradient": gradient}


def timeit(fn, *args, n: int = 20) -> float:
    """Seconds per call: one warm call and a sync, then ``n`` calls and one
    sync."""
    sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / n


def run(device="cuda", sizes: Sizes = Sizes(), *, n: int = 20,
        n_solve: int = 3, emit=None) -> List[dict]:
    device = torch.device(device)
    use_full_f32_matmuls()
    robot = Robot.from_urdf_file(asset_path(UR3E[0]), *UR3E[1:],
                                 dtype=engine_dtype(device), device=device)
    a = robot.num_positions()
    lo, hi = robot.joint_limits()
    d = draws(np.random.default_rng(0), lo, hi, a, sizes)
    q = torch.tensor(d["q"], dtype=robot.dtype, device=device)
    tr, tt = robot.fk_batch(d["qt"])
    ops = soa_ops(robot)
    v_max = np.ones((sizes.diff_ik, a))
    cfg = SolverConfig(**IK_CONFIG)
    b = sizes.ik
    results: Dict[str, Tuple[float, int]] = {
        "fk": (timeit(ops["fk"], q, n=n), sizes.lanes),
        "objective": (timeit(ops["objective"], q, tr, tt, n=n), sizes.lanes),
        "gradient": (timeit(ops["gradient"], q, tr, tt, n=n), sizes.lanes),
        "joint_jacobian": (timeit(robot.jacobian_batch, q, n=n),
                           sizes.lanes),
        "diff_ik": (timeit(lambda: robot.diff_ik_batch(
            d["x0"], d["v_we"], v_max, rescue=False), n=n_solve),
            sizes.diff_ik),
        "ik": (timeit(lambda: robot.ik_batch(
            cfg, tr[:b], tt[:b], q[:b], validate_seeds=False,
            rescue_overflow=False), n=n_solve), b),
    }
    dev = device_fields(device)
    rows = []
    for name, (dt, lanes) in results.items():
        rows.append({"metric": f"{name}_ops_per_s",
                     "value": round(lanes / dt, 1), "unit": "ops/s",
                     "batch": lanes, "ms_per_batch": round(dt * 1e3, 3),
                     **dev})
        if emit is not None:
            emit(rows[-1])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.device, emit=lambda row: print(json.dumps(row), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
