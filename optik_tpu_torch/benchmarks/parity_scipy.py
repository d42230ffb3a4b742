#!/usr/bin/env python3
"""Success-rate parity against an independent solver: scipy's SLSQP.

The counterpart of ``benchmarks/parity_scipy.py``.  SLSQP (Kraft's, the
algorithm family of the NLopt solver the reference consumes) minimises the
engine's own objective and analytic gradient (``ops/objective.py``, f64 on
the host CPU) from random restarts, and the engine solves the same poses:

  * random reachable Panda targets (FK of uniform configurations), uniform
    seeds, ``default_rng(42)``, ``tol_f = 1e-6``;
  * up to 64 restarts: restart 0 from the caller's seed, restart i > 0 from
    row i of the engine's restart stream (:func:`restart_table`, bitwise the
    JAX package's ``fold_in`` draws), so both solvers see the same seeds;
  * Speed semantics: a pose stops at its first success.

The engine column is ``Robot.ik_batch`` on the card (the Hopper kernel,
f32), or the plain loop at f64 with ``--device cpu``.  Prints one JSON line.

    OPTIK_PARITY_N=2000 python3 -m optik_tpu_torch.benchmarks.parity_scipy \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

from .. import Robot, SolverConfig
from .. import random as rnd
from ..models import ChainSpec, asset_path
from ..ops import kinematics as K
from ..ops import objective as O
from .parity_native import PANDA, device_label, engine_dtype, solver_name

R = 64
TOL = 1e-6
N_DEFAULT = 2000


def restart_table(cfg: SolverConfig, spec: ChainSpec) -> np.ndarray:
    """(R, A) f64 restart seeds: row i is the engine's draw for restart i
    (``fold_in(PRNGKey(rng_seed), i)``, bitwise ``jax.random``'s)."""
    return rnd.seed_table(cfg.rng_seed, cfg.total_restarts, spec.lower,
                          spec.upper, np.float64)


def targets_f64(spec: ChainSpec, q: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """FK of ``q`` (N, A) at f64 on the host CPU: (N, 3, 3), (N, 3)."""
    r, t = Robot(spec, dtype=torch.float64, device="cpu").fk_batch(q)
    return r.numpy(), t.numpy()


def objective(spec: ChainSpec):
    """``f_and_g(q, tgt_r, tgt_t) -> (cost, gradient)`` at f64 on the CPU,
    the engine's cost and closed-form gradient (numpy in, numpy out)."""
    params = K.ChainParams.from_spec(spec, torch.float64, "cpu")

    def f_and_g(q, tgt_r, tgt_t):
        r, j = O.residual_and_jacobian(
            params, torch.from_numpy(np.asarray(q, np.float64)),
            torch.from_numpy(tgt_r), torch.from_numpy(tgt_t))
        return float(r @ r), (2.0 * r @ j).numpy()

    return f_and_g


def slsqp_column(spec: ChainSpec, tgt_r: np.ndarray, tgt_t: np.ndarray,
                 x0s: np.ndarray, table: np.ndarray, restarts: int,
                 maxiter: int, tol_f: float
                 ) -> Tuple[np.ndarray, List[int], int, float]:
    """SLSQP from up to ``restarts`` seeds per pose, Speed semantics:
    (found (N,), restarts each success took, SLSQP iterations in all, wall
    seconds).  Raises ImportError where scipy is not installed."""
    from scipy.optimize import minimize

    f_and_g = objective(spec)
    bounds = list(zip(spec.lower, spec.upper))
    found = np.zeros(x0s.shape[0], dtype=bool)
    used, nit = [], 0
    t0 = time.perf_counter()
    for i in range(x0s.shape[0]):
        tr, tt = tgt_r[i], tgt_t[i]

        def fun(q, tr=tr, tt=tt):
            return f_and_g(q, tr, tt)

        for r_i in range(restarts):
            x = x0s[i] if r_i == 0 else table[r_i]
            res = minimize(fun, x, jac=True, method="SLSQP", bounds=bounds,
                           options={"maxiter": maxiter, "ftol": 1e-12})
            nit += res.nit
            if res.fun <= tol_f:
                found[i] = True
                used.append(r_i + 1)
                break
    return found, used, nit, time.perf_counter() - t0


def engine_found(robot: Robot, cfg: SolverConfig, tgt_r: np.ndarray,
                 tgt_t: np.ndarray, x0s: np.ndarray):
    """``Robot.ik_batch`` on the robot's device over f64 targets made on the
    host: (IKResult, found (N,) numpy, wall seconds)."""
    dt, dev = robot.dtype, robot.device
    tr = torch.tensor(tgt_r, dtype=dt, device=dev)
    tt = torch.tensor(tgt_t, dtype=dt, device=dev)
    x0 = torch.tensor(x0s, dtype=dt, device=dev)
    t0 = time.perf_counter()
    res = robot.ik_batch(cfg, tr, tt, x0, validate_seeds=False)
    found = res.found.cpu().numpy()
    return res, found, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("parity_scipy: no NVIDIA card; pass --device cpu for the "
              "plain loop", file=sys.stderr)
        return 2
    robot = Robot.from_urdf_file(asset_path(PANDA[0]), *PANDA[1:],
                                 dtype=engine_dtype(device), device=device)
    spec = robot.spec
    n = int(os.environ.get("OPTIK_PARITY_N", N_DEFAULT))
    rng = np.random.default_rng(42)
    lo, hi = robot.joint_limits()
    q_tgt = rng.uniform(lo, hi, size=(n, spec.num_positions))
    x0s = rng.uniform(lo, hi, size=(n, spec.num_positions))
    cfg = SolverConfig(max_restarts=R, seed_batch=8, max_iters=32, tol_f=TOL)
    tgt_r, tgt_t = targets_f64(spec, q_tgt)

    sci_found, used, nit, sci_s = slsqp_column(
        spec, tgt_r, tgt_t, x0s, restart_table(cfg, spec), R, 100, TOL)
    _, eng_found, eng_s = engine_found(robot, cfg, tgt_r, tgt_t, x0s)
    print(json.dumps({
        "metric": "success_parity_vs_scipy_slsqp",
        "poses": n,
        "tol_f": TOL,
        "restarts": R,
        "scipy_slsqp_success": float(sci_found.mean()),
        "engine_success": float(eng_found.mean()),
        "scipy_mean_restarts_to_success":
            float(np.mean(used)) if used else None,
        "scipy_iterations": nit,
        "scipy_wall_s": sci_s,
        "scipy_solves_per_s": n / sci_s,
        "engine_solver": solver_name(robot),
        "engine_wall_s": eng_s,
        **device_label(device),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
