#!/usr/bin/env python3
"""Hard-pose success parity: engine against the native twin against scipy's
SLSQP, on pose sets and budgets where success separates.

The counterpart of ``benchmarks/parity_hard.py``, on the same arrays from
the same seed (:func:`pose_sets`, ``default_rng(42)``):

  pose sets
    * panda_uniform - uniform-in-limits targets;
    * panda_normal  - target configurations mid + 0.75 * halfwidth * N(0, 1),
                      clipped: mass near the joint limits;
    * ur5_tight     - the UR5 with every limit at +-pi/2 (BASELINE config
                      3's robot).

  budgets (restart seeds from the engine's stream)
    * weak    8 restarts;  engine 8 LM iterations, SLSQP maxiter 30,
              plus the engine at 32 iterations on the same restarts;
    * strong 64 restarts;  engine 32 LM iterations, SLSQP maxiter 100.

Columns: the engine (``Robot.ik_batch`` on the card: the Hopper kernel built
for each chain, f32; the UR5's tight limits are run-time data of its
library), the native twin (``native.HostChain``, its own restart stream; the
UR5's from a URDF with the tight limits) and SLSQP on the host CPU over the
engine's f64 objective (``parity_scipy``; left out where scipy does not
import).  Per cell one JSON line: the rates and the failure-overlap buckets.
Targets are FK at f64 on the host, shared by every column.

The engine draws its restart seeds at its own precision (``random.py``,
bitwise ``jax.random.uniform`` at that dtype): float32 on the card, as the
JAX package's f32 kernel does, float64 on the CPU, as its f64 XLA path does.
The two draws are different configurations, and every pose shares the same
seven, so the weak cells' rates differ between the two by far more than
rounding; the strong budget's 63 draws leave the rates within a few poses.

    OPTIK_PARITY_N=10000 OPTIK_PARITY_SETS=panda_uniform,ur5_tight \\
    OPTIK_PARITY_BUDGETS=weak,strong \\
        python3 -m optik_tpu_torch.benchmarks.parity_hard [--device cuda|cpu]

The SLSQP column is CPU time (hours at N = 10,000); ``chip_smoke.py`` runs
the other two through :func:`run` with ``scipy_column=False``.
``--device cpu`` runs the engine on the plain loop at f64, the counterpart
of the JAX script's f64 XLA engine.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import xml.etree.ElementTree as ET
from typing import Dict, Tuple

import numpy as np
import torch

from .. import Robot, SolverConfig
from ..models import ChainSpec, asset_path
from ..native import HostChain
from .parity_native import (PANDA, device_label, engine_dtype, native_column,
                            overlap, solver_name)
from .parity_scipy import (engine_found, restart_table, slsqp_column,
                           targets_f64)

N_DEFAULT = 10000
BUDGETS = {
    "weak": dict(restarts=8, engine_iters=8, scipy_maxiter=30),
    "strong": dict(restarts=64, engine_iters=32, scipy_maxiter=100),
}
UR5 = ("ur5.urdf", "base_link", "ee_link")
TIGHT = np.pi / 2


def tight_ur5(spec: ChainSpec) -> ChainSpec:
    """The UR5 with every joint limit at +-pi/2."""
    a = spec.num_positions
    return dataclasses.replace(spec, lower=np.full(a, -TIGHT),
                               upper=np.full(a, TIGHT))


def tightened_ur5_xml() -> str:
    """UR5 URDF with every revolute limit clamped to +-pi/2, so the native
    twin solves the same tight-limits problem."""
    tree = ET.parse(asset_path(UR5[0]))
    for joint in tree.getroot().iter("joint"):
        if joint.get("type") != "revolute":
            continue
        lim = joint.find("limit")
        if lim is not None:
            lim.set("lower", str(-TIGHT))
            lim.set("upper", str(TIGHT))
    return ET.tostring(tree.getroot(), encoding="unicode")


def pose_sets(rng: np.random.Generator, n: int
              ) -> Dict[str, Tuple[ChainSpec, np.ndarray, np.ndarray]]:
    """name -> (chain, q_tgt (N, A), x0 (N, A)), drawn from ``rng`` in the
    JAX script's order."""
    panda = ChainSpec.from_urdf_file(asset_path(PANDA[0]), *PANDA[1:])
    lo, hi = panda.joint_limits()
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    ur5t = tight_ur5(ChainSpec.from_urdf_file(asset_path(UR5[0]), *UR5[1:]))

    out = {}
    out["panda_uniform"] = (panda, rng.uniform(lo, hi, size=(n, 7)),
                            rng.uniform(lo, hi, size=(n, 7)))
    qn = np.clip(mid + 0.75 * half * rng.standard_normal((n, 7)), lo, hi)
    out["panda_normal"] = (panda, qn, rng.uniform(lo, hi, size=(n, 7)))
    lo5, hi5 = ur5t.joint_limits()
    out["ur5_tight"] = (ur5t, rng.uniform(lo5, hi5, size=(n, 6)),
                        rng.uniform(lo5, hi5, size=(n, 6)))
    return out


def native_chain(set_name: str) -> HostChain:
    """The native twin of a set's chain."""
    if set_name == "ur5_tight":
        return HostChain.from_urdf_str(tightened_ur5_xml(), *UR5[1:])
    return HostChain.from_urdf_file(asset_path(PANDA[0]), *PANDA[1:])


def run_cell(robot: Robot, chain: HostChain, set_name: str, bname: str,
             tgt_r, tgt_t, x0s, scipy_column: bool) -> Tuple[dict, dict]:
    """One (set, budget) cell: (its JSON line, the engine results by column
    name, ``"engine"`` and, on the weak budget, ``"engine_iters32"``)."""
    bud = BUDGETS[bname]
    r_total = bud["restarts"]
    cfg = SolverConfig(max_restarts=r_total, seed_batch=8,
                       max_iters=bud["engine_iters"], tol_f=1e-6)
    n = x0s.shape[0]
    res, eng, t_eng = engine_found(robot, cfg, tgt_r, tgt_t, x0s)
    results = {"engine": res}
    # Iteration-sensitivity control: the same restarts with full 32-iteration
    # attempts separates "LM needs more iterations per attempt" from "LM
    # cannot reach this basin at all".
    eng32_rate = None
    if bud["engine_iters"] < 32:
        res32, f32_, _ = engine_found(robot, cfg.replace(max_iters=32),
                                      tgt_r, tgt_t, x0s)
        results["engine_iters32"] = res32
        eng32_rate = float(f32_.mean())
    targets = np.tile(np.eye(4), (n, 1, 1))
    targets[:, :3, :3], targets[:, :3, 3] = tgt_r, tgt_t
    nat, t_nat = native_column(chain, targets, x0s, cfg)
    both, eng_only, nat_only = overlap(eng, nat)
    line = {
        "metric": "hard_pose_parity", "set": set_name, "budget": bname,
        "poses": n, "restarts": r_total,
        "engine_iters": bud["engine_iters"],
        "scipy_maxiter": bud["scipy_maxiter"],
        "engine_success": float(eng.mean()),
        "engine_success_iters32": eng32_rate,
        "native_success": float(nat.mean()),
        "both_fail_engine_native": both,
        "engine_only_fail_vs_native": eng_only,
        "native_only_fail_vs_engine": nat_only,
        "engine_solver": solver_name(robot),
        "engine_wall_s": t_eng, "native_wall_s": t_nat,
    }
    if scipy_column and importlib.util.find_spec("scipy") is not None:
        sci, _, _, t_sci = slsqp_column(
            robot.spec, tgt_r, tgt_t, x0s, restart_table(cfg, robot.spec),
            r_total, bud["scipy_maxiter"], cfg.tol_f)
        both, eng_only, sci_only = overlap(eng, sci)
        line.update({
            "scipy_success": float(sci.mean()),
            "both_fail_engine_scipy": both,
            "engine_only_fail_vs_scipy": eng_only,
            "scipy_only_fail_vs_engine": sci_only,
            "all_three_fail": int(np.sum(~eng & ~sci & ~nat)),
            "scipy_wall_s": t_sci})
    else:
        line["scipy_success"] = None
    return line, results


def run(device, n_poses: int, sets=None, budgets=None, scipy_column=True):
    """Yield ``(line, engine results, (tgt_r, tgt_t, x0s), robot)`` per cell,
    the sets and budgets in the JAX script's order (``None``: all)."""
    device = torch.device(device)
    for set_name, (spec, q_tgt, x0s) in pose_sets(
            np.random.default_rng(42), n_poses).items():
        if sets is not None and set_name not in sets:
            continue
        robot = Robot(spec, dtype=engine_dtype(device), device=device)
        tgt_r, tgt_t = targets_f64(spec, q_tgt)
        chain = native_chain(set_name)
        for bname in BUDGETS:
            if budgets is not None and bname not in budgets:
                continue
            line, results = run_cell(robot, chain, set_name, bname, tgt_r,
                                     tgt_t, x0s, scipy_column)
            yield line, results, (tgt_r, tgt_t, x0s), robot


def _env_list(name: str):
    value = os.environ.get(name, "")
    return None if value == "" else value.split(",")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("parity_hard: no NVIDIA card; pass --device cpu for the plain "
              "loop", file=sys.stderr)
        return 2
    label = device_label(device)
    for line, _, _, _ in run(device, int(os.environ.get("OPTIK_PARITY_N",
                                                        N_DEFAULT)),
                             _env_list("OPTIK_PARITY_SETS"),
                             _env_list("OPTIK_PARITY_BUDGETS")):
        print(json.dumps({**line, **label}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
