#!/usr/bin/env python3
"""Success-rate parity: the kernel path against the native twin on an
identical reachable-pose set.

The counterpart of ``benchmarks/parity_native.py``, with its methodology
(the reference's own, ``examples/example.py:19-47``): random reachable Panda
targets (FK of uniform configurations), uniform seeds, ``default_rng(42)``,
``SolverConfig(max_restarts=64, seed_batch=8, max_iters=32, tol_f=1e-6)``,
``N_BATCHES`` batches of 16,384 poses (6 by default: 98,304), each pose
solved twice with the same budget:

  * kernel path: ``Robot.ik_batch`` on the card, which runs the Hopper
    kernel (``lm_solve``, f32, the single-shot schedule; the port has no
    cascade, so the JAX script's ``pallas-cascade`` solver is this one);
  * native path: ``native.HostChain.ik`` per pose on the host CPU
    (``optik_host.cpp``: damped Gauss-Newton with random restarts from its
    own stream, the reference's architecture).

Prints one JSON line with both success rates and the failure overlap:
``both_fail`` poses are genuinely hard; ``kernel_only_fail`` is the kernel
path's convergence loss against a reference-style solver.  The card's name
and power limit and the host CPU model stand beside the wall times.

    python3 -m optik_tpu_torch.benchmarks.parity_native [N_BATCHES] \\
        [--device cuda|cpu]

``--device cpu`` runs the engine column on the plain torch loop at f64
(the JAX package's f64 XLA path is its counterpart there).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .. import Robot, SolverConfig
from ..models import asset_path
from ..native import HostChain
from ..solver.ik import IKResult
from .timing import card_line, engine_dtype, host_cpu

B = 16384
N_BATCHES = 6
CONFIG = dict(max_restarts=64, seed_batch=8, max_iters=32, tol_f=1e-6)
PANDA = ("panda.urdf", "panda_link0", "panda_hand_tcp")


def solver_name(robot: Robot) -> str:
    return "lm_solve" if robot.device.type == "cuda" else "plain"


def device_label(device: torch.device) -> dict:
    """What ran the engine column: the card's name and power limit
    (nvidia-smi) or the CPU, and the host CPU the native column ran on."""
    if torch.device(device).type == "cuda":
        return {"device": torch.cuda.get_device_name(0), "card": card_line(),
                "host_cpu": host_cpu()}
    return {"device": "cpu", "host_cpu": host_cpu()}


def overlap(a_found: np.ndarray, b_found: np.ndarray) -> Tuple[int, int, int]:
    """(both fail, only a fails, only b fails) over identical poses."""
    return (int(np.sum(~a_found & ~b_found)), int(np.sum(~a_found & b_found)),
            int(np.sum(a_found & ~b_found)))


class Batch(NamedTuple):
    """One engine batch: its result and the targets it solved."""

    res: IKResult
    tgt_r: torch.Tensor
    tgt_t: torch.Tensor


def engine_column(robot: Robot, cfg: SolverConfig, q_tgt: np.ndarray,
                  x0: np.ndarray) -> Tuple[np.ndarray, List[Batch], float]:
    """``Robot.ik_batch`` in batches of ``B`` on the robot's device, targets
    from its own ``fk_batch``: (found (N,), batches, wall seconds)."""
    n = q_tgt.shape[0]
    found = np.zeros(n, dtype=bool)
    batches = []
    t0 = time.perf_counter()
    for i in range(0, n, B):
        sl = slice(i, i + B)
        tr, tt = robot.fk_batch(q_tgt[sl])
        res = robot.ik_batch(cfg, tr, tt, x0[sl], validate_seeds=False)
        found[sl] = res.found.cpu().numpy()
        batches.append(Batch(res, tr, tt))
    return found, batches, time.perf_counter() - t0


def native_column(chain: HostChain, targets: np.ndarray, x0: np.ndarray,
                  cfg: SolverConfig) -> Tuple[np.ndarray, float]:
    """``HostChain.ik`` per pose on (N, 4, 4) f64 targets with the config's
    budget: (found (N,), wall seconds)."""
    found = np.zeros(x0.shape[0], dtype=bool)
    t0 = time.perf_counter()
    for i in range(x0.shape[0]):
        found[i] = chain.ik(targets[i], x0[i], tol_f=cfg.tol_f,
                            max_iters=cfg.max_iters,
                            max_restarts=cfg.total_restarts) is not None
    return found, time.perf_counter() - t0


def run(robot: Robot, chain: HostChain, n_poses: int
        ) -> Tuple[dict, List[Batch]]:
    """Both columns on ``n_poses`` poses: (the JSON summary, the engine's
    batches)."""
    cfg = SolverConfig(**CONFIG)
    rng = np.random.default_rng(42)  # bench.py's methodology and seed
    lo, hi = robot.joint_limits()
    q_tgt = rng.uniform(lo, hi, size=(n_poses, 7))
    x0 = rng.uniform(lo, hi, size=(n_poses, 7))
    k_found, batches, t_kernel = engine_column(robot, cfg, q_tgt, x0)
    # The native twin's targets from its own FK, as the engine's from its.
    n_found, t_native = native_column(
        chain, np.stack([chain.fk(q) for q in q_tgt]), x0, cfg)
    both, k_only, n_only = overlap(k_found, n_found)
    summary = {
        "metric": "panda_success_parity",
        "n_poses": n_poses,
        "kernel_success_rate": float(k_found.mean()),
        "native_success_rate": float(n_found.mean()),
        "both_fail": both,
        "kernel_only_fail": k_only,
        "native_only_fail": n_only,
        "kernel_solver": solver_name(robot),
        "kernel_wall_s": t_kernel,
        "native_wall_s": t_native,
        "budget": {"max_restarts": cfg.total_restarts,
                   "seed_batch": cfg.seed_batch,
                   "max_iters": cfg.max_iters, "tol_f": cfg.tol_f},
        **device_label(robot.device),
    }
    return summary, batches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_batches", nargs="?", type=int, default=N_BATCHES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("parity_native: no NVIDIA card; pass --device cpu for the "
              "plain loop", file=sys.stderr)
        return 2
    robot = Robot.from_urdf_file(asset_path(PANDA[0]), *PANDA[1:],
                                 dtype=engine_dtype(device), device=device)
    chain = HostChain.from_urdf_file(asset_path(PANDA[0]), *PANDA[1:])
    summary, _ = run(robot, chain, args.n_batches * B)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
