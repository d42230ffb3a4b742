#!/usr/bin/env python3
"""The BASELINE.json configurations beyond the north-star, on one NVIDIA
card: the counterpart of ``benchmarks/bench_workloads.py``, with its
workloads, draw order (one ``default_rng(0)`` through every config) and
``metric`` names:

  2. batched random-restart IK: Panda poses x 256 seeds, Quality mode
     (64 lanes, 48 iterations: S = 64, the kernel's widest pose) at
     B = 1,024 and 4,096, ``panda_quality_256seed_solves_per_s``; then the
     B = 1,024 batch with ``quality_max_successes`` k = 8 and 2
     (``panda_quality_256seed_cap_solves_per_s``) and the seed-distance
     regression against the uncapped solve over the poses both found;
  3. the UR5 with every joint limit at +-pi/2 (a second chain, so a second
     kernel library), B = 4,096, 64 restarts, 8 lanes, 48 iterations,
     ``ur5_tight_limits_solves_per_s``;
  4. differential IK, ``Robot.diff_ik_batch(..., rescue=False)`` at
     B = 4,096 (constant command [0, 0, 0.1, 0, 0, 0], v_max 0.75), then one
     rescued call for ``ok_rate_rescued``, ``diff_ik_steps_per_s``;
  5. motion planning: ``OPTIK_MP_CHUNKS`` chunks of ``OPTIK_MP_CHUNK``
     (65,536) poses at the north-star config, one cold sweep and three
     steady sweeps, each adding ``found_count`` on the device with one
     fetch at the end, ``motion_planning_solves_per_s``.

Rows 2-4 time ``depth`` chained calls with one sync, in ``sets`` passes
(``timing.timed_piped``), and one synced call beside them.

    python3 -m optik_tpu_torch.benchmarks.bench_workloads [--device cuda|cpu]

prints one JSON line per row.  Without a card the default device raises;
``--device cpu`` runs the plain torch paths at float64.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .. import Robot, SolverConfig
from ..models import ChainSpec, asset_path
from . import bench
from .bench import problem
from .parity_hard import UR5, tight_ur5
from .timing import device_fields, engine_dtype, sync, timed, timed_piped

QUALITY = dict(max_restarts=256, seed_batch=64, max_iters=48)
UR5_CONFIG = dict(max_restarts=64, seed_batch=8, max_iters=48)
MP_CONFIG = dict(max_restarts=64, seed_batch=8, max_iters=32)
V_WE = (0.0, 0.0, 0.1, 0.0, 0.0, 0.0)
V_MAX = 0.75
TIGHT = np.pi / 2


class Sizes(NamedTuple):
    quality: Tuple[int, ...] = (1024, 4096)
    caps: Tuple[int, ...] = (8, 2)
    ur5: int = 4096
    diff_ik: int = 4096
    mp_chunk: int = 65536
    mp_chunks: int = 4


def default_sizes() -> Sizes:
    """The JAX script's sizes, with its ``OPTIK_MP_CHUNK`` and
    ``OPTIK_MP_CHUNKS`` (default: at least 4 chunks, 131,072 poses)."""
    chunk = int(os.environ.get("OPTIK_MP_CHUNK", 65536))
    n = int(os.environ.get("OPTIK_MP_CHUNKS", max(4, 131072 // chunk)))
    return Sizes(mp_chunk=chunk, mp_chunks=n)


def draws(rng: np.random.Generator, lo, hi, sizes: Sizes) -> dict:
    """Every array the JAX script draws, in its order (float64): per Quality
    batch the targets' configurations and the seeds; the UR5's; the diff-IK
    start configurations; the motion-planning warm-up chunk and then each
    chunk's."""
    out = {"quality": [], "mp": []}
    for b in sizes.quality:
        out["quality"].append((rng.uniform(lo, hi, size=(b, 7)),
                               rng.uniform(lo, hi, size=(b, 7))))
    out["ur5"] = (rng.uniform(-TIGHT, TIGHT, size=(sizes.ur5, 6)),
                  rng.uniform(-TIGHT, TIGHT, size=(sizes.ur5, 6)))
    out["diff_ik"] = rng.uniform(lo, hi, size=(sizes.diff_ik, 7))
    for _ in range(1 + sizes.mp_chunks):
        out["mp"].append((rng.uniform(lo, hi, size=(sizes.mp_chunk, 7)),
                          rng.uniform(lo, hi, size=(sizes.mp_chunk, 7))))
    return out


def rate(n: int, seconds: float) -> float:
    return round(n / seconds, 1)


def quality_rows(panda: Robot, batches, caps, depth, sets, dev) -> List[dict]:
    cfg_q = SolverConfig.create("quality", **QUALITY)
    rows, first = [], None
    for q_tgt, x0_np in batches:
        b = q_tgt.shape[0]
        tr, tt, x0 = problem(panda, q_tgt, x0_np)

        def solve(cfg=cfg_q):
            return panda.ik_batch(cfg, tr, tt, x0, validate_seeds=False)

        res, dt, spread, sets_ms = timed_piped(solve, depth, sets)
        _, dt_sync = timed(solve)
        rows.append({
            "metric": "panda_quality_256seed_solves_per_s",
            "value": rate(b, dt), "unit": "solves/s",
            "spread": round(spread, 4), "set_ms": sets_ms,
            "synced_solves_per_s": rate(b, dt_sync),
            "success_rate": round(float(res.found.double().mean()), 4),
            "lane_iters_per_solve": round(float(res.lane_iters) / b, 1),
            "batch": b, "seeds": 256, **dev})
        if first is None:
            first = (b, tr, tt, x0, res, dt)
    # The first batch under the success cap: the speedup against the full
    # budget and the seed-distance regression over the poses both found.
    b, tr, tt, x0, res, dt = first
    d_full = torch.linalg.norm(res.x - x0, dim=-1)
    for k in caps:
        cfg_k = cfg_q.replace(quality_max_successes=k)
        res_k, dt_k = timed(lambda: panda.ik_batch(
            cfg_k, tr, tt, x0, validate_seeds=False))
        both = res.found & res_k.found
        dreg = (torch.linalg.norm(res_k.x - x0, dim=-1) - d_full)[both]
        rows.append({
            "metric": "panda_quality_256seed_cap_solves_per_s",
            "cap": k, "value": rate(b, dt_k), "unit": "solves/s",
            "speedup_vs_full": round(dt / dt_k, 3),
            "success_rate": round(float(res_k.found.double().mean()), 4),
            "seed_dist_regression_mean": round(float(dreg.mean()), 4),
            "seed_dist_regression_max": round(float(dreg.max()), 4),
            "batch": b, "seeds": 256, **dev})
    return rows


def ur5_row(device, q_tgt, x0_np, depth, sets, dev) -> dict:
    spec = tight_ur5(ChainSpec.from_urdf_file(asset_path(UR5[0]), *UR5[1:]))
    ur5 = Robot(spec, dtype=engine_dtype(device), device=device)
    b = q_tgt.shape[0]
    tr, tt, x0 = problem(ur5, q_tgt, x0_np)
    cfg = SolverConfig(**UR5_CONFIG)

    def solve():
        return ur5.ik_batch(cfg, tr, tt, x0, validate_seeds=False,
                            rescue_overflow=False)

    res, dt, spread, sets_ms = timed_piped(solve, depth, sets)
    _, dt_sync = timed(solve)
    return {"metric": "ur5_tight_limits_solves_per_s",
            "value": rate(b, dt), "unit": "solves/s",
            "spread": round(spread, 4), "set_ms": sets_ms,
            "synced_solves_per_s": rate(b, dt_sync),
            "success_rate": round(float(res.found.double().mean()), 4),
            "batch": b, **dev}


def diff_ik_inputs(robot: Robot, x0_np: np.ndarray):
    """(x0, V_WE, v_max) on the robot's device: the drawn start
    configurations, the constant command and the constant limit."""
    b = x0_np.shape[0]

    def t(a):
        return torch.tensor(a, dtype=robot.dtype, device=robot.device)

    return (t(x0_np), t(np.tile(np.array(V_WE), (b, 1))),
            t(np.full((b, 7), V_MAX)))


def diff_ik_row(panda: Robot, x0_np, depth, sets, dev) -> dict:
    b = x0_np.shape[0]
    x0, v_we, v_max = diff_ik_inputs(panda, x0_np)

    def step():
        return panda.diff_ik_batch(x0, v_we, v_max, rescue=False)

    res, dt, spread, sets_ms = timed_piped(step, depth, sets)
    _, dt_sync = timed(step)
    rescued = panda.diff_ik_batch(x0, v_we, v_max)
    return {"metric": "diff_ik_steps_per_s",
            "value": rate(b, dt), "unit": "steps/s",
            "spread": round(spread, 4), "set_ms": sets_ms,
            "synced_steps_per_s": rate(b, dt_sync),
            "ok_rate": round(float(res[2].double().mean()), 4),
            "ok_rate_rescued": round(float(rescued[2].double().mean()), 4),
            "batch": b, **dev}


def motion_planning_row(panda: Robot, chunks, dev) -> dict:
    cfg = SolverConfig(**MP_CONFIG)

    def solve(tr, tt, x0):
        return panda.ik_batch(cfg, tr, tt, x0, validate_seeds=False,
                              rescue_overflow=False)

    sync(solve(*problem(panda, *chunks[0])))  # warm
    inputs = [problem(panda, *c) for c in chunks[1:]]
    for t in inputs:
        sync(t)

    def sweep():
        t0 = time.perf_counter()
        count = torch.zeros((), dtype=torch.int64, device=panda.device)
        for tr, tt, x0 in inputs:
            count = count + solve(tr, tt, x0).found_count
        found = int(count)  # the one fetch: the sync point
        return found, time.perf_counter() - t0

    _, dt_cold = sweep()
    sweeps = sorted(sweep()[1] for _ in range(3))
    found, _ = sweep()
    dt = sweeps[1]
    n = sum(t[2].shape[0] for t in inputs)
    return {"metric": "motion_planning_solves_per_s",
            "value": rate(n, dt), "unit": "solves/s",
            "spread": round((sweeps[-1] - sweeps[0]) / dt, 4),
            "set_s": [round(v, 6) for v in sweeps],
            "cold_sweep_solves_per_s": rate(n, dt_cold),
            "success_rate": round(found / n, 4), "poses": n, **dev}


def run(device="cuda", sizes: Sizes = None, *, depth: int = 8,
        sets: int = 3, emit=None) -> List[dict]:
    """Every row in the JAX script's order; ``emit`` is called with each
    row as it is made."""
    device = torch.device(device)
    sizes = sizes or default_sizes()
    panda = bench.panda(device)
    lo, hi = panda.joint_limits()
    d = draws(np.random.default_rng(0), lo, hi, sizes)
    dev = device_fields(device)
    out = []

    def add(new):
        for row in new:
            out.append(row)
            if emit is not None:
                emit(row)

    add(quality_rows(panda, d["quality"], sizes.caps, depth, sets, dev))
    add([ur5_row(device, *d["ur5"], depth, sets, dev)])
    add([diff_ik_row(panda, d["diff_ik"], depth, sets, dev)])
    add([motion_planning_row(panda, d["mp"], dev)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.device, emit=lambda row: print(json.dumps(row), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
