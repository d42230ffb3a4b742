#!/usr/bin/env python3
"""North-star benchmark: Panda 7-DoF IK solves/s on one NVIDIA card.

The counterpart of the root ``bench.py`` (the JAX package's), with its
workload and protocol:

  * the Panda (``panda.urdf``, ``panda_link0`` -> ``panda_hand_tcp``),
    float32, ``SolverConfig(max_restarts=64, seed_batch=8, max_iters=32,
    tol_f=1e-6)``, B = ``OPTIK_BENCH_B`` (131,072) random reachable targets
    (FK of uniform configurations) and uniform seeds from
    ``default_rng(42)``, per batch the targets' configurations drawn first,
    then the seeds;
  * every call ``Robot.ik_batch(..., validate_seeds=False,
    rescue_overflow=False)``: on the card the Hopper kernel
    (``csrc/lm_kernel.cu``);
  * ``OPTIK_BENCH_SETS`` (5) sets of ``OPTIK_BENCH_ITERS`` (3) fresh
    batches; each set a cold touch of every batch and a steady pass with
    one sync per batch, then two warm pipelined passes and one timed one,
    which chains the set ``OPTIK_BENCH_PIPE_REPS`` (32) times and adds
    ``IKResult.found_count`` on the device, with one fetch at the end.  The
    headline is B over the median of the sets' pipelined ms per batch;
    ``spread`` is (max - min) / median over those, and above 0.1 the
    environment moved (``spread_alert``).

    python3 -m optik_tpu_torch.benchmarks.bench [--device cuda|cpu]

prints one JSON line, ``"metric": "panda_ik_solves_per_s"``.  It runs on the
card; without one the default device raises, and ``--device cpu`` runs the
plain torch loop at float64 instead (a row that says ``"device": "cpu"`` and
carries no roofline share).  ``OPTIK_PROFILE=<dir>`` writes a
``torch.profiler`` trace of the timed sets there.

``vs_baseline`` is the value over BASELINE.json's target of 1e6 solves/s,
the whole target on one card (the JAX script divides it by the 8 chips of
a v5p-8).  The roofline fields come from ``utils/roofline.py``: FP32
operations per lane-iteration counted on the robot's chain, the H100's
published FP32 peak and memory rate, and ``bound_ms``, the least time the
card could take for a batch.  ``IKResult.lane_iters`` on the card counts,
per pose, the iterations its thread group ran times its lanes
(``lm_kernel.launch_lanes``).  In Speed mode a pose's lanes stop together,
so that is the work the inputs need (91.1 lane-iterations per solve in
PERF.md §5), not the warp slots the card executed (97.1: a warp waits for
its slowest pose group); ``fp32_util`` and ``bound_ms`` count the former,
and the packing loss shows as time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from .. import Robot, SolverConfig
from ..models import asset_path
from ..ops.cuda import lm_kernel
from ..utils import roofline
from .timing import device_fields, engine_dtype

TARGET = 1e6  # BASELINE.json: solves/s
PANDA = ("panda.urdf", "panda_link0", "panda_hand_tcp")
CONFIG = dict(max_restarts=64, seed_batch=8, max_iters=32, tol_f=1e-6)
B = 131072
SETS = 5
ITERS = 3
PIPE_REPS = 32


def panda(device) -> Robot:
    return Robot.from_urdf_file(asset_path(PANDA[0]), *PANDA[1:],
                                dtype=engine_dtype(device), device=device)


def problem(robot: Robot, q_tgt: np.ndarray, x0: np.ndarray):
    """(tgt_r, tgt_t, x0) on the robot's device: targets are its own FK of
    ``q_tgt``, the seeds ``x0`` cast to its dtype (the JAX scripts' float32
    cast of their float64 draws, on the card)."""
    tr, tt = robot.fk_batch(q_tgt)
    return tr, tt, torch.tensor(x0, dtype=robot.dtype, device=robot.device)


def make_batch(robot: Robot, rng: np.random.Generator, b: int):
    """One batch in the JAX script's draw order: the targets'
    configurations, then the seeds."""
    lo, hi = robot.joint_limits()
    n = robot.num_positions()
    q_tgt = rng.uniform(lo, hi, size=(b, n))
    return problem(robot, q_tgt, rng.uniform(lo, hi, size=(b, n)))


def ik_batch_bytes(b: int, a: int, r: int) -> int:
    """Bytes one ``ik_batch`` call must move: targets, seeds and the
    restart table read once; found, x, cost and iterations written once
    (float32, int8 and int32)."""
    return 4 * (12 * b + a * b + r * a) + b * (1 + 4 * a + 4 + 4)


def run(device="cuda", *, b: int = B, sets: int = SETS, iters: int = ITERS,
        reps: int = PIPE_REPS, profile_dir=None) -> dict:
    """The benchmark; returns its JSON row."""
    device = torch.device(device)
    robot = panda(device)
    cfg = SolverConfig(**CONFIG)
    rng = np.random.default_rng(42)

    def solve(tr, tt, x0):
        return robot.ik_batch(cfg, tr, tt, x0, validate_seeds=False,
                              rescue_overflow=False)

    tr, tt, x0 = make_batch(robot, rng, b)
    res = solve(tr, tt, x0)
    int(res.found_count)
    on_kernel = robot._batch_solver(cfg, None)[0]

    prof = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)

    counts, work, lat, lat_cold = [], [], [], []
    set_medians, set_pipe = [], []
    launches0 = lm_kernel.LAUNCHES
    with prof:
        for _ in range(sets):
            batches = [make_batch(robot, rng, b) for _ in range(iters)]
            for batch in batches:  # cold: the first touch of each batch
                t1 = time.perf_counter()
                res = solve(*batch)
                counts.append(int(res.found_count))
                work.append(int(res.lane_iters))
                lat_cold.append(time.perf_counter() - t1)
            set_lat = []
            for batch in batches:  # steady, one sync per batch
                t1 = time.perf_counter()
                res = solve(*batch)
                int(res.found_count)
                set_lat.append(time.perf_counter() - t1)
            set_medians.append(float(np.median(set_lat)))
            lat.extend(set_lat)

            def pipe_pass():
                t1 = time.perf_counter()
                acc = None
                for _ in range(reps):
                    for batch in batches:
                        c = solve(*batch).found_count
                        acc = c if acc is None else acc + c
                int(acc)  # the one fetch: the sync point
                return (time.perf_counter() - t1) / (iters * reps)

            pipe_pass()
            pipe_pass()
            set_pipe.append(pipe_pass())
    launches = lm_kernel.LAUNCHES - launches0
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "bench.json"))

    found = int(np.sum(counts))
    p50 = float(np.median(set_medians))
    p50_pipe = float(np.median(set_pipe))
    solves_per_s = b / p50_pipe
    spread = float((np.max(set_pipe) - np.min(set_pipe)) / p50_pipe)
    success = found / (b * iters * sets)

    nb = int(cfg.max_iters) + 2
    hist = torch.bincount(torch.where(res.found, res.iters, 0).long(),
                          minlength=nb)[1:nb].cpu().numpy()
    hist = {str(i + 1): int(v) for i, v in enumerate(hist) if v}

    li = float(np.median(work))
    flops = roofline.lane_iter_cost(robot.spec, cfg)["flops"]
    roof = {"flops_per_lane_iter": flops, "lane_iters_p50": li,
            "lane_iters_per_solve": round(li / b, 1)}
    dev = device_fields(device)
    if device.type == "cuda":
        roof.update(roofline.utilization(li, p50_pipe, flops, dev["device"]))
        bound, bound_by = roofline.bound_ms(
            flops * li, ik_batch_bytes(b, robot.num_positions(),
                                       cfg.total_restarts), dev["device"])
        roof.update(bound_ms=bound, bound_by=bound_by)

    out = {
        "metric": "panda_ik_solves_per_s",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / TARGET, 4),
        "success_rate": round(success, 4),
        "spread": round(spread, 4),
        "spread_alert": spread > 0.1,
        "synced_solves_per_s": round(b / p50, 1),
        "set_medians_ms": [round(1e3 * m, 2) for m in set_medians],
        "set_pipelined_ms": [round(1e3 * m, 2) for m in set_pipe],
        "p50_pipelined_batch_ms": round(1e3 * p50_pipe, 2),
        "p50_batch_latency_ms": round(1e3 * p50, 2),
        "p90_batch_latency_ms": round(1e3 * float(np.percentile(lat, 90)),
                                      2),
        "p50_cold_ms": round(1e3 * float(np.median(lat_cold)), 2),
        "p90_cold_ms": round(1e3 * float(np.percentile(lat_cold, 90)), 2),
        "lane_iters_spread": round(float(np.max(work) / np.min(work)), 3),
        "iters_to_converge_hist": hist,
        "batch": b,
        "seeds": cfg.seed_batch,
        "restarts": cfg.total_restarts,
        "max_iters": cfg.max_iters,
        "solver": "ik_batch/cuda-kernel" if on_kernel else "ik_batch/plain",
        "kernel_launches": launches,
        "chips": dev.pop("chips", 1),
        **dev,
    }
    out.update(roof)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    env = os.environ.get
    row = run(args.device, b=int(env("OPTIK_BENCH_B", B)),
              sets=int(env("OPTIK_BENCH_SETS", SETS)),
              iters=int(env("OPTIK_BENCH_ITERS", ITERS)),
              reps=int(env("OPTIK_BENCH_PIPE_REPS", PIPE_REPS)),
              profile_dir=env("OPTIK_PROFILE"))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
