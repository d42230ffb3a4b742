#!/usr/bin/env python3
"""Weak scaling of the sharded entry points over n cards: the counterpart of
``benchmarks/bench_scaling.py``, with its workload (the Panda, float32,
``SolverConfig(max_restarts=64, seed_batch=8, max_iters=48)``,
``default_rng(0)``, its draw order) and rows, for n in 1, 2, 4, 8, ... up to
the cards on this host:

  * ``scaling_solves_per_s``: ``mesh.ik_sharded`` (the plain loop's lanes
    partitioned over the mesh) at B = 1,024 n on a ``make_mesh(data=n,
    seed=1)``, one synced call after a warm one, 3 times;
  * ``scaling_cascade_solves_per_s``: ``mesh.build_sharded_cascade`` (the
    port has no cascade: each rank runs the single-shot kernel on its pose
    shard) at B = 4,096 n, with a ``"devices": 0`` row of the unsharded
    ``Robot.ik_batch`` on the n = 1 batch.

Every n is one ``torch.distributed`` world of n ranks on this host
(``parallel/launch.spawn``, NCCL, one card per rank); every rank builds its
targets with its own FK from the same drawn configurations.  A rate is the
batch over the slowest rank's seconds per call.  With one card only n = 1
runs: the rows then measure the mechanics and the overhead of the sharded
entries (a world of one rank and its collectives), not scaling, and say so
(``"scaling": false``).  Nothing is interpreted.

    python3 -m optik_tpu_torch.benchmarks.bench_scaling [--device cuda|cpu]

Without a card the default device raises; ``--device cpu`` runs a gloo world
of one rank on the CPU at float64.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import numpy as np
import torch

from .. import Robot, SolverConfig
from ..models import ChainSpec, asset_path
from ..ops.cuda import lm_kernel
from ..parallel import distributed, launch
from ..parallel import mesh as mesh_mod
from .bench import PANDA, problem
from .timing import device_fields, engine_dtype

CONFIG = dict(max_restarts=64, seed_batch=8, max_iters=48)
PER_RANK = 1024
PER_RANK_CASCADE = 4096
ITERS = 3
COUNTS = (1, 2, 4, 8, 16, 32)


def draws(rng: np.random.Generator, lo, hi, counts) -> dict:
    """The JAX script's draws: per n the ik_sharded batch (targets'
    configurations, seeds), then per n the cascade batch."""
    def pair(b):
        return (rng.uniform(lo, hi, size=(b, 7)),
                rng.uniform(lo, hi, size=(b, 7)))

    return {"sharded": [pair(PER_RANK * n) for n in counts],
            "cascade": [pair(PER_RANK_CASCADE * n) for n in counts]}


def _measure(solve, inputs, iters: int = ITERS):
    """One warm call, then ``iters`` calls each ending in a fetch of its
    found count: (mean host seconds per call, success rate of the last,
    kernel launches in all of them)."""
    launches0 = lm_kernel.LAUNCHES
    int(solve(*inputs).found.sum())
    t0 = time.perf_counter()
    for _ in range(iters):
        res = solve(*inputs)
        int(res.found.sum())
    dt = (time.perf_counter() - t0) / iters
    return dt, float(res.found.double().mean()), \
        lm_kernel.LAUNCHES - launches0


def rank_fn(spec, n, sharded, cascade, iters=ITERS, device=None) -> dict:
    """One rank of a world of ``n``: ik_sharded on ``sharded`` and the
    sharded single-shot path on ``cascade`` (and, at n = 1, the unsharded
    ``Robot.ik_batch`` on it), each (targets' configurations, seeds), each
    timed over ``iters`` calls.  Returns ``{entry: (seconds per call,
    success rate, launches)}``."""
    device = device or distributed.local_device()
    robot = Robot(spec, dtype=engine_dtype(device), device=device)
    cfg = SolverConfig(**CONFIG)
    mesh = mesh_mod.make_mesh(data=n, seed=1)

    out = {"sharded": _measure(
        lambda *a: mesh_mod.ik_sharded(robot, cfg, *a, mesh),
        problem(robot, *sharded), iters)}
    big = problem(robot, *cascade)
    if n == 1:
        out["unsharded"] = _measure(
            lambda *a: robot.ik_batch(cfg, *a, validate_seeds=False,
                                      rescue_overflow=False), big, iters)
    out["cascade"] = _measure(
        mesh_mod.build_sharded_cascade(robot, cfg, mesh), big, iters)
    return out


def run(device="cuda", max_ranks=None, *, iters: int = ITERS,
        emit=None) -> List[dict]:
    """Every row in the JAX script's order.  ``max_ranks`` defaults to the
    cards on this host (1 on the CPU); ``iters`` is the timed calls per
    entry after the warm one."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench_scaling: torch.cuda.is_available() is "
                               "False; pass device='cpu'")
        max_ranks = max_ranks or torch.cuda.device_count()
        backend, rank_device = "nccl", None
    else:
        max_ranks = max_ranks or 1
        backend, rank_device = "gloo", "cpu"
    spec = ChainSpec.from_urdf_file(asset_path(PANDA[0]), *PANDA[1:])
    lo, hi = spec.joint_limits()
    counts = [n for n in COUNTS if n <= max_ranks]
    d = draws(np.random.default_rng(0), lo, hi, counts)
    dev = device_fields(device)
    per_n = {}
    for i, n in enumerate(counts):
        ranks = launch.spawn(rank_fn, n, spec, n, d["sharded"][i],
                             d["cascade"][i], iters, rank_device,
                             backend=backend, timeout=900)
        # The slowest rank's time is the call's; rank 0's rate and count.
        per_n[n] = {key: (max(r[key][0] for r in ranks), *ranks[0][key][1:])
                    for key in ranks[0]}
    rows = []

    def add(metric, n, b, key):
        dt, success, launches = per_n[max(n, 1)][key]
        rate = b / dt
        base_rate = b / n / per_n[1][key][0] if n else None
        rows.append({
            "metric": metric, "devices": n, "value": round(rate, 1),
            "unit": "solves/s",
            "efficiency": None if n == 0 else round(rate / (base_rate * n),
                                                    3),
            "success_rate": round(success, 4), "batch": b,
            "kernel_launches": launches, "scaling": len(counts) > 1, **dev})
        if emit is not None:
            emit(rows[-1])

    for n in counts:
        add("scaling_solves_per_s", n, PER_RANK * n, "sharded")
    for n in counts:
        if n == 1:
            add("scaling_cascade_solves_per_s", 0, PER_RANK_CASCADE,
                "unsharded")
        add("scaling_cascade_solves_per_s", n, PER_RANK_CASCADE * n,
            "cascade")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.device, emit=lambda row: print(json.dumps(row), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
