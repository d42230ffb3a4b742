"""Count the lane-iterations per solve that a Quality cell's inputs need.

    python3 -m ikbench.workcount.lane_iters_quality \
        --workload panda7_quality.nearest-stream --seeds 1 2 3 --poses 4096

For each seed, the first ``--poses`` poses of the first batch a run of
that seed makes go through the reference's Quality schedule in float64
(``reference/quality.py``).  Every restart of the budget runs to its end,
so the work the answer needs is the iterations each lane spends inside
its attempts (``busy_iters``): ``lane_iters_per_solve``, whose mean over
the seeds the cell's file freezes.  ``held_iters_per_solve`` beside it is
the schedule's lockstep count (per pose, S times the iterations until the
last lane has spent its restarts, as ``lane_iters.py`` counts Speed's); it
adds the slots where a lane whose attempts ended early waits for the
pose's slowest lane, which the answer does not need.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import harness
from ..drivers import common
from ..reference import quality


def count(workload: str, seed: int, poses: int, device) -> dict:
    ctx = harness.context(workload, seed, 1.0, False, str(device), 0.0,
                          {"batch": poses, "pool": 1})
    chain = common.chain_of(ctx)
    g = common.generator(seed, device)
    tgt_r, tgt_t, x0 = common.ik_inputs(chain, g, poses, device)
    ans = quality.ik_answers(chain, ctx.config["solver"], tgt_r, tgt_t, x0,
                             torch.float64)
    return {"seed": seed, "poses": poses,
            "lane_iters_per_solve": ans.busy_iters / poses,
            "held_iters_per_solve": ans.lane_iters / poses,
            "found_share": float(ans.found.double().mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--poses", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = [count(args.workload, s, args.poses, torch.device(args.device))
            for s in args.seeds]
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"workload": args.workload, "mean": sum(
        r["lane_iters_per_solve"] for r in rows) / len(rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
