"""Count the lane-iterations per solve that a cell's inputs need.

    python3 -m ikbench.workcount.lane_iters --workload <cell> \
        --seeds 1 2 3 --poses 32768

For each seed, the first ``--poses`` poses of the first batch a run of
that seed makes go through the reference's Speed schedule in float64
(``reference/lm.py``), which counts every iteration of every lane that
has not stopped: the plain loop's ``track_active`` count, the work the
inputs need under the schedule.  A seed-sharded cell's mesh is not
applied: the count is the single-card schedule's, the work the poses
need.  The cell's file freezes the mean over the seeds.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import harness
from ..drivers import common
from ..reference import check


def count(workload: str, seed: int, poses: int, device) -> dict:
    ctx = harness.context(workload, seed, 1.0, False, str(device), 0.0,
                          {"batch": poses, "pool": 1})
    chain = common.chain_of(ctx)
    g = common.generator(seed, device)
    tgt_r, tgt_t, x0 = common.ik_inputs(chain, g, poses, device)
    ans = check.ik_answers(chain, ctx.config["solver"], tgt_r, tgt_t, x0,
                           torch.float64)
    return {"seed": seed, "poses": poses,
            "lane_iters_per_solve": ans.lane_iters / poses,
            "found_share": float(ans.found.double().mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--poses", type=int, default=32768)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = [count(args.workload, s, args.poses, torch.device(args.device))
            for s in args.seeds]
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({"workload": args.workload, "mean": sum(
        r["lane_iters_per_solve"] for r in rows) / len(rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
