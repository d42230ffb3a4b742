#!/usr/bin/env python3
"""The no-reseed LM loop on explicit random seeds, feature by feature.

The counterpart of ``benchmarks/exp_bisect.py``, which wrapped
``lm_loop`` in minimal TPU kernels to find the feature that broke its
compiler: R = S = 8 restarts per pose with no reseeding, explicit random
start points for all eight lanes (no caller-seed lane), the Speed-mode
group stop on or off, 32 or 8 iterations, outputs ``x (A, S, P)`` and
``f (S, P)`` on the Panda at P = 256 poses.  Plus the known-good shape of
the original, a 2-round reseeding solve through ``build_kernel_solver``.

In the port each variant is the LM kernel itself
(``optik_tpu_torch/csrc/lm_kernel.cu``) launched through its explicit-seed
entry (:func:`optik_tpu_torch.ops.cuda.lm_kernel.launch_lanes`) with
reseeding off and the freeze flag on or off; its plain version is
:func:`optik_tpu_torch.ops.cuda.lm_kernel.plain_lanes`.

Run on a machine with an NVIDIA card, from the repository root:

    python3 -m optik_tpu_torch.benchmarks.exp_bisect

It prints one JSON line per case.  :func:`run_variant` dispatches by
device: CPU tensors go through the plain version, CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import json
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..config import SolverConfig
from ..models import asset_path
from ..models.chain import ChainSpec
from ..ops.cuda import lm_kernel
from ..solver import ik as ik_mod

S, P = 8, 256
# (name, max_iters, group_stop), as in the original.
VARIANTS = (("noreseed_groupstop_i32", 32, True),
            ("noreseed_nogroupstop_i32", 32, False),
            ("noreseed_groupstop_i8", 8, True))


class Problem(NamedTuple):
    spec: ChainSpec
    tgt_r: torch.Tensor   # (P, 3, 3)
    tgt_t: torch.Tensor   # (P, 3)
    seeds: torch.Tensor   # (S, P, A) explicit start points
    x0: torch.Tensor      # (P, A) caller seeds of the reseeding case


def panda_spec() -> ChainSpec:
    return ChainSpec.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                    "panda_hand_tcp")


def make_problem(fk_batch, spec: ChainSpec, device, seed: int = 0) -> Problem:
    """Reachable targets and random start points from a numpy seed, drawn in
    the original's order.  ``fk_batch`` maps (P, A) joint values to
    ``(R (P,3,3), t (P,3))``."""
    rng = np.random.default_rng(seed)
    lo, hi = spec.joint_limits()
    a = spec.num_positions
    tr, tt = fk_batch(rng.uniform(lo, hi, size=(P, a)))
    seeds = rng.uniform(lo, hi, size=(S, P, a))
    x0 = rng.uniform(lo, hi, size=(P, a))

    def f32(v):
        return ik_mod.as_tensor(v, torch.float32, device)

    return Problem(spec, f32(tr), f32(tt), f32(seeds), f32(x0))


def variant_plan(spec: ChainSpec, max_iters: int) -> lm_kernel.KernelPlan:
    return lm_kernel.KernelPlan(
        spec, SolverConfig(max_restarts=S, seed_batch=S, max_iters=max_iters))


def lanes_to_outputs(lanes: lm_kernel.LaneResult):
    """Lane results on the (P, S) grid -> the original's outputs
    ``(x (A, S, P), f (S, P))``."""
    return lanes.x.permute(2, 1, 0).contiguous(), lanes.f.T.contiguous()


def plain_variant_lanes(prob: Problem, max_iters: int, group_stop: bool,
                        track_active: bool = False) -> lm_kernel.LaneResult:
    """The variant in plain torch on the problem's device, as lane results
    (``track_active`` adds the iterations each lane ran)."""
    return lm_kernel.plain_lanes(
        variant_plan(prob.spec, max_iters),
        prob.seeds.permute(1, 0, 2).contiguous(), prob.tgt_r, prob.tgt_t,
        reseed=False, freeze=group_stop, track_active=track_active)


def plain_variant(prob: Problem, max_iters: int, group_stop: bool):
    """The variant in plain torch: ``(x (A, S, P), f (S, P))``."""
    return lanes_to_outputs(plain_variant_lanes(prob, max_iters, group_stop))


def kernel_variant(prob: Problem, max_iters: int, group_stop: bool,
                   fmad: bool = True):
    """The variant on the CUDA kernel: ``(x (A, S, P), f (S, P))``.  The
    launch is counted where it is made, in ``lm_kernel.LAUNCHES``."""
    a = prob.spec.num_positions
    n_pose = prob.tgt_r.shape[0]
    # (S, P, A) -> (A, L) with lane l = pose * S + s.
    seeds = prob.seeds.permute(2, 1, 0).reshape(a, n_pose * S).contiguous()
    lanes = lm_kernel.launch_lanes(
        variant_plan(prob.spec, max_iters), seeds,
        lm_kernel.pack_targets(prob.tgt_r, prob.tgt_t), reseed=False,
        freeze=group_stop, fmad=fmad)
    return lanes_to_outputs(lanes)


def run_variant(prob: Problem, max_iters: int, group_stop: bool):
    """Dispatch by device: CPU -> :func:`plain_variant`, CUDA -> the
    kernel."""
    kind = prob.seeds.device.type
    if kind == "cpu":
        return plain_variant(prob, max_iters, group_stop)
    if kind == "cuda":
        return kernel_variant(prob, max_iters, group_stop)
    raise ValueError(f"no LM variant for device {prob.seeds.device}")


def reseed_2round(prob: Problem):
    """The original's reference case: 2 rounds of 8 restarts through the
    solver the facade uses -> IKResult (dispatching by device)."""
    cfg = SolverConfig(max_restarts=2 * S, seed_batch=S, max_iters=32)
    solve = lm_kernel.build_kernel_solver(prob.spec, cfg)
    return solve(prob.tgt_r, prob.tgt_t, prob.x0)


def run_all(prob: Problem) -> list:
    """Every case of the original on the problem's device: a list of
    ``{"case", "ok", ...}`` rows (``ok`` = finite outputs of the expected
    shape)."""
    a, n_pose = prob.spec.num_positions, prob.tgt_r.shape[0]
    rows = []
    for name, max_iters, group_stop in VARIANTS:
        x, f = run_variant(prob, max_iters, group_stop)
        ok = (x.shape == (a, S, n_pose) and f.shape == (S, n_pose)
              and bool(torch.isfinite(x).all())
              and bool(torch.isfinite(f).all()))
        rows.append({"case": name, "ok": ok})
    res = reseed_2round(prob)
    rows.append({"case": "reseed_2round_solver",
                 "ok": res.found.shape == (n_pose,),
                 "succ": int(res.found.sum())})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_bisect: needs an NVIDIA card", file=sys.stderr)
        return 2
    from ..robot import Robot

    robot = Robot(panda_spec(), device="cuda")
    rows = run_all(make_problem(robot.fk_batch, robot.spec, "cuda"))
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
