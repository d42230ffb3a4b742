"""Faults planted under the Quality cell's timed path, for the tests that
see ``correct`` come out false (``harness.Ctx.patch``, "module:function")."""

import torch

from optik_tpu_torch import Robot
from optik_tpu_torch.ops.cuda import lm_kernel
from optik_tpu_torch.solver import lm_soa

from ikbench.reference import quality

_ik_batch = Robot.ik_batch


def speed_pick():
    """Each pose's first success (Speed's pick) in Quality's place."""
    def ik_batch(self, cfg, tgt_r, tgt_t, x0, **kw):
        return _ik_batch(self, cfg.replace(solution_mode="speed"), tgt_r,
                         tgt_t, x0, **kw)
    Robot.ik_batch = ik_batch


def half_budget():
    """Half the restart budget (128 of the cell's 256)."""
    def ik_batch(self, cfg, tgt_r, tgt_t, x0, **kw):
        return _ik_batch(self, cfg.replace(max_restarts=cfg.max_restarts
                                           // 2), tgt_r, tgt_t, x0, **kw)
    Robot.ik_batch = ik_batch


def lane_start_answers(robot, cfg, tgt_r, tgt_t, x0):
    """``(found, x, cost)`` of the port's plain Quality loop on the inputs'
    device with each lane's distance taken from the lane's own first seed,
    not from the caller's ``x0``, for the lane's best and the pose's
    pick."""
    plan = lm_kernel.KernelPlan(robot.spec, cfg)
    seeds = plan.seeds(x0)
    res = lm_soa.solve_soa(
        plan.consts, plan.lower, plan.upper, plan.opts, seeds,
        tgt_r[:, None], tgt_t[:, None],
        seed_table=plan.table(x0.device, 0, x0.dtype),
        lane_index=torch.arange(plan.s, dtype=torch.int32,
                                device=x0.device),
        total_restarts=plan.r_total, explore_full_budget=True,
        quality_x0=seeds, approx=True)
    key = torch.where(res.success, quality.distance(res.x, seeds),
                      float("inf"))
    pick = key.argmin(dim=1)
    rows = torch.arange(x0.shape[0], device=x0.device)
    return res.success.any(dim=1), res.x[rows, pick], res.f[rows, pick]


def lane_start_distance():
    """Distances from each lane's first seed in place of the caller's
    (:func:`lane_start_answers`), in the program's result."""
    def ik_batch(self, cfg, tgt_r, tgt_t, x0, **kw):
        res = _ik_batch(self, cfg, tgt_r, tgt_t, x0, **kw)
        found, x, cost = lane_start_answers(self, cfg, tgt_r, tgt_t, x0)
        return res._replace(found=found, x=x, cost=cost,
                            found_count=found.sum())
    Robot.ik_batch = ik_batch
