"""Quality-mode IK, worked out plainly, and the check that judges the
program's Quality answers by it.

OptIK's ``SolutionMode::Quality`` (``config.rs``, ``lib.rs:398-408``)
spends the whole restart budget and returns, of every successful restart,
the one nearest the caller's seed (``min_by_key`` over the seed distance),
as TRAC-IK's "Distance" solve type does.  The port states it on the Speed
schedule of ``lm.py`` (``SolverConfig`` with ``solution_mode = quality``,
``max_restarts = R``, ``seed_batch = S``, ``max_iters``, ``tol_f``,
``quality_max_successes = 0``):

* the restart stream, the lanes, the damped step, the stops of an attempt
  and the reseeding are Speed's (``lm.py``'s docstring): lane l tries
  restarts l, l + S, l + 2S, ... of the pose's range, restart 0 from the
  caller's seed ``x0``;
* no success ends the pose: a success ends its attempt, and the lane
  adopts its next restart, until its restarts are spent;
* a lane keeps a success when it is strictly nearer to ``x0`` than the
  lane's best so far; the distance is the square root of the squared
  differences summed in joint order (:func:`distance`);
* the pose's answer is the nearest success over its lanes, ties going to
  the lower restart index.  A pose with no success is not found.

Departures from OptIK, each the port's: restarts run S at a time in
lockstep from a fixed stream rather than one after another from a fresh
random draw; an attempt is the projected LM of ``lm.py``, not SLSQP; the
budget is restarts, not wall-clock time.  The port breaks an exact tie
between lanes by the lower lane (``argmin``), this reference by the lower
restart index; both are the same restart unless two lanes hold successes
at one distance, which float arithmetic does not produce on random inputs.

``lane_iters`` counts as ``lm.py`` does: per pose, S times the iterations
until the last of its lanes stopped.  ``busy_iters`` is the sum over lanes
of the iterations each ran before its restarts were spent: ``lane_iters``
less the slots where a lane whose budget ended early waits for the pose's
slowest lane.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import lm
from .chain import Chain, pose_error
from .check import (COST_GAP, COST_SLACK, LIMIT_TOL, X_TOL,
                    restart_stream)

# Radians (summed in quadrature over the joints): how much farther from
# ``x0`` than the reference's nearest success an answer may lie.  A
# float32 attempt ends within the success basin of its float64 twin
# (cost <= tol_f, a pose residual of ~1e-3) and may drift a little along
# a redundant arm's self-motion, so the same restart's success lies
# ~1e-3 from the reference's; a success of another restart, taken because
# the nearest was missed, lies farther by ~0.1 or more.
DIST_TOL = 1e-2
# Poses per block of the reference solve: 64 lanes each.
BLOCK = 512


class Answer(NamedTuple):
    found: torch.Tensor      # (P,) bool
    x: torch.Tensor          # (P, A)
    cost: torch.Tensor       # (P,)
    dist: torch.Tensor       # (P,) distance to x0, +inf where not found
    restart: torch.Tensor    # (P,) int64, INT_MAX where not found
    lane_iters: int          # sum over poses of S x the group's iterations
    busy_iters: int          # sum over lanes of the iterations each ran


def distance(x: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """|x - x0| over the last axis: the squared differences summed in
    joint order, then the square root."""
    d = x - x0
    acc = d[..., 0] * d[..., 0]
    for p in range(1, d.shape[-1]):
        acc = acc + d[..., p] * d[..., p]
    return torch.sqrt(acc)


def schedule(chain: Chain, tgt_r, tgt_t, starts, x0, table, *, s: int,
             max_iters: int, tol_f: float) -> Answer:
    """Every restart of the (R, A) ``table`` for P poses: ``starts``
    (P, S, A) are the lanes' first seeds (restart l for lane l), ``x0``
    (P, A) the point distances are taken from."""
    p, _, a = starts.shape
    count = table.shape[0]
    dev, dt = starts.device, starts.dtype
    lo = torch.tensor(chain.lower, dtype=dt, device=dev)
    hi = torch.tensor(chain.upper, dtype=dt, device=dev)
    tol_df = 1e-3 * tol_f
    rounds = -(-count // s)
    lanes = (p, s)
    tr = tgt_r[:, None].expand(p, s, 3, 3).reshape(-1, 3, 3)
    tt = tgt_t[:, None].expand(p, s, 3).reshape(-1, 3)
    origin = x0[:, None].expand(p, s, a)

    x = starts.clone()
    e = torch.zeros(lanes + (6,), dtype=dt, device=dev)
    jac = torch.zeros(lanes + (6, a), dtype=dt, device=dev)
    f = torch.full(lanes, float("inf"), dtype=dt, device=dev)
    lam = torch.full(lanes, lm.LAM_INIT, dtype=dt, device=dev)
    nu = torch.full(lanes, 2.0, dtype=dt, device=dev)
    idx = torch.arange(s, device=dev).expand(lanes).clone()
    stopped = torch.zeros(lanes, dtype=torch.bool, device=dev)
    pending = torch.ones_like(stopped)
    it_att = torch.zeros(lanes, dtype=torch.int64, device=dev)
    act = torch.zeros(lanes, dtype=torch.int64, device=dev)
    best_x = torch.zeros_like(x)
    best_d = torch.full(lanes, float("inf"), dtype=dt, device=dev)
    best_f = torch.full(lanes, float("inf"), dtype=dt, device=dev)
    best_i = torch.full(lanes, lm.INT_MAX, dtype=torch.int64, device=dev)
    it = 0
    while it < (max_iters + 1) * rounds and not bool(stopped.all()):
        run = ~stopped
        act += run
        x_new = torch.minimum(torch.maximum(x + lm._step(jac, e, lam), lo),
                              hi)
        adopt = table[idx] if it > 0 else x
        x_new = torch.where(pending[..., None], adopt, x_new)
        e_n, j_n = lm._residual_and_jacobian(
            chain, x_new.reshape(-1, a), tr, tt)
        e_n, j_n = e_n.reshape(lanes + (6,)), j_n.reshape(lanes + (6, a))
        f_n = (e_n * e_n).sum(-1)
        finite = torch.isfinite(f_n)
        accept = ((f_n < f) | pending) & finite
        w = (jac @ (x_new - x)[..., None])[..., 0]
        pred = -(2 * (e * w).sum(-1) + (w * w).sum(-1))
        rho = (f - f_n) / pred.clamp_min(1e-30)
        good = accept & (pred > 0) & ~pending
        shrink = (1 - (2 * rho - 1) ** 3).clamp_min(1 / 3)

        keep = stopped | ~accept
        x_next = torch.where(keep[..., None], x, x_new)
        e_next = torch.where(keep[..., None], e, e_n)
        j_next = torch.where(keep[..., None, None], jac, j_n)
        f_next = torch.where(keep, f, f_n)
        lam_n = torch.where(good, lam * shrink, lam * nu).clamp(lm.LAM_MIN,
                                                                lm.LAM_MAX)
        nu_n = torch.where(good, 2.0, (nu * 2).clamp_max(64.0))
        fresh = pending & run
        lam_n = torch.where(fresh, lm.LAM_INIT, lam_n)
        nu_n = torch.where(fresh, 2.0, nu_n)
        lam_n = torch.where(stopped, lam, lam_n)
        nu_n = torch.where(stopped, nu, nu_n)

        ok = f_next <= tol_f
        stall = accept & ((f - f_next).abs() < tol_df) & ~pending
        it_n = torch.where(pending & run, 1, it_att + 1)
        over = (ok | stall | (lam_n >= lm.LAM_MAX) | (it_n > max_iters)
                | (pending & ~finite))
        d = distance(x_next, origin)
        better = run & ok & (d < best_d)
        best_x = torch.where(better[..., None], x_next, best_x)
        best_d = torch.where(better, d, best_d)
        best_f = torch.where(better, f_next, best_f)
        best_i = torch.where(better, idx, best_i)
        ended = run & over
        retry = ended & (idx + s < count)
        stopped = stopped | (ended & ~retry)
        idx = torch.where(retry, idx + s, idx)
        it_n = torch.where(retry, 0, it_n)
        pending = retry

        x, e, jac, f, lam, nu, it_att = (x_next, e_next, j_next, f_next,
                                         lam_n, nu_n, it_n)
        it += 1

    # Nearest first, then the lower restart index.
    near = best_d.amin(dim=1, keepdim=True)
    key = torch.where(best_d == near, best_i, lm.INT_MAX)
    pick = key.argmin(dim=1)
    rows = torch.arange(p, device=dev)
    found = torch.isfinite(best_d).any(dim=1)
    return Answer(found=found, x=best_x[rows, pick], cost=best_f[rows, pick],
                  dist=best_d[rows, pick],
                  restart=torch.where(found, best_i[rows, pick], lm.INT_MAX),
                  lane_iters=int(act.amax(dim=1).sum()) * s,
                  busy_iters=int(act.sum()))


def solve(chain: Chain, tgt_r, tgt_t, x0, table, *, s: int, max_iters: int,
          tol_f: float) -> Answer:
    """Quality-mode answers for P poses: ``tgt_r`` (P, 3, 3), ``tgt_t``
    (P, 3), ``x0`` (P, A), ``table`` (R, A), all in the working dtype;
    lane 0 starts from ``x0``, lane l > 0 from row l."""
    p, a = x0.shape
    starts = table[:s].expand(p, s, a).clone()
    starts[:, 0] = x0
    return schedule(chain, tgt_r, tgt_t, starts, x0, table, s=s,
                    max_iters=max_iters, tol_f=tol_f)


def solve_blocks(chain: Chain, tgt_r, tgt_t, x0, table, *, block: int,
                 **kw) -> Answer:
    """:func:`solve` over blocks of ``block`` poses (bounded memory)."""
    parts = [solve(chain, tgt_r[i:i + block], tgt_t[i:i + block],
                   x0[i:i + block], table, **kw)
             for i in range(0, x0.shape[0], block)]
    return Answer(*(torch.cat([getattr(v, k) for v in parts])
                    for k in ("found", "x", "cost", "dist", "restart")),
                  lane_iters=sum(v.lane_iters for v in parts),
                  busy_iters=sum(v.busy_iters for v in parts))


def ik_answers(chain: Chain, solver: dict, tgt_r, tgt_t, x0,
               dtype) -> Answer:
    """The Quality-mode answers of the sampled poses in ``dtype``."""
    if solver.get("quality_max_successes", 0):
        raise ValueError("the reference runs uncapped Quality only")
    cast = [t.to(dtype) for t in (tgt_r, tgt_t, x0)]
    table = restart_stream(chain, solver, dtype, x0.device)
    return solve_blocks(chain, *cast, table, block=BLOCK,
                        s=min(solver["seed_batch"], solver["max_restarts"]),
                        max_iters=solver["max_iters"], tol_f=solver["tol_f"])


def ik_numbers(chain: Chain, solver: dict, inputs, answers,
               ref: Optional[Answer] = None
               ) -> Tuple[Dict[str, float], dict]:
    """``(numbers, diagnostics)`` for the sampled poses: ``inputs`` =
    (tgt_r, tgt_t, x0), ``answers`` = (found, x, cost), tensors on one
    device; ``ref`` the reference's float64 answers on those inputs where
    they are made already.

    An answer is rejected when its ``found`` differs from the reference's;
    when it is found and the float64 cost of its ``x`` exceeds ``tol_f``
    by more than ``COST_SLACK``, its reported ``cost`` differs from that
    cost by more than ``COST_GAP`` of ``tol_f``, or its ``x`` leaves the
    limits by more than ``LIMIT_TOL`` (``check.py`` gives their reasons);
    or when both found and its distance to ``x0`` exceeds the reference's
    nearest by more than ``DIST_TOL``.  An ``x`` more than ``X_TOL`` from
    the reference's at no greater distance is another success as near,
    a valid answer: ``x_differs`` counts it and rejects nothing."""
    tgt_r, tgt_t, x0 = (t.double() for t in inputs)
    found, x, cost = answers
    x, cost = x.double(), cost.double()
    if ref is None:
        ref = ik_answers(chain, solver, tgt_r, tgt_t, x0, torch.float64)
    tol = solver["tol_f"]
    e = pose_error(chain, x, tgt_r, tgt_t)
    cost64 = (e * e).sum(-1)
    lo = torch.tensor(chain.lower, dtype=x.dtype, device=x.device)
    hi = torch.tensor(chain.upper, dtype=x.dtype, device=x.device)
    outside = torch.maximum(lo - x, x - hi).amax(dim=1).clamp_min(0)
    both = found & ref.found
    farther = torch.where(both, distance(x, x0) - ref.dist,
                          torch.zeros_like(ref.dist))
    dx = (x - ref.x).abs().amax(dim=1)
    bad = (found != ref.found) | (both & (farther > DIST_TOL))
    bad |= found & ((cost64 > tol * (1 + COST_SLACK))
                    | ((cost - cost64).abs() > COST_GAP * tol)
                    | (outside > LIMIT_TOL))
    n = int(found.shape[0])

    def top(t, mask):
        return float(t[mask].max()) if bool(mask.any()) else 0.0

    diag = {"sampled": n, "found": int(found.sum()),
            "ref_found": int(ref.found.sum()),
            "rejected_found": int((bad & found).sum()),
            "found_differs": int((found != ref.found).sum()),
            "farther": int((both & (farther > DIST_TOL)).sum()),
            "farther_max": top(farther, both),
            "nearer_max": top(-farther, both),
            "x_differs": int((both & (dx > X_TOL)).sum()),
            "ref_dist_median": float(ref.dist[ref.found].median())
            if bool(ref.found.any()) else 0.0,
            "cost64_over_tol_max": top(cost64, found) / tol,
            "cost_gap_over_tol_max": top((cost - cost64).abs(), found) / tol,
            "limit_excess_max": top(outside, found),
            "ref_lane_iters_per_solve": ref.lane_iters / max(n, 1),
            "ref_busy_share": ref.busy_iters / max(ref.lane_iters, 1)}
    return {"mismatch_share": int(bad.sum()) / max(n, 1)}, diag


def ik_control(chain: Chain, solver: dict, inputs):
    """The control's answers (found, x, cost) for the sampled poses: the
    reference in bfloat16, the precision below the configuration's
    float32."""
    ans = ik_answers(chain, solver, *inputs, torch.bfloat16)
    return ans.found, ans.x, ans.cost
