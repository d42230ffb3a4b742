"""Speed-mode IK, worked out plainly: the restart schedule, the projected
Levenberg-Marquardt attempts and the per-pose pick.

The semantics the port states for a pose (``SolverConfig`` with
``max_restarts = R``, ``seed_batch = S``, ``max_iters``, ``tol_f``):

* S lanes run in lockstep; lane l tries restarts l, l + S, l + 2S, ... of
  the pose's range; restart 0 starts from the caller's seed, restart i > 0
  from row i of the restart stream (``seeds.restart_table``);
* an attempt's first iteration adopts its seed (cost only); every later
  one takes the damped Gauss-Newton step
  ``dx = -J^T (J J^T + lam I)^-1 e`` from the current point, projected
  into the joint limits, and accepts it when the cost falls; ``lam``
  follows Nielsen's rule (shrink by ``max(1/3, 1 - (2 rho - 1)^3)`` on a
  good step, else grow by ``nu``, which doubles up to 64), clamped to
  [1e-14, 1e10], and starts each attempt at 1e-4;
* an attempt succeeds when its cost ``|e|^2 <= tol_f``; it ends without
  success on an accepted step that changed the cost by less than
  ``1e-3 tol_f``, when ``lam`` reaches its cap, after ``max_iters``
  steps, or on a non-finite seed; the lane then adopts its next restart;
* the first iteration at which any lane of the pose succeeds ends the
  pose: its answer is the success with the lowest restart index of that
  iteration.  A pose with no success is not found.

A seed-sharded solve splits the R restarts into ``n`` equal ranges, one
per seed rank; a rank whose range does not start at 0 starts its lane 0
from the stream too.  Each rank runs the schedule above on its range, and
the pose's answer is the success with the lowest restart index over the
ranks.

Everything runs in the dtype of the inputs: float64 for the reference,
bfloat16 for the control (whose 6x6 solve runs in float32).  ``e`` comes
from ``chain.pose_error``; ``J = de/dq`` from central differences of it
in float64, rounded to that dtype.

``lane_iters`` counts the work the inputs need under this schedule: per
pose, S times the iterations until the last of its lanes stopped (a
pose's lanes run as one group), summed over poses and seed ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from .chain import Chain, pose_error

LAM_INIT, LAM_MIN, LAM_MAX = 1e-4, 1e-14, 1e10
# Central differences at this step are within ~1e-9 of the derivative in
# float64 (rounding ~1e-11, truncation ~1e-10 x the third derivative).
FD_STEP = 1e-5
INT_MAX = 2 ** 31 - 1


class Answer(NamedTuple):
    found: torch.Tensor      # (P,) bool
    x: torch.Tensor          # (P, A)
    cost: torch.Tensor       # (P,)
    restart: torch.Tensor    # (P,) int64, INT_MAX where not found
    lane_iters: int          # sum over poses of S x the group's iterations


def _residual_and_jacobian(chain: Chain, q, tgt_r, tgt_t):
    """``e`` at ``q`` (L, A) in its dtype, and ``J = de/dq`` (L, 6, A) by
    central differences in float64 (step ``FD_STEP``), rounded to that
    dtype: one batched evaluation of the 2A + 1 points (the point itself
    first)."""
    a = q.shape[-1]
    q64 = q.double()
    step = FD_STEP * torch.eye(a, dtype=torch.float64, device=q.device)
    pts = torch.cat([q64[:, None], q64[:, None] + step,
                     q64[:, None] - step], dim=1)
    n = pts.shape[1]
    e = pose_error(chain, pts, tgt_r.double()[:, None].expand(-1, n, 3, 3),
                   tgt_t.double()[:, None].expand(-1, n, 3))
    jac = ((e[:, 1:a + 1] - e[:, a + 1:]) / (2 * FD_STEP)).transpose(-1, -2)
    if q.dtype == torch.float64:
        return e[:, 0], jac
    return pose_error(chain, q, tgt_r, tgt_t), jac.to(q.dtype)


def _step(jac, e, lam):
    """-J^T (J J^T + lam I)^-1 e, per lane."""
    jjt = jac @ jac.transpose(-1, -2)
    eye = torch.eye(6, dtype=jjt.dtype, device=jjt.device)
    a = jjt + lam[..., None, None] * eye
    solve_dtype = torch.float64 if a.dtype == torch.float64 \
        else torch.float32
    z, info = torch.linalg.solve_ex(a.to(solve_dtype),
                                    e.to(solve_dtype)[..., None])
    # A system that rounds to singular (bfloat16) gives no step: its lane
    # rejects the point and raises its damping.
    z = torch.where((info == 0)[..., None, None], z, float("nan"))
    return -(jac.transpose(-1, -2) @ z.to(jac.dtype))[..., 0]


def _schedule(chain: Chain, tgt_r, tgt_t, starts, table, offset: int,
              count: int, s: int, max_iters: int, tol_f: float) -> Answer:
    """One rank's range [offset, offset + count) of every pose's restarts.

    ``starts`` (P, S, A) are the lanes' first seeds, ``table`` the whole
    (R, A) stream in the working dtype."""
    p, _, a = starts.shape
    dev, dt = starts.device, starts.dtype
    lo = torch.tensor(chain.lower, dtype=dt, device=dev)
    hi = torch.tensor(chain.upper, dtype=dt, device=dev)
    tol_df = 1e-3 * tol_f
    rounds = -(-count // s)
    lanes = (p, s)
    tr = tgt_r[:, None].expand(p, s, 3, 3).reshape(-1, 3, 3)
    tt = tgt_t[:, None].expand(p, s, 3).reshape(-1, 3)

    x = starts.clone()
    e = torch.zeros(lanes + (6,), dtype=dt, device=dev)
    jac = torch.zeros(lanes + (6, a), dtype=dt, device=dev)
    f = torch.full(lanes, float("inf"), dtype=dt, device=dev)
    lam = torch.full(lanes, LAM_INIT, dtype=dt, device=dev)
    nu = torch.full(lanes, 2.0, dtype=dt, device=dev)
    idx = torch.arange(s, device=dev).expand(lanes).clone()
    stopped = torch.zeros(lanes, dtype=torch.bool, device=dev)
    success = torch.zeros_like(stopped)
    pending = torch.ones_like(stopped)
    it_att = torch.zeros(lanes, dtype=torch.int64, device=dev)
    act = torch.zeros(lanes, dtype=torch.int64, device=dev)
    it = 0
    while it < (max_iters + 1) * rounds and not bool(stopped.all()):
        run = ~stopped
        act += run
        x_new = torch.minimum(torch.maximum(x + _step(jac, e, lam), lo), hi)
        if it > 0:
            adopt = table[offset + idx]
        else:
            adopt = x
        x_new = torch.where(pending[..., None], adopt, x_new)
        e_n, j_n = _residual_and_jacobian(
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
        lam_n = torch.where(good, lam * shrink, lam * nu).clamp(LAM_MIN,
                                                                LAM_MAX)
        nu_n = torch.where(good, 2.0, (nu * 2).clamp_max(64.0))
        fresh = pending & run
        lam_n = torch.where(fresh, LAM_INIT, lam_n)
        nu_n = torch.where(fresh, 2.0, nu_n)
        lam_n = torch.where(stopped, lam, lam_n)
        nu_n = torch.where(stopped, nu, nu_n)

        ok = f_next <= tol_f
        stall = accept & ((f - f_next).abs() < tol_df) & ~pending
        it_n = torch.where(pending & run, 1, it_att + 1)
        over = (ok | stall | (lam_n >= LAM_MAX) | (it_n > max_iters)
                | (pending & ~finite))
        success = success | (run & ok)
        failed = run & over & ~ok
        retry = failed & (idx + s < count)
        stopped = stopped | (run & ((over & ok) | (failed & ~retry)))
        idx = torch.where(retry, idx + s, idx)
        it_n = torch.where(retry, 0, it_n)
        done = success.any(dim=1, keepdim=True)
        stopped = stopped | done
        pending = retry & ~done

        x, e, jac, f, lam, nu, it_att = (x_next, e_next, j_next, f_next,
                                         lam_n, nu_n, it_n)
        it += 1

    key = torch.where(success, offset + idx, INT_MAX)
    best = key.argmin(dim=1)
    rows = torch.arange(p, device=dev)
    return Answer(found=success.any(dim=1), x=x[rows, best],
                  cost=f[rows, best], restart=key[rows, best],
                  lane_iters=int(act.amax(dim=1).sum()) * s)


def solve(chain: Chain, tgt_r, tgt_t, x0, table, *, s: int,
          max_iters: int, tol_f: float, seed_ranks: int = 1) -> Answer:
    """Speed-mode answers for P poses: ``tgt_r`` (P, 3, 3), ``tgt_t``
    (P, 3), ``x0`` (P, A), ``table`` (R, A), all in the working dtype;
    ``seed_ranks`` splits the restarts as a seed-sharded solve does."""
    r = table.shape[0]
    count = r // seed_ranks
    if count * seed_ranks != r:
        raise ValueError(f"{r} restarts over {seed_ranks} seed ranks")
    p, a = x0.shape
    answers = []
    for d in range(seed_ranks):
        off = d * count
        starts = table[off:off + s].expand(p, s, a).clone()
        if d == 0:
            starts[:, 0] = x0
        answers.append(_schedule(chain, tgt_r, tgt_t, starts, table, off,
                                 count, s, max_iters, tol_f))
    restart = torch.stack([v.restart for v in answers])
    pick = restart.argmin(dim=0)
    rows = torch.arange(p, device=x0.device)
    return Answer(
        found=torch.stack([v.found for v in answers]).any(dim=0),
        x=torch.stack([v.x for v in answers])[pick, rows],
        cost=torch.stack([v.cost for v in answers])[pick, rows],
        restart=restart[pick, rows],
        lane_iters=sum(v.lane_iters for v in answers))


def solve_blocks(chain: Chain, tgt_r, tgt_t, x0, table, *, block: int,
                 **kw) -> Answer:
    """:func:`solve` over blocks of ``block`` poses (bounded memory)."""
    parts = [solve(chain, tgt_r[i:i + block], tgt_t[i:i + block],
                   x0[i:i + block], table, **kw)
             for i in range(0, x0.shape[0], block)]
    return Answer(found=torch.cat([v.found for v in parts]),
                  x=torch.cat([v.x for v in parts]),
                  cost=torch.cat([v.cost for v in parts]),
                  restart=torch.cat([v.restart for v in parts]),
                  lane_iters=sum(v.lane_iters for v in parts))
