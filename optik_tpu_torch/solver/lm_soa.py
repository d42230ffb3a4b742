"""Lockstep projected-LM solver on the SoA path, as a plain torch loop.

A port of ``optik_tpu/solver/lm_soa.py`` with the same per-iteration
semantics (``lm_soa.py:183-390``), which its module docstring sets out:

  * exactly one fused residual+Jacobian evaluation per iteration.  The first
    iteration of every attempt is an "adopt" step: the lane evaluates its
    seed point, takes its cost, and only checks the stopval criterion;
  * continuous reseeding: with a seed table (R, A) and S lanes per pose,
    lane l strides restart indices l, l+S, l+2S, ...; a lane whose attempt
    ends without success adopts its next seed on the following iteration;
  * Speed mode freezes a whole pose at its earliest success;
  * Quality mode explores the full restart budget, tracking a per-lane best
    success by distance to the caller's seed, optionally capped by
    ``group_success_cap``.

This loop is the oracle the CUDA kernel (``ops/cuda/lm_kernel.py``) is held
against on the card.  It syncs with the device once per iteration (the
"all lanes stopped" test), which is fine for an oracle.  The JAX version's
``unroll`` and ``track_active`` options shape compilation and probes, not
results, and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import soa
from .lm import LMOptions, LMResult


class LoopOut(NamedTuple):
    """lm_loop result: component lists over the lane shape."""

    xs: tuple                    # A components: final (or best) iterate
    f: torch.Tensor              # final (or best) cost
    success: torch.Tensor        # bool
    iters: int                   # loop iterations executed
    restart_index: Optional[torch.Tensor]  # None without reseeding
    # Per-lane attempt-iteration count at the lane's first success (0 when
    # the lane never succeeded).
    succ_iters: Optional[torch.Tensor] = None


def lm_loop(consts, lower, upper, opts: LMOptions,
            xs0, tgtm, tgtt, eem=None, eev=None, weight6=None, *,
            seed_lookup=None,       # callable: idx tensor -> A components
            lane_index=None,        # int tensor broadcastable to lane shape
            total_restarts: int = 0,
            s_lanes: int = 1,       # lanes per pose (stride)
            success_stops_group: bool = False,
            group_axis: int = -1,
            explore_full_budget: bool = False,
            qx0=None,               # A components: caller's seed (quality)
            group_success_cap: Optional[int] = None,
            approx: bool = False) -> LoopOut:
    """The lockstep LM loop on component lists (see module docstring).

    ``approx`` selects kernel math mode (polynomial atan2/sincos).
    """
    a = len(xs0)
    lane_shape = torch.broadcast_shapes(*[x.shape for x in xs0])
    dtype = xs0[0].dtype
    device = xs0[0].device

    reseed = seed_lookup is not None and total_restarts > s_lanes
    track_best = reseed and explore_full_budget
    rounds = -(-total_restarts // s_lanes) if reseed else 1
    # +1 per round: each attempt's first iteration only evaluates its seed.
    max_total_iters = (opts.max_iters + 1) * rounds

    def rj(xs):
        e, jt = soa.residual_and_jtask(consts, xs, tgtm, tgtt, eem, eev,
                                       weight6, approx)
        f = torch.broadcast_to(soa.vec_dot(e, e), lane_shape)
        return e, jt, f

    def full(v):
        return torch.full(lane_shape, v, dtype=dtype, device=device)

    xs = [torch.broadcast_to(x, lane_shape) for x in xs0]
    e = [full(0.0)] * 6
    jt = [[full(0.0)] * a for _ in range(6)]
    f = full(float("inf"))
    lam = full(opts.lam_init)
    nu = full(2.0)
    false = torch.zeros(lane_shape, dtype=torch.bool, device=device)
    zero_i = torch.zeros(lane_shape, dtype=torch.int32, device=device)
    stopped = false
    success = false
    pending = ~false              # every lane adopts its seed first
    it_lane = zero_i              # per-attempt iteration
    succ_it = zero_i              # iters at first success
    succ_cnt = zero_i             # completed successful attempts
    if reseed:
        cur_idx = torch.broadcast_to(
            torch.as_tensor(lane_index, dtype=torch.int32, device=device),
            lane_shape)
    else:
        cur_idx = zero_i
    if track_best:
        bx, bd, bf, bi = [full(0.0)] * a, full(float("inf")), \
            full(float("inf")), zero_i

    it = 0
    while it < max_total_iters and not bool(stopped.all()):
        # Damped GN step from the carried (e, J) at the current iterate:
        # delta = -J^T (J J^T + lam I)^{-1} e   (6x6 SPD solve).
        jjt = [[None] * 6 for _ in range(6)]
        for i in range(6):
            for k in range(i + 1):
                v = sum(jt[i][p] * jt[k][p] for p in range(a))
                jjt[i][k] = v
                jjt[k][i] = v
            jjt[i][i] = jjt[i][i] + lam
        z = soa.cholesky_solve(jjt, e)
        delta = [-sum(jt[i][p] * z[i] for i in range(6)) for p in range(a)]
        x_new = [torch.clamp(xs[p] + delta[p], lower[p], upper[p])
                 for p in range(a)]

        # Pending lanes adopt a point instead of stepping: the initial seed
        # on the very first iteration, or the next stride seed after a
        # scheduled reseed (cur_idx was advanced when the attempt ended).
        if reseed and it != 0:
            adopt_x = seed_lookup(cur_idx)
        else:
            adopt_x = xs
        x_new = [torch.where(pending, adopt_x[p], x_new[p])
                 for p in range(a)]
        step = [x_new[p] - xs[p] for p in range(a)]

        # ONE fused evaluation: trial cost + the next step's Jacobian.
        e_new, jt_new, f_new = rj(x_new)

        finite = torch.isfinite(f_new)
        accept = ((f_new < f) | pending) & finite

        # Nielsen gain ratio on the projected step; meaningless for adopt
        # steps, which reset the damping instead.
        w = [sum(jt[i][p] * step[p] for p in range(a)) for i in range(6)]
        pred = -(2.0 * soa.vec_dot(e, w) + soa.vec_dot(w, w))
        rho = (f - f_new) / pred.clamp_min(1e-30)
        good = accept & (pred > 0) & ~pending
        shrink = (1.0 - (2.0 * rho - 1.0) ** 3).clamp_min(1.0 / 3.0)

        keep = stopped | ~accept  # lanes that keep their current state
        x_next = [torch.where(keep, xs[p], x_new[p]) for p in range(a)]
        e_next = [torch.where(keep, e[i], e_new[i]) for i in range(6)]
        jt_next = [[torch.where(keep, jt[i][p], jt_new[i][p])
                    for p in range(a)] for i in range(6)]
        f_next = torch.where(keep, f, f_new)

        lam_next = torch.clamp(torch.where(good, lam * shrink, lam * nu),
                               opts.lam_min, opts.lam_max)
        nu_next = torch.where(good, 2.0, (nu * 2.0).clamp_max(64.0))
        fresh = pending & ~stopped
        lam_next = torch.where(fresh, opts.lam_init, lam_next)
        nu_next = torch.where(fresh, 2.0, nu_next)
        lam_next = torch.where(stopped, lam, lam_next)
        nu_next = torch.where(stopped, nu, nu_next)

        # --- stopping criteria -------------------------------------------
        newly_f = (f_next <= opts.tol_f) if opts.f_is_success else false
        df = (f - f_next).abs()
        newly_df = accept & (df < opts.tol_df) & ~pending
        if opts.tol_dx >= 0.0:
            adx = step[0].abs()
            for p in range(1, a):
                adx = torch.maximum(adx, step[p].abs())
            newly_dx = accept & (adx < opts.tol_dx) & ~pending
        else:
            newly_dx = false
        newly_stuck = lam_next >= opts.lam_max

        run = ~stopped
        succ_now = newly_f
        if opts.df_is_success:
            succ_now = succ_now | newly_df
        if opts.dx_is_success:
            succ_now = succ_now | newly_dx
        first_succ = run & succ_now & ~success
        success = success | (run & succ_now)
        it_next = torch.where(pending & run, 1, it_lane + 1).to(torch.int32)
        succ_it = torch.where(first_succ, it_next, succ_it)
        attempt_over = (newly_f | newly_df | newly_dx | newly_stuck
                        | (it_next > opts.max_iters))
        # A non-finite adopted point is a dead attempt too.
        attempt_over = attempt_over | (pending & ~finite)

        if track_best:
            # Record this attempt's solution if it's the best success so
            # far (min distance to the caller's seed), then keep exploring.
            d = torch.sqrt(sum((x_next[p] - qx0[p]) ** 2 for p in range(a)))
            better = run & succ_now & (d < bd)
            bx = [torch.where(better, x_next[p], bx[p]) for p in range(a)]
            bd = torch.where(better, d, bd)
            bf = torch.where(better, f_next, bf)
            bi = torch.where(better, cur_idx, bi)

        if reseed:
            next_idx = cur_idx + s_lanes
            can_retry = next_idx < total_restarts
            if track_best:
                # Quality: every finished attempt (success or not) moves on
                # to the next seed while budget remains.
                over = run & attempt_over
                pending_next = over & can_retry
                stopped = stopped | (over & ~can_retry)
            else:
                failed_over = run & attempt_over & ~succ_now
                pending_next = failed_over & can_retry
                stopped = stopped | (run & ((attempt_over & succ_now)
                                            | (failed_over & ~can_retry)))
            cur_idx = torch.where(pending_next, next_idx, cur_idx)
            it_next = torch.where(pending_next, 0, it_next).to(torch.int32)
        else:
            pending_next = false
            stopped = stopped | (run & attempt_over)

        if success_stops_group and len(lane_shape) >= 2:
            # Speed mode: once any restart of a pose succeeds, the pose's
            # remaining lanes freeze (winner = earliest success by
            # iteration, ties broken by lowest restart index).
            pose_done = success.any(dim=group_axis, keepdim=True)
            stopped = stopped | pose_done
            pending_next = pending_next & ~pose_done

        if group_success_cap is not None:
            # Quality truncation-after-k: freeze a pose once its lanes have
            # completed that many successful attempts.
            succ_cnt = succ_cnt + (run & succ_now).to(torch.int32)
            if len(lane_shape) >= 2:
                pose_cnt = succ_cnt.sum(dim=group_axis, keepdim=True)
            else:
                pose_cnt = succ_cnt
            capped = pose_cnt >= group_success_cap
            stopped = stopped | capped
            pending_next = pending_next & ~capped

        xs, e, jt, f = x_next, e_next, jt_next, f_next
        lam, nu = lam_next, nu_next
        stopped = torch.broadcast_to(stopped, lane_shape)
        pending = torch.broadcast_to(pending_next, lane_shape)
        it_lane = it_next
        it += 1

    if track_best:
        return LoopOut(xs=tuple(bx), f=bf, success=torch.isfinite(bd),
                       iters=it, restart_index=bi, succ_iters=succ_it)
    return LoopOut(xs=tuple(xs), f=f, success=success, iters=it,
                   restart_index=cur_idx if reseed else None,
                   succ_iters=succ_it)


def solve_soa(consts, lower, upper, opts: LMOptions,
              x0: torch.Tensor,          # (..., A)
              tgt_r: torch.Tensor,       # (..., 3, 3) broadcastable to lanes
              tgt_t: torch.Tensor,       # (..., 3)
              ee_r: Optional[torch.Tensor] = None,
              ee_t: Optional[torch.Tensor] = None,
              wl=None, wa=None,
              seed_table: Optional[torch.Tensor] = None,  # (R, A)
              lane_index: Optional[torch.Tensor] = None,
              total_restarts: int = 0,
              success_stops_group: bool = False,
              explore_full_budget: bool = False,
              quality_x0: Optional[torch.Tensor] = None,
              group_success_cap: Optional[int] = None,
              approx: bool = False) -> LMResult:
    """Tensor-in/tensor-out wrapper around :func:`lm_loop`.

    Lane axes = x0.shape[:-1]; the seed-group axis (for Speed-mode pose
    freezing) is the last lane axis.
    """
    a = x0.shape[-1]
    lane_shape = x0.shape[:-1]
    s_lanes = lane_shape[-1] if lane_shape else 1

    xs0 = [x0[..., j] for j in range(a)]
    tgtm = [[tgt_r[..., i, j] for j in range(3)] for i in range(3)]
    tgtt = [tgt_t[..., i] for i in range(3)]
    eem = eev = None
    if ee_r is not None:
        eem = [[ee_r[..., i, j] for j in range(3)] for i in range(3)]
        eev = [ee_t[..., i] for i in range(3)]
    weight6 = soa.weight6_from_config(tgtm, wl, wa)

    seed_lookup = None
    if seed_table is not None and total_restarts > s_lanes:
        tables = [seed_table[:, p].to(x0.dtype) for p in range(a)]

        def seed_lookup(idx):
            flat = idx.reshape(-1).long()
            return [t[flat].reshape(idx.shape) for t in tables]

    qx0 = None
    if quality_x0 is not None:
        qx0 = [quality_x0[..., p] for p in range(a)]

    out = lm_loop(consts, lower, upper, opts, xs0, tgtm, tgtt, eem, eev,
                  weight6, seed_lookup=seed_lookup, lane_index=lane_index,
                  total_restarts=total_restarts, s_lanes=s_lanes,
                  success_stops_group=success_stops_group, group_axis=-1,
                  explore_full_budget=explore_full_budget, qx0=qx0,
                  group_success_cap=group_success_cap, approx=approx)

    return LMResult(x=torch.stack(list(out.xs), dim=-1), f=out.f,
                    success=out.success, iters=out.iters,
                    restart_index=out.restart_index,
                    succ_iters=out.succ_iters)
