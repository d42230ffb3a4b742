"""LM solver options and per-lane results (``optik_tpu/solver/lm.py:40-65``).

Stopping-criterion semantics mirror NLopt's as configured by the reference
(lib.rs:345-356, success classification lib.rs:376-388):
  * ``f <= tol_f``                        -> stop, success (stopval)
  * ``|df| < tol_df`` on an accepted step -> stop; success only if the user
    set tol_df >= 0 (otherwise it is the stall heuristic, lib.rs:283-293)
  * ``max|dx| < tol_dx`` on an accepted step -> stop; success only if the
    user set tol_dx >= 0 (criterion disabled when tol_dx < 0, like NLopt)

:func:`solve` is the array-path solver (``optik_tpu/solver/lm.py:71-207``):
one lockstep projected LM over L lanes on ``ops/objective.py``'s residual
and Jacobian, a batched 6x6 Cholesky per iteration.  It is the independent
oracle of the SoA loop (:mod:`optik_tpu_torch.solver.lm_soa`, the port's
production solver): no reseeding, no pose groups, every lane one attempt.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import kinematics as K
from ..ops import objective as O


class LMOptions(NamedTuple):
    """Static solver options."""

    max_iters: int = 64
    tol_f: float = 1e-6
    tol_df: float = 1e-9       # effective value (stall heuristic applied)
    tol_dx: float = -1.0
    df_is_success: bool = False
    dx_is_success: bool = False
    f_is_success: bool = True  # tol_f >= 0 (lib.rs:376-377)
    lam_init: float = 1e-4
    lam_min: float = 1e-14
    lam_max: float = 1e10


class LMResult(NamedTuple):
    x: torch.Tensor        # (..., A) final iterates
    f: torch.Tensor        # (...,) final costs
    success: torch.Tensor  # (...,) bool
    iters: int             # loop iterations executed
    # Restart index each lane ended on (continuous-reseed path only);
    # None when each lane ran exactly one restart.
    restart_index: Optional[torch.Tensor] = None
    # Per-lane attempt iterations at first success, 0 if never.
    succ_iters: Optional[torch.Tensor] = None
    # Per-lane iterations executed before the lane stopped (int32); only
    # with ``track_active=True``.
    active_iters: Optional[torch.Tensor] = None


def solve(params: K.ChainParams,
          x0: torch.Tensor,              # (L, A) initial lanes
          tgt_r: torch.Tensor,           # (L, 3, 3) or (3, 3)
          tgt_t: torch.Tensor,           # (L, 3) or (3,)
          opts: LMOptions,
          ee_r: Optional[torch.Tensor] = None,
          ee_t: Optional[torch.Tensor] = None,
          wl=None, wa=None) -> LMResult:
    """Run lockstep projected LM on L lanes.

    Targets may be per-lane or a single broadcast pose.  Joint limits come
    from ``params``; lanes are clipped into the box at every step.  The
    loop syncs with the device once per iteration (its stop test).
    """
    n_lanes = x0.shape[0]
    lb, ub = params.lower, params.upper

    def rj(q):
        return O.residual_and_jacobian(params, q, tgt_r, tgt_t, ee_r, ee_t,
                                       wl, wa)

    def cost(q):
        return O.objective(params, q, tgt_r, tgt_t, ee_r, ee_t, wl, wa)

    eye6 = torch.eye(6, dtype=x0.dtype, device=x0.device)
    x, f = x0, cost(x0)
    # NLopt's stopval check applies to every evaluation including the first.
    success = (f <= opts.tol_f) if opts.f_is_success \
        else torch.zeros_like(f, dtype=torch.bool)
    # Guard NaN/inf seeds (e.g. unreachable targets producing degenerate FK).
    stopped = success | ~torch.isfinite(f)
    lam = torch.full((n_lanes,), opts.lam_init, dtype=x0.dtype,
                     device=x0.device)
    nu = torch.full_like(lam, 2.0)
    it = 0
    while it < opts.max_iters and not bool(stopped.all()):
        r, j = rj(x)                                   # (L, 6), (L, 6, A)
        # Damped GN via push-through: delta = -J^T (J J^T + lam I)^{-1} r,
        # a 6x6 SPD solve per lane; a factorisation that fails gives NaN
        # (as the JAX package's Cholesky does), which the finite test
        # rejects.
        sys_m = j @ j.transpose(-1, -2) + lam[:, None, None] * eye6
        chol, info = torch.linalg.cholesky_ex(sys_m)
        chol = torch.where((info == 0)[:, None, None], chol, torch.nan)
        y = torch.linalg.solve_triangular(chol, r[..., None], upper=False)
        z = torch.linalg.solve_triangular(chol.transpose(-1, -2), y,
                                          upper=True)
        delta = -(j.transpose(-1, -2) @ z)[..., 0]      # (L, A)

        x_new = torch.clamp(x + delta, lb, ub)
        step = x_new - x                               # the projected step
        f_new = cost(x_new)

        finite = torch.isfinite(f_new)
        accept = (f_new < f) & finite

        # Nielsen gain ratio on the projected step.
        w = (j @ step[..., None])[..., 0]
        pred = -(2.0 * torch.sum(r * w, dim=-1) + torch.sum(w * w, dim=-1))
        rho = (f - f_new) / pred.clamp_min(1e-300)
        good = accept & (pred > 0)
        shrink = (1.0 - (2.0 * rho - 1.0) ** 3).clamp_min(1.0 / 3.0)

        x_next = torch.where(accept[:, None], x_new, x)
        f_next = torch.where(accept, f_new, f)
        lam_next = torch.clamp(torch.where(good, lam * shrink, lam * nu),
                               opts.lam_min, opts.lam_max)
        nu_next = torch.where(good, 2.0, (nu * 2.0).clamp_max(64.0))

        # --- stopping criteria (only for lanes still running) -------------
        newly_f = (f_next <= opts.tol_f) if opts.f_is_success \
            else torch.zeros_like(accept)
        newly_df = accept & ((f - f_next).abs() < opts.tol_df)
        if opts.tol_dx >= 0.0:
            newly_dx = accept & (step.abs() < opts.tol_dx).all(dim=-1)
        else:
            newly_dx = torch.zeros_like(accept)
        # A lane whose damping has exploded is stuck: stop it.
        newly_stuck = lam_next >= opts.lam_max

        run = ~stopped
        succ_now = newly_f
        if opts.df_is_success:
            succ_now = succ_now | newly_df
        if opts.dx_is_success:
            succ_now = succ_now | newly_dx
        success = success | (run & succ_now)
        # Frozen lanes keep their state.
        x = torch.where(stopped[:, None], x, x_next)
        f = torch.where(stopped, f, f_next)
        lam = torch.where(stopped, lam, lam_next)
        nu = torch.where(stopped, nu, nu_next)
        stopped = stopped | (run & (newly_f | newly_df | newly_dx
                                    | newly_stuck))
        it += 1
    return LMResult(x=x, f=f, success=success, iters=it)
