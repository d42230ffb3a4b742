"""Batched dense QP solver: fixed-iteration ADMM (OSQP-style) with polish.

A port of ``optik_tpu/solver/qp.py``, written over explicit leading batch
dimensions.  Every problem instance is a lane, iterations are lockstep
matrix-vector products with no data-dependent control flow, and the one
factorisation per instance and step size is a small batched Cholesky.

Problem form (OSQP convention):

    minimize    1/2 x^T P x + q^T x
    subject to  l <= A x <= u          (equality rows have l == u)

Algorithm (Stellato et al., "OSQP: An Operator Splitting Solver for
Quadratic Programs", fixed step-rho variant):

    x+ <- solve (P + sigma I + A^T R A) x = sigma x - q + A^T (R z - y)
    z~ <- A x+
    z+ <- clip(alpha z~ + (1-alpha) z + y / rho, l, u)
    y+ <- y + R (alpha z~ + (1-alpha) z - z+)

with per-row rho (R = diag(rho), rho boosted 1e3x on equality rows) and
over-relaxation alpha = 1.6.  A final *polish* solves the KKT system of the
active constraint set exactly (one batched LU), recovering interior-point
accuracy (~1e-10 residuals in float64) from an approximate ADMM active set;
lanes where polish worsens feasibility keep the ADMM iterate.

The factorisations are ``torch.linalg.cholesky_ex`` and ``solve_ex``, which
never raise and never synchronise to look at their status: a lane whose
matrix is not positive definite, or whose KKT system is singular, has its
result set to NaN, and the ``isfinite`` gates below treat it exactly as a
NaN from the factorisation itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QPSolution(NamedTuple):
    x: torch.Tensor           # (..., n) primal solution
    y: torch.Tensor           # (..., m) dual solution
    primal_res: torch.Tensor  # (...,) max |clip-violation of A x|
    dual_res: torch.Tensor    # (...,) max |P x + q + A^T y|


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v[..., None])[..., 0]


def _amax(v: torch.Tensor) -> torch.Tensor:
    return torch.amax(v.abs(), dim=-1)


def _nan_where_failed(t: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    return torch.where((info != 0)[..., None, None], torch.nan, t)


def solve(P, q, A, l, u, *, sigma=1e-6, rho=1.0, rho_eq_scale=1e3,
          alpha=1.6, iters=800, polish_reg=1e-11,
          rho_interval=100) -> QPSolution:
    """Solve a (batch of) dense QPs: ``P`` (..., n, n), ``q`` (..., n),
    ``A`` (..., m, n), ``l``/``u`` (..., m), all with the same leading
    dimensions; scalars-per-problem come back with those dimensions.
    """
    n, m = q.shape[-1], l.shape[-1]
    batch = q.shape[:-1]
    kw = dict(dtype=q.dtype, device=q.device)
    At = A.transpose(-1, -2)

    is_eq = (u - l) <= 1e-12
    rho0 = torch.where(is_eq, torch.full_like(l, rho * rho_eq_scale),
                       torch.full_like(l, rho))
    eye_n = torch.eye(n, **kw)

    def run_block(x, z, y, rho_v):
        """rho_interval lockstep iterations at a fixed rho (one
        factorisation)."""
        K = P + sigma * eye_n + (At * rho_v[..., None, :]) @ A
        chol, info = torch.linalg.cholesky_ex(K, check_errors=False)
        chol = _nan_where_failed(chol, info)
        chol_t = chol.transpose(-1, -2)
        for _ in range(rho_interval):
            rhs = sigma * x - q + _mv(At, rho_v * z - y)
            t = torch.linalg.solve_triangular(chol, rhs[..., None],
                                              upper=False)
            x = torch.linalg.solve_triangular(chol_t, t, upper=True)[..., 0]
            z_tilde = _mv(A, x)
            z_relaxed = alpha * z_tilde + (1.0 - alpha) * z
            z_new = torch.minimum(torch.maximum(z_relaxed + y / rho_v, l), u)
            y = y + rho_v * (z_relaxed - z_new)
            z = z_new
        return x, z, y

    # Adaptive step size (OSQP sec. 5.2): every rho_interval iterations,
    # rescale rho by sqrt(relative primal residual / relative dual residual)
    # when they are imbalanced by >5x, and refactor.  Fixed-rho ADMM stalls
    # on poorly conditioned constraint blocks (small Jacobian singular
    # values); the rebalance restores linear convergence while keeping the
    # lockstep iteration structure (the rho update is a masked multiply,
    # identical across lanes in trip count).
    x = torch.zeros(batch + (n,), **kw)
    z = torch.minimum(torch.maximum(torch.zeros(batch + (m,), **kw), l), u)
    y = torch.zeros(batch + (m,), **kw)
    rho_scale = torch.ones(batch, **kw)
    tiny = 1e-12
    for _ in range(max(1, iters // rho_interval)):
        x, z, y = run_block(x, z, y, rho0 * rho_scale[..., None])
        ax = _mv(A, x)
        px, aty = _mv(P, x), _mv(At, y)
        pr_rel = _amax(ax - z) / torch.maximum(_amax(ax),
                                               _amax(z)).clamp_min(tiny)
        dr_rel = _amax(px + q + aty) / torch.maximum(
            _amax(px), torch.maximum(_amax(aty), _amax(q))).clamp_min(tiny)
        scale = torch.sqrt(pr_rel / dr_rel.clamp_min(tiny)).clamp(1e-3, 1e3)
        apply = (scale > 5.0) | (scale < 0.2)
        rho_scale = torch.where(apply, rho_scale * scale, rho_scale)

    def residuals(xv, yv):
        ax = _mv(A, xv)
        pr = torch.amax((ax - u).clamp_min(0.0) + (l - ax).clamp_min(0.0),
                        dim=-1)
        dr = _amax(_mv(P, xv) + q + _mv(At, yv))
        return pr, dr

    # --- polish: exact KKT solve on the detected active set ---------------
    # Iterated: the first pass detects actives tightly from the ADMM point;
    # a second pass re-detects from the (usually near-exact) polished point
    # with a looser tolerance, catching actives the ADMM iterate had not
    # quite pinned: this is what rescues lanes that stall a hair above the
    # success gate on flat (LP-like) objectives.  Each candidate is kept
    # only if it improves the summed residuals.
    eye_m = torch.eye(m, **kw)

    def polish(xc, yc, tol):
        ax = _mv(A, xc)
        act_low = (~is_eq) & (ax - l <= tol * (1.0 + l.abs())) & (yc < 0)
        act_up = (~is_eq) & (u - ax <= tol * (1.0 + u.abs())) & (yc > 0)
        mask = (is_eq | act_low | act_up).to(q.dtype)
        b_act = torch.where(act_up, u, l)  # equality rows: l == u

        # Masked KKT: [P x + A^T M lam = -q ; M A x - (I - M) lam = M b].
        top = torch.cat([P + polish_reg * eye_n, At * mask[..., None, :]],
                        dim=-1)
        bot = torch.cat([mask[..., :, None] * A,
                         -torch.diag_embed(1.0 - mask) - polish_reg * eye_m],
                        dim=-1)
        kkt = torch.cat([top, bot], dim=-2)
        rhs = torch.cat([-q, mask * b_act], dim=-1)
        sol, info = torch.linalg.solve_ex(kkt, rhs[..., None],
                                          check_errors=False)
        sol = _nan_where_failed(sol, info)[..., 0]
        return sol[..., :n], sol[..., n:]

    x_out, y_out = x, y
    pr, dr = residuals(x, y)
    for tol in (1e-7, 1e-5, 1e-3):
        x_p, y_p = polish(x_out, y_out, tol)
        pr_pol, dr_pol = residuals(x_p, y_p)
        finite = torch.isfinite(x_p).all(dim=-1)
        better = finite & (pr_pol + dr_pol < pr + dr)
        x_out = torch.where(better[..., None], x_p, x_out)
        y_out = torch.where(better[..., None], y_p, y_out)
        pr = torch.where(better, pr_pol, pr)
        dr = torch.where(better, dr_pol, dr)
    return QPSolution(x=x_out, y=y_out, primal_res=pr, dual_res=dr)
