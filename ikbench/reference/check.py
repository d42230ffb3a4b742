"""The comparison that decides ``correct``, and the control that must fail
it.

Both judge a sample of answers that the timed path produced, drawn from
the run's seed.  Each number is a share of the sample whose answer the
plain reference rejects; the cell's file (``ikbench/cells/<cell>.json``)
holds its limit, set from the program's and the control's readings on the
chip.

IK, per pose (:func:`ik_numbers`), the answer is rejected when:

* its ``found`` differs from the reference's Speed-mode answer
  (``lm.solve``, float64, on the same targets, seeds and restart stream);
* both found, and its ``x`` lies more than ``X_TOL`` from the reference's
  in some joint: another restart won, or another solution was taken;
* found, and the float64 cost of its ``x`` exceeds ``tol_f`` by more than
  ``COST_SLACK`` (not a solution), or its reported ``cost`` differs from
  that float64 cost by more than ``COST_GAP`` of ``tol_f``, or its ``x``
  leaves the joint limits by more than ``LIMIT_TOL``.

Diff-IK, per lane (:func:`diffik_numbers`), the step is rejected when it
is not ``ok``, or its tracking residual against the float64 Jacobian
(``diffik.tracking_residual``) exceeds ``RESID_TOL``, or ``|alpha -
alpha*|`` exceeds ``ALPHA_TOL``, or ``alpha`` leaves [0, 1] or a ``|v_i|``
its ``v_max`` by more than ``BOUND_TOL``.

The control (:func:`ik_control`, :func:`diffik_control`) is the reference
put in the program's place in bfloat16, the precision below the
configuration's float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import diffik as ref_diffik
from . import lm
from .chain import Chain, pose_error
from .seeds import restart_table

X_TOL = 1e-2          # rad or m: a different restart or solution
COST_SLACK = 1e-2     # share of tol_f: float32 rounding of a solution
COST_GAP = 1e-2       # share of tol_f: the reported cost against float64
LIMIT_TOL = 1e-6      # float32 rounding of a limit
RESID_TOL = 2e-5      # the port's own gate is 1e-5 on its float32 J
ALPHA_TOL = 1e-3
BOUND_TOL = 1e-6
BLOCK = 2048          # poses per block of the reference solve


def restart_stream(chain: Chain, solver: dict, dtype, device):
    """The (R, A) restart stream of the solver's settings."""
    lo, hi = chain.sample_box()
    tab = restart_table(solver.get("rng_seed", 42), solver["max_restarts"],
                        lo, hi)
    return torch.tensor(tab, device=device).to(dtype)


def ik_answers(chain: Chain, solver: dict, tgt_r, tgt_t, x0, dtype,
               seed_ranks: int = 1) -> lm.Answer:
    """The Speed-mode answers of the sampled poses in ``dtype``."""
    cast = [t.to(dtype) for t in (tgt_r, tgt_t, x0)]
    table = restart_stream(chain, solver, dtype, x0.device)
    return lm.solve_blocks(chain, *cast, table, block=BLOCK,
                           s=solver["seed_batch"],
                           max_iters=solver["max_iters"],
                           tol_f=solver["tol_f"], seed_ranks=seed_ranks)


def ik_numbers(chain: Chain, solver: dict, inputs, answers,
               seed_ranks: int = 1) -> Tuple[Dict[str, float], dict]:
    """``(numbers, diagnostics)`` for the sampled poses: ``inputs`` =
    (tgt_r, tgt_t, x0), ``answers`` = (found, x, cost), tensors on one
    device."""
    tgt_r, tgt_t, x0 = (t.double() for t in inputs)
    found, x, cost = answers
    x, cost = x.double(), cost.double()
    ref = ik_answers(chain, solver, tgt_r, tgt_t, x0, torch.float64,
                     seed_ranks)
    tol = solver["tol_f"]
    e = pose_error(chain, x, tgt_r, tgt_t)
    cost64 = (e * e).sum(-1)
    lo = torch.tensor(chain.lower, dtype=x.dtype, device=x.device)
    hi = torch.tensor(chain.upper, dtype=x.dtype, device=x.device)
    outside = torch.maximum(lo - x, x - hi).amax(dim=1).clamp_min(0)
    dx = (x - ref.x).abs().amax(dim=1)
    both = found & ref.found
    bad = (found != ref.found) | (both & (dx > X_TOL))
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
            "x_differs": int((both & (dx > X_TOL)).sum()),
            "x_gap_median": float(dx[both].median()) if bool(both.any())
            else 0.0,
            "cost64_over_tol_max": top(cost64, found) / tol,
            "cost_gap_over_tol_max": top((cost - cost64).abs(), found) / tol,
            "limit_excess_max": top(outside, found),
            "ref_lane_iters_per_solve": ref.lane_iters / max(n, 1)}
    return {"mismatch_share": int(bad.sum()) / max(n, 1)}, diag


def ik_control(chain: Chain, solver: dict, inputs, seed_ranks: int = 1):
    """The control's answers (found, x, cost) for the sampled poses."""
    ans = ik_answers(chain, solver, *inputs, torch.bfloat16, seed_ranks)
    return ans.found, ans.x, ans.cost


def diffik_numbers(chain: Chain, inputs, answers
                   ) -> Tuple[Dict[str, float], dict]:
    """``(numbers, diagnostics)`` for the sampled lanes: ``inputs`` =
    (x0, V_WE, v_max), ``answers`` = (alpha, v, ok)."""
    x0, vel, vmax = (t.double() for t in inputs)
    alpha, v, ok = answers
    alpha, v = alpha.double().cpu().numpy(), v.double().cpu().numpy()
    ok = ok.cpu().numpy().astype(bool)
    jac = chain.world_jacobian(x0).cpu().numpy()
    vel, vmax = vel.cpu().numpy(), vmax.cpu().numpy()
    star = np.array([ref_diffik.optimum(jac[i], vel[i], vmax[i])[0]
                     for i in range(x0.shape[0])])
    resid = ref_diffik.tracking_residual(jac, vel, alpha, v)
    gap = np.abs(alpha - star)
    excess = np.maximum.reduce([(np.abs(v) - vmax).max(axis=1),
                                alpha - 1.0, -alpha])
    bad = (~ok) | ~(resid <= RESID_TOL) | ~(gap <= ALPHA_TOL) \
        | ~(excess <= BOUND_TOL)
    n = int(ok.shape[0])

    def top(t):
        return float(t[ok].max()) if ok.any() else 0.0

    diag = {"sampled": n, "ok": int(ok.sum()),
            "rejected_ok": int((bad & ok).sum()),
            "resid_max": top(resid), "alpha_gap_max": top(gap),
            "bound_excess_max": top(excess),
            "alpha_star_median": float(np.median(star))}
    return {"bad_share": int(bad.sum()) / max(n, 1)}, diag


def diffik_control(chain: Chain, inputs):
    """The control's steps (alpha, v, ok) for the sampled lanes: the
    Jacobian and the command in bfloat16, the LP's optimum rounded to
    bfloat16, every lane ``ok``."""
    x0, vel, vmax = (t.to(torch.bfloat16) for t in inputs)
    jac = chain.world_jacobian(x0).double().cpu().numpy()
    vel64, vmax64 = vel.double().cpu().numpy(), vmax.double().cpu().numpy()
    steps = [ref_diffik.optimum(jac[i], vel64[i], vmax64[i])
             for i in range(jac.shape[0])]
    alpha = torch.tensor([s[0] for s in steps]).to(torch.bfloat16)
    v = torch.tensor(np.stack([s[1] for s in steps])).to(torch.bfloat16)
    return alpha, v, torch.ones(alpha.shape, dtype=torch.bool)
