"""Differential IK, worked out plainly: the velocity-limited step as the
linear program it is, solved by scipy's HiGHS in float64.

    max alpha  s.t.  J_W(q) v = alpha V,  -v_max <= v <= v_max,
                     0 <= alpha <= 1

``J_W`` is the world-frame geometric Jacobian (linear rows first) of
``chain.Chain.world_jacobian``.  The optimum ``alpha*`` is unique (``v``
need not be: a 7-joint arm has a null space), so an answer is judged by
its ``alpha`` against ``alpha*`` and by the feasibility of its ``v``.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linprog


def optimum(jac: np.ndarray, vel: np.ndarray, v_max: np.ndarray):
    """``(alpha*, v)`` for one lane: ``jac`` (6, A), ``vel`` (6,),
    ``v_max`` (A,), float64."""
    a = jac.shape[1]
    cost = np.zeros(a + 1)
    cost[-1] = -1.0
    a_eq = np.concatenate([jac, -vel[:, None]], axis=1)
    bounds = [(-float(m), float(m)) for m in v_max] + [(0.0, 1.0)]
    res = linprog(cost, A_eq=a_eq, b_eq=np.zeros(6), bounds=bounds,
                  method="highs")
    if res.status != 0:
        raise RuntimeError(f"the reference LP failed: {res.message}")
    return float(res.x[-1]), res.x[:-1]


def tracking_residual(jac, vel, alpha, v) -> np.ndarray:
    """``|J_W v - alpha V|_inf / (1 + |V|_inf)`` per lane, float64: the
    tracking error of a returned step relative to the command's size."""
    err = np.einsum("lij,lj->li", jac, v) - alpha[:, None] * vel
    return np.abs(err).max(axis=1) / (1.0 + np.abs(vel).max(axis=1))
