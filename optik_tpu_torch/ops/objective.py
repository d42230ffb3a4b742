"""IK objective on the array path: weighted squared SE(3) log pose error
and its analytic gradient.

A port of ``optik_tpu/ops/objective.py`` (objective.rs of the reference):

  * pose error e = log6(T_target^-1 * T_actual)       (objective.rs:47-51)
  * per-axis weighting by conjugation with R_target    (objective.rs:7-38),
    skipped entirely when the weights are identity
  * cost = ||e||^2                                     (objective.rs:54-57)
  * gradient = 2 (W^2-weighted e)^T (Jlog6(X) J(q))    (objective.rs:60-110)

With M = blockdiag(R^T diag(wl) R, R^T diag(wa) R) the cost is ||M e||^2,
the residual r = M e and its Jacobian J_r = M Jlog6 J, so grad = 2 J_r^T r.
``q`` and the target carry matching leading batch dimensions.  This is the
oracle of the SoA hot path (``ops/soa.residual_and_jtask``): every function
is differentiable, so ``torch.autograd`` checks the closed-form gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..math import se3
from . import kinematics as K
from .soa import IDENTITY_EPS, weights_are_identity  # noqa: F401


def weight_matrix(tgt_r: torch.Tensor, wl, wa) -> Optional[torch.Tensor]:
    """The 6x6 symmetric weighting operator M, or None when identity.

    M = blockdiag(R^T diag(wl) R, R^T diag(wa) R) where R rotates
    target-frame vectors to world (objective.rs:14-22).
    """
    lin_id = weights_are_identity(wl)
    ang_id = weights_are_identity(wa)
    if lin_id and ang_id:
        return None
    eye = torch.eye(3, dtype=tgt_r.dtype, device=tgt_r.device).expand(
        tgt_r.shape)

    def conj(w):
        wv = torch.as_tensor(w, dtype=tgt_r.dtype, device=tgt_r.device)
        return tgt_r.transpose(-1, -2) @ (wv[:, None] * tgt_r)

    m_lin = eye if lin_id else conj(wl)
    m_ang = eye if ang_id else conj(wa)
    zero = torch.zeros_like(m_lin)
    top = torch.cat([m_lin, zero], dim=-1)
    bot = torch.cat([zero, m_ang], dim=-1)
    return torch.cat([top, bot], dim=-2)


def pose_error(ee_r, ee_t, tgt_r, tgt_t) -> torch.Tensor:
    """e = log6(T_target^-1 * T_actual), (..., 6) ordered [linear; angular]."""
    xr, xt = se3.inv_compose(tgt_r, tgt_t, ee_r, ee_t)
    return se3.log(xr, xt)


def objective(params: K.ChainParams, q, tgt_r, tgt_t,
              ee_r=None, ee_t=None, wl=None, wa=None) -> torch.Tensor:
    """Cost ||M e||^2 per configuration, (...,) (objective.rs:40-57)."""
    r, t = K.fk_ee(params, q, ee_r, ee_t)
    e = pose_error(r, t, tgt_r, tgt_t)
    m = weight_matrix(tgt_r, wl, wa)
    if m is not None:
        e = se3._matvec(m, e)
    return torch.sum(e * e, dim=-1)


def residual_and_jacobian(params: K.ChainParams, q, tgt_r, tgt_t,
                          ee_r=None, ee_t=None, wl=None, wa=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(residual, task Jacobian): r = M e (..., 6), J_r = M Jlog6 J
    (..., 6, A), from one FK scan (lib.rs:305-337).  cost = sum(r*r) and
    grad = 2 r @ J_r.
    """
    r, t, jac = K.fk_and_jacobian(params, q, ee_r, ee_t)
    xr, xt = se3.inv_compose(tgt_r, tgt_t, r, t)
    e = se3.log(xr, xt)
    j_task = se3.right_jacobian(xr, xt) @ jac
    m = weight_matrix(tgt_r, wl, wa)
    if m is not None:
        e = se3._matvec(m, e)
        j_task = m @ j_task
    return e, j_task


def objective_grad(params: K.ChainParams, q, tgt_r, tgt_t,
                   ee_r=None, ee_t=None, wl=None, wa=None) -> torch.Tensor:
    """Analytic gradient (..., A), the reference's closed form
    (objective.rs:60-110): 2 r^T J_r of :func:`residual_and_jacobian`."""
    r, j = residual_and_jacobian(params, q, tgt_r, tgt_t, ee_r, ee_t, wl, wa)
    return 2.0 * (r[..., None, :] @ j)[..., 0, :]
