"""SE(3) Lie-group math on torch tensors, batched and branchless.

A port of ``optik_tpu/math/se3.py``: the SE(3) logarithmic map (the
6-vector pose error) and its right Jacobian (the chain-rule factor of the
analytic gradient).  A rigid transform is a pair ``(r, t)``: a rotation
matrix ``(..., 3, 3)`` and a translation ``(..., 3)``.  Twists are ordered
``[linear; angular]`` as in the reference (math.rs:123).

The (1 - p)/theta^2 coefficient of V^{-1}, which the reference evaluates
unguarded (NaN at theta = 0), is replaced below the threshold by its Taylor
series 1/12 + t^2/720 + t^4/30240.
"""

from __future__ import annotations

import torch

from . import so3
from .so3 import EPSILON


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v[..., None])[..., 0]


def log(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE(3) log map: rotation (...,3,3) + translation (...,3) -> twist
    (...,6) ``[v; w]`` with ``w = log(R)`` and ``v = V(w)^{-1} t``,

        V^{-1} = I - 1/2 [w]_x + (1 - p)/theta^2 [w]_x^2,
        p      = 1/2 theta sin(theta) / (1 - cos(theta)).
    """
    w = so3.mat_log(r)
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 <= EPSILON * EPSILON  # reference guards on theta > EPSILON
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    s = torch.sin(theta)
    c = torch.cos(theta)

    coef_exact = (1.0 - 0.5 * theta * s / (1.0 - c)) / theta2_safe
    theta4 = theta2 * theta2
    coef_taylor = 1.0 / 12.0 + theta2 / 720.0 + theta4 / 30240.0
    coef = torch.where(small, coef_taylor, coef_exact)

    v_inv = (so3._eye3(w) - 0.5 * so3.hat(w)
             + coef[..., None, None] * so3.hat2(w))
    return torch.cat([_matvec(v_inv, t), w], dim=-1)


def right_jacobian_q(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Upper-right 3x3 block Q(v, w) of the SE(3) log right Jacobian, the
    Pinocchio-derived closed form of the reference (math.rs:135-170):

        a = 1/t^2 - sin(t)/(2 t (1-cos t)),
        b = -2/t^4 + (1 + sin(t)/t) / (2 t^2 (1-cos t)),
        (Taylor below threshold: a = 1/12 + t^2/720, b = 1/360)
        d = <w, v>
        cvec = b d w - (t^2 b + 2 a) v
        C = 1/2 [v]_x + cvec w^T + a w v^T + d a I
        Q = C * J_r(w)
    """
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 <= EPSILON
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    theta4_safe = theta2_safe * theta2_safe
    s = torch.sin(theta)
    c = torch.cos(theta)

    s_t = s / theta
    inv_1mc = 1.0 / (2.0 * (1.0 - c))
    a_exact = 1.0 / theta2_safe - s_t * inv_1mc
    b_exact = -2.0 / theta4_safe + (1.0 + s_t) * inv_1mc / theta2_safe

    a_taylor = 1.0 / 12.0 + theta2 / 720.0
    b_taylor = torch.full_like(theta2, 1.0 / 360.0)

    a = torch.where(small, a_taylor, a_exact)
    b = torch.where(small, b_taylor, b_exact)

    d = torch.sum(w * v, dim=-1)
    cvec = (b * d)[..., None] * w - (theta2 * b + 2.0 * a)[..., None] * v

    C = (0.5 * so3.hat(v)
         + cvec[..., :, None] * w[..., None, :]
         + a[..., None, None] * v[..., None, :] * w[..., :, None]
         + (d * a)[..., None, None] * so3._eye3(w))
    return C @ so3.right_jacobian(w)


def right_jacobian(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of the SE(3) log map: (...,3,3), (...,3) -> (...,6,6).

        [[ J_r(w)  Q(t, w) ]
         [   0     J_r(w)  ]]
    """
    w = so3.mat_log(r)
    j = so3.right_jacobian(w)
    q = right_jacobian_q(t, w)
    top = torch.cat([j, q], dim=-1)
    bot = torch.cat([torch.zeros_like(j), j], dim=-1)
    return torch.cat([top, bot], dim=-2)


# --- Small transform helpers (FK / objective / solver) ----------------------


def compose(ra, ta, rb, tb):
    """(Ra, ta) * (Rb, tb) -> (Ra Rb, Ra tb + ta), batched."""
    return ra @ rb, _matvec(ra, tb) + ta


def inv_compose(ra, ta, rb, tb):
    """(Ra, ta)^{-1} * (Rb, tb), batched (the target-frame error transform)."""
    rat = ra.transpose(-1, -2)
    return rat @ rb, _matvec(rat, tb - ta)
