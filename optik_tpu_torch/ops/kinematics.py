"""Batched forward kinematics and geometric Jacobian on the array path.

A port of ``optik_tpu/ops/kinematics.py`` (kinematics.rs:116-196 of the
reference):

  * the joint scan is a Python loop over the A joints of a
    :class:`ChainParams`; the revolute / prismatic choice is branchless
    through the prismatic mask: both cases are the single expression
    ``(Rodrigues(axis, q * (1-m)), axis * (q * m))``;
  * ``q`` carries arbitrary leading batch dimensions ``(..., A)``; every
    result carries the same leading dimensions;
  * the Jacobian is evaluated for all joints at once, in the EE (body)
    frame like the reference, and implements the prismatic column the
    reference left as a ``todo!()`` (kinematics.rs:185): linear = R_wj @
    axis, angular = 0.

The SoA path (``ops/soa.py``) computes the same quantities with the chain's
constants folded as Python floats; this path keeps them as tensors, which is
what the ADMM fallback's QP and the scalar ``Robot.joint_jacobian`` build
on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..math import se3, so3


class ChainParams(NamedTuple):
    """The chain's constants as tensors of one dtype on one device (see
    models/chain.py for their meaning)."""

    origin_r: torch.Tensor   # (A, 3, 3)
    origin_t: torch.Tensor   # (A, 3)
    axis: torch.Tensor       # (A, 3)
    prismatic: torch.Tensor  # (A,)
    lower: torch.Tensor      # (A,)
    upper: torch.Tensor      # (A,)
    tip_r: torch.Tensor      # (3, 3)
    tip_t: torch.Tensor      # (3,)

    @staticmethod
    def from_spec(spec, dtype: torch.dtype = torch.float32, *,
                  device: "str | torch.device") -> "ChainParams":
        def cast(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
                device=device, dtype=dtype)

        return ChainParams(
            origin_r=cast(spec.origin_r),
            origin_t=cast(spec.origin_t),
            axis=cast(spec.axis),
            prismatic=cast(spec.prismatic),
            lower=cast(spec.lower),
            upper=cast(spec.upper),
            tip_r=cast(spec.tip_r),
            tip_t=cast(spec.tip_t),
        )

    @property
    def num_positions(self) -> int:
        return self.axis.shape[0]


def fk_joints(params: ChainParams, q: torch.Tensor):
    """World transforms of every joint frame.

    ``q``: (..., A).  Returns ``(rs, ts)`` of shapes (..., A, 3, 3) and
    (..., A, 3): the running products T_i = prod_{j<=i} origin_j *
    local_j(q_j), the reference's ``ForwardKinematics::joint_tfms``
    (kinematics.rs:142-158).
    """
    pris = params.prismatic
    angle = q * (1.0 - pris)
    slide = q * pris
    r_local = so3.rodrigues(params.axis, angle)        # (..., A, 3, 3)
    t_local = params.axis * slide[..., None]           # (..., A, 3)
    # origin * local for every joint at once, then accumulate in order:
    # T = T_prev * origin * local.
    r_ol = params.origin_r @ r_local
    t_ol = se3._matvec(params.origin_r, t_local) + params.origin_t
    rs, ts = [r_ol[..., 0, :, :]], [t_ol[..., 0, :]]
    for j in range(1, params.num_positions):
        r_prev, t_prev = rs[-1], ts[-1]
        rs.append(r_prev @ r_ol[..., j, :, :])
        ts.append(se3._matvec(r_prev, t_ol[..., j, :]) + t_prev)
    return torch.stack(rs, dim=-3), torch.stack(ts, dim=-2)


def _ee_from_joints(params: ChainParams, rs, ts, ee_r, ee_t):
    r, t = se3.compose(rs[..., -1, :, :], ts[..., -1, :], params.tip_r,
                       params.tip_t)
    if ee_r is not None:
        r, t = se3.compose(r, t, ee_r, ee_t)
    return r, t


def fk_ee(params: ChainParams, q: torch.Tensor, ee_r=None, ee_t=None):
    """End-effector pose ``(r, t)``: last joint frame * tip * ee_offset.

    ``ee_r``/``ee_t`` (the caller's optional EE offset, kinematics.rs:163)
    default to identity.
    """
    rs, ts = fk_joints(params, q)
    return _ee_from_joints(params, rs, ts, ee_r, ee_t)


def joint_jacobian_from_fk(params: ChainParams, rs, ts, ee_r, ee_t):
    """Geometric Jacobian in the EE (local/body) frame, (..., 6, A).

    Row layout ``[linear; angular]`` as in the reference
    (kinematics.rs:166-196).  For joint i with world frame (R_i, p_i):

      revolute:  angular_w = R_i axis,  linear_w = angular_w x (p_ee - p_i)
      prismatic: angular_w = 0,         linear_w = R_i axis

    then both are rotated into the EE frame by R_ee^T.
    """
    dir_w = se3._matvec(rs, params.axis)                       # (..., A, 3)
    m = params.prismatic[:, None]
    ang_w = dir_w * (1.0 - m)
    lin_rev = torch.linalg.cross(dir_w, ee_t[..., None, :] - ts, dim=-1)
    lin_w = torch.where(m > 0.5, dir_w, lin_rev)
    # R_ee^T v for each row v  ==  v @ R_ee.
    ang_l = ang_w @ ee_r
    lin_l = lin_w @ ee_r
    return torch.cat([lin_l.transpose(-1, -2), ang_l.transpose(-1, -2)],
                     dim=-2)


def fk_and_jacobian(params: ChainParams, q: torch.Tensor, ee_r=None,
                    ee_t=None):
    """FK and local-frame Jacobian from one joint scan (lib.rs:313-336).

    Returns ``(ee_r, ee_t, J)`` with J of shape (..., 6, A).
    """
    rs, ts = fk_joints(params, q)
    r, t = _ee_from_joints(params, rs, ts, ee_r, ee_t)
    return r, t, joint_jacobian_from_fk(params, rs, ts, r, t)


def joint_jacobian(params: ChainParams, q: torch.Tensor, ee_r=None,
                   ee_t=None):
    """Convenience: Jacobian only, (..., 6, A)."""
    return fk_and_jacobian(params, q, ee_r, ee_t)[2]
