"""SO(3) Lie-group math on torch tensors, batched and branchless.

A port of ``optik_tpu/math/so3.py`` (which carries the derivations and the
reference citations): the hat operators, the logarithmic map (from a
quaternion or a rotation matrix), the right Jacobian of the log map and
the Rodrigues exponential of a revolute joint.

  * Every function takes arbitrary leading batch dimensions and computes in
    the dtype and on the device of its input; no constant enters as a
    tensor of another dtype.
  * Singularity handling is branchless: the exact trigonometric expression
    and its Taylor expansion are both evaluated on "safe" inputs and
    combined with ``torch.where``, so the functions stay differentiable
    (``torch.autograd`` is a test oracle) and never branch on data.
  * The Taylor switch is ``EPSILON = 1e-6`` on a *squared* angle, as in the
    reference (math.rs:7), so the golden fixtures agree.
  * Quaternions are stored ``(x, y, z, w)``, vector part first.
"""

from __future__ import annotations

import torch

# Threshold on squared rotation-vector / quaternion-vector norms below which
# Taylor expansions replace unstable trigonometric expressions (math.rs:7).
EPSILON = 1e-6


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Hat operator [w]_x: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    rows = [
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def hat2(w: torch.Tensor) -> torch.Tensor:
    """Squared hat operator [w]_x^2 computed directly (symmetric):
    (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    w11, w22, w33 = wx * wx, wy * wy, wz * wz
    w12, w13, w23 = wx * wy, wx * wz, wy * wz
    rows = [
        torch.stack([-w22 - w33, w12, w13], dim=-1),
        torch.stack([w12, -w11 - w33, w23], dim=-1),
        torch.stack([w13, w23, -w11 - w22], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Logarithmic map of SO(3) from a unit quaternion ``(..., 4)`` ordered
    (x, y, z, w): the rotation vector theta * axis, ``(..., 3)``.

    The double cover is handled by flipping to the representative with a
    non-negative scalar part; atan2(|v|, w)/|v| switches to its Taylor
    series below the squared-norm threshold.
    """
    v = q[..., :3]
    w = q[..., 3]
    neg = w < 0.0
    v = torch.where(neg[..., None], -v, v)
    w = torch.where(neg, -w, w)

    v2 = torch.sum(v * v, dim=-1)
    small = v2 <= EPSILON
    v2_safe = torch.where(small, torch.ones_like(v2), v2)
    v_norm = torch.sqrt(v2_safe)
    exact = torch.atan2(v_norm, w) / v_norm
    w3 = w * w * w
    taylor = 1.0 / w - v2 / (3.0 * w3) + (v2 * v2) / (5.0 * w3 * w * w)
    theta_over_norm = torch.where(small, taylor, exact)
    return 2.0 * v * theta_over_norm[..., None]


def mat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (x, y, z, w), branchless.

    Shepperd's method on all four candidate pivots, the winner selected by
    ``where`` masks: stable for every rotation, angles near pi included.
    """
    r00, r01, r02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    r10, r11, r12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    r20, r21, r22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]

    # 4*w^2, 4*x^2, 4*y^2, 4*z^2 (before normalization).
    tw = 1.0 + r00 + r11 + r22
    tx = 1.0 + r00 - r11 - r22
    ty = 1.0 - r00 + r11 - r22
    tz = 1.0 - r00 - r11 + r22

    def safe_sqrt(x):
        return torch.sqrt(x.clamp_min(1e-30))

    sw, sx, sy, sz = safe_sqrt(tw), safe_sqrt(tx), safe_sqrt(ty), safe_sqrt(tz)

    qw = torch.stack([(r21 - r12) / sw, (r02 - r20) / sw, (r10 - r01) / sw,
                      sw], dim=-1)
    qx = torch.stack([sx, (r01 + r10) / sx, (r02 + r20) / sx,
                      (r21 - r12) / sx], dim=-1)
    qy = torch.stack([(r01 + r10) / sy, sy, (r12 + r21) / sy,
                      (r02 - r20) / sy], dim=-1)
    qz = torch.stack([(r02 + r20) / sz, (r12 + r21) / sz, sz,
                      (r10 - r01) / sz], dim=-1)

    # First maximum wins, as argmax does.
    m_w = (tw >= tx) & (tw >= ty) & (tw >= tz)
    m_x = (~m_w) & (tx >= ty) & (tx >= tz)
    m_y = (~m_w) & (~m_x) & (ty >= tz)
    q = torch.where(m_w[..., None], qw,
                    torch.where(m_x[..., None], qx,
                                torch.where(m_y[..., None], qy, qz)))
    q = 0.5 * q
    # Normalize (defends against slightly non-orthonormal inputs).
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (x, y, z, w) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def mat_log(r: torch.Tensor) -> torch.Tensor:
    """Logarithmic map of SO(3) from a rotation matrix: (...,3,3) -> (...,3)."""
    return quat_log(mat_to_quat(r))


def _sin_cos_coeffs(theta2: torch.Tensor):
    """Shared coefficients a = sin(t)/t and b = (1-cos(t))/t^2, branchless.

    ``theta2`` is the squared angle.  Below EPSILON the Taylor expansions
    of the reference (math.rs:78-89) are used.
    """
    small = theta2 <= EPSILON
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    s = torch.sin(theta)
    c = torch.cos(theta)
    theta4 = theta2 * theta2
    a = torch.where(small, 1.0 - theta2 / 6.0 + theta4 / 120.0, s / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0 + theta4 / 720.0,
                    (1.0 - c) / theta2_safe)
    return a, b, small, theta2_safe


def right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of the SO(3) log map: rotation vector (..., 3) ->
    (..., 3, 3).

        J_r = I + 1/2 [w]_x + e(theta) [w]_x^2
        e   = (b - 2c) / (2a),  a = sin(t)/t, b = (1-cos(t))/t^2,
                                c = (1 - a)/t^2

    ``c`` uses its own Taylor series below the threshold (1/6 - t^2/120 +
    t^4/5040), so the result is finite at exactly theta = 0, where the
    reference (math.rs:90) returns NaN.
    """
    theta2 = torch.sum(w * w, dim=-1)
    a, b, small, theta2_safe = _sin_cos_coeffs(theta2)
    theta4 = theta2 * theta2
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta4 / 5040.0,
                    (1.0 - a) / theta2_safe)
    e = (b - 2.0 * c) / (2.0 * a)
    return _eye3(w) + 0.5 * hat(w) + e[..., None, None] * hat2(w)


def rodrigues(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle exponential map (unit axis): (...,3), (...) -> (...,3,3).

        R = I + sin(q) [k]_x + (1 - cos(q)) [k]_x^2

    The axis is a static unit vector per joint, so no small-angle handling
    is needed.
    """
    s = torch.sin(angle)[..., None, None]
    c1 = (1.0 - torch.cos(angle))[..., None, None]
    return _eye3(axis) + s * hat(axis) + c1 * hat2(axis)
