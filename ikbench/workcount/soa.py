"""Structure-of-arrays math of the LM residual and task Jacobian, frozen.

A verbatim copy of ``optik_tpu_torch/ops/soa.py`` at commit d444d89 (itself
a line-for-line port of ``optik_tpu/ops/soa.py``), kept so that the FP32
operations per lane-iteration frozen in ``ikbench/configs/*.json`` can be
counted again (``ops.py``) whatever later changes the program makes.  It is
not run by the benchmark.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

# Taylor-switch threshold of the rotation logs (optik_tpu/math/so3.py).
EPSILON = 1e-6

# Weight-is-identity threshold (optik_tpu/ops/objective.py, objective.rs:5).
IDENTITY_EPS = 1e-20

Mat = List[List]
Vec = List


# --- kernel math: polynomial atan2 and sincos -------------------------------


def _atan_nonneg(t):
    """atan(t) for t >= 0, branchless (Cephes atanf range reduction +
    degree-4 polynomial in t^2; public-domain constants)."""
    big = t > 2.414213562373095    # tan(3*pi/8)
    mid = (t > 0.4142135623730950) & ~big  # tan(pi/8)
    x = torch.where(big, -1.0 / t.clamp_min(1e-30),
                    torch.where(mid, (t - 1.0) / (t + 1.0), t))
    zeros = torch.zeros_like(t)
    y0 = torch.where(big, zeros + math.pi / 2,
                     torch.where(mid, zeros + math.pi / 4, zeros))
    z = x * x
    p = ((8.05374449538e-2 * z - 1.38776856032e-1) * z
         + 1.99777106478e-1) * z - 3.33329491539e-1
    return y0 + p * z * x + x


def atan2_nonneg(y, x, approx: bool = False):
    """atan2(y, x) restricted to y >= 0 (quadrants I/II)."""
    if not approx:
        return torch.atan2(y, x)
    r = _atan_nonneg(y / x.abs().clamp_min(1e-30))
    return torch.where(x < 0, math.pi - r, r)


# Cody-Waite pi/2 split (2x the Cephes sinf DP1/DP2/DP3 constants).
_PIO2_A = 1.5703125
_PIO2_B = 4.837512969970703e-4
_PIO2_C = 7.549789948768648e-8


def sincos(x, approx: bool = False):
    """(sin x, cos x); in kernel math mode one shared Cody-Waite reduction
    and the two Cephes f32 minimax polynomials (~1e-7 abs error)."""
    if not approx:
        return torch.sin(x), torch.cos(x)
    k = torch.floor(x * (2.0 / math.pi) + 0.5)
    r = x - k * _PIO2_A
    r = r - k * _PIO2_B
    r = r - k * _PIO2_C
    z = r * r
    sp = r + r * z * (-1.6666654611e-1
                      + z * (8.3321608736e-3 + z * (-1.9515295891e-4)))
    cp = 1.0 - 0.5 * z + z * z * (
        4.166664568298827e-2
        + z * (-1.388731625493765e-3 + z * 2.443315711809948e-5))
    j = k - 4.0 * torch.floor(k * 0.25)  # k mod 4, as floats
    swap = (j == 1.0) | (j == 3.0)
    s_abs = torch.where(swap, cp, sp)
    c_abs = torch.where(swap, sp, cp)
    s = torch.where((j == 2.0) | (j == 3.0), -s_abs, s_abs)
    c = torch.where((j == 1.0) | (j == 2.0), -c_abs, c_abs)
    return s, c


# --- static-sparsity scalar ops (optik_tpu/ops/soa.py:120-173) ---------------


def _static(v) -> bool:
    return isinstance(v, (int, float))


def smul(a, b):
    if _static(a) and _static(b):
        return a * b
    if _static(a):
        a, b = b, a
    if _static(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return -a
    return a * b


def sadd(a, b):
    if _static(a) and a == 0.0:
        return b
    if _static(b) and b == 0.0:
        return a
    return a + b


def ssub(a, b):
    if _static(b) and b == 0.0:
        return a
    if _static(a) and a == 0.0:
        return -b
    return a - b


def ssum(terms):
    acc = 0.0
    for t in terms:
        acc = sadd(acc, t)
    return acc


def mat_mul(a: Mat, b: Mat) -> Mat:
    n, k, m = len(a), len(b), len(b[0])
    return [[ssum([smul(a[i][p], b[p][j]) for p in range(k)])
             for j in range(m)] for i in range(n)]


def mat_vec(a: Mat, v: Vec) -> Vec:
    return [ssum([smul(a[i][j], v[j]) for j in range(len(v))])
            for i in range(len(a))]


def mat_tvec(a: Mat, v: Vec) -> Vec:
    """a^T v."""
    return [ssum([smul(a[j][i], v[j]) for j in range(len(a))])
            for i in range(len(a[0]))]


def mat_t(a: Mat) -> Mat:
    return [[a[j][i] for j in range(len(a))] for i in range(len(a[0]))]


def vec_add(u: Vec, v: Vec) -> Vec:
    return [sadd(ui, vi) for ui, vi in zip(u, v)]


def vec_sub(u: Vec, v: Vec) -> Vec:
    return [ssub(ui, vi) for ui, vi in zip(u, v)]


def vec_scale(u: Vec, s) -> Vec:
    return [smul(ui, s) for ui in u]


def vec_dot(u: Vec, v: Vec):
    return ssum([smul(ui, vi) for ui, vi in zip(u, v)])


def vec_cross(u: Vec, v: Vec) -> Vec:
    return [ssub(smul(u[1], v[2]), smul(u[2], v[1])),
            ssub(smul(u[2], v[0]), smul(u[0], v[2])),
            ssub(smul(u[0], v[1]), smul(u[1], v[0]))]


def cholesky_factor(a: Mat) -> Mat:
    """Unrolled Cholesky factor of an SPD matrix on components; the factor
    keeps 1/L_jj on its diagonal (one rsqrt per column, no divisions)."""
    n = len(a)
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        inv_d = torch.rsqrt(s.clamp_min(1e-30))
        l[j][j] = inv_d
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d
    return l


def cholesky_apply(l: Mat, b: Vec) -> Vec:
    """Solve (L L^T) x = b by both substitutions, ``l`` from
    :func:`cholesky_factor`."""
    n = len(b)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s * l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s * l[i][i]
    return x


def cholesky_solve(a: Mat, b: Vec) -> Vec:
    """Unrolled SPD solve on components."""
    return cholesky_apply(cholesky_factor(a), b)


# --- SO(3) ------------------------------------------------------------------


def rodrigues(axis: Vec, angle, approx: bool = False) -> Mat:
    """R = I + sin(q) K + (1-cos(q)) K^2 for a (static) unit axis."""
    s, c = sincos(angle, approx)
    c1 = 1.0 - c
    kx, ky, kz = axis

    def diag(kk):  # 1 + c1 * (kk - 1) with kk = sum of squared others
        if kk == 1.0:
            return c  # axis-aligned: 1 - c1
        return sadd(1.0, smul(c1, -kk))

    def off(sk, ka, kb):  # sk * s + c1 * (ka * kb)
        return sadd(smul(sk, s), smul(ka * kb, c1))

    return [
        [diag(ky * ky + kz * kz), off(-kz, kx, ky), off(ky, kx, kz)],
        [off(kz, kx, ky), diag(kx * kx + kz * kz), off(-kx, ky, kz)],
        [off(-ky, kx, kz), off(kx, ky, kz), diag(kx * kx + ky * ky)],
    ]


def mat_to_quat(r: Mat) -> Vec:
    """Branchless Shepperd: the unit quaternion (x, y, z, w) of R."""
    r00, r01, r02 = r[0]
    r10, r11, r12 = r[1]
    r20, r21, r22 = r[2]
    tw = 1.0 + r00 + r11 + r22
    tx = 1.0 + r00 - r11 - r22
    ty = 1.0 - r00 + r11 - r22
    tz = 1.0 - r00 - r11 + r22

    def ss(v):
        return torch.sqrt(v.clamp_min(1e-30))

    sw, sx, sy, sz = ss(tw), ss(tx), ss(ty), ss(tz)
    qw = [(r21 - r12) / sw, (r02 - r20) / sw, (r10 - r01) / sw, sw]
    qx = [sx, (r01 + r10) / sx, (r02 + r20) / sx, (r21 - r12) / sx]
    qy = [(r01 + r10) / sy, sy, (r12 + r21) / sy, (r02 - r20) / sy]
    qz = [(r02 + r20) / sz, (r12 + r21) / sz, sz, (r10 - r01) / sz]

    m_w = (tw >= tx) & (tw >= ty) & (tw >= tz)
    m_x = (~m_w) & (tx >= ty) & (tx >= tz)
    m_y = (~m_w) & (~m_x) & (ty >= tz)
    q = [torch.where(m_w, qw[i], torch.where(m_x, qx[i], torch.where(
        m_y, qy[i], qz[i]))) for i in range(4)]
    norm = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    return [qi / norm for qi in q]


def quat_log(q: Vec, approx: bool = False) -> Vec:
    """Rotation-vector log of a unit quaternion (x, y, z, w), on the w >= 0
    cover, with a Taylor series where |v|^2 <= EPSILON (the identity)."""
    x, y, z, w = q
    neg = w < 0.0
    x, y, z, w = (torch.where(neg, -x, x), torch.where(neg, -y, y),
                  torch.where(neg, -z, z), torch.where(neg, -w, w))
    v2 = x * x + y * y + z * z
    small = v2 <= EPSILON
    vn = torch.sqrt(torch.where(small, 1.0, v2))
    exact = atan2_nonneg(vn, w, approx) / vn
    w3 = w * w * w
    taylor = 1.0 / w - v2 / (3.0 * w3) + (v2 * v2) / (5.0 * w3 * w * w)
    t = 2.0 * torch.where(small, taylor, exact)
    return [x * t, y * t, z * t]


def mat_log(r: Mat, approx: bool = False) -> Vec:
    return quat_log(mat_to_quat(r), approx)


def add_hat_terms(diag, w: Vec, c_hat, c_hat2) -> Mat:
    """diag*I + c_hat*[w]_x + c_hat2*[w]_x^2, expanded."""
    wx, wy, wz = w
    w11, w22, w33 = wx * wx, wy * wy, wz * wz
    w12, w13, w23 = wx * wy, wx * wz, wy * wz
    return [
        [diag + c_hat2 * (-w22 - w33),
         -c_hat * wz + c_hat2 * w12,
         c_hat * wy + c_hat2 * w13],
        [c_hat * wz + c_hat2 * w12,
         diag + c_hat2 * (-w11 - w33),
         -c_hat * wx + c_hat2 * w23],
        [-c_hat * wy + c_hat2 * w13,
         c_hat * wx + c_hat2 * w23,
         diag + c_hat2 * (-w11 - w22)],
    ]


def rot_log_terms(r: Mat, approx: bool = False):
    """Rotation log + exact trig of its angle: (w, (theta, theta2, sin,
    cos)) from R, with one sqrt and one atan2 (optik_tpu/ops/soa.py:348)."""
    r00, r01, r02 = r[0]
    r10, r11, r12 = r[1]
    r20, r21, r22 = r[2]
    tw = 1.0 + r00 + r11 + r22
    tx = 1.0 + r00 - r11 - r22
    ty = 1.0 - r00 + r11 - r22
    tz = 1.0 - r00 - r11 + r22
    a01 = r01 + r10
    a02 = r02 + r20
    a12 = r12 + r21
    s21 = r21 - r12
    s02 = r02 - r20
    s10 = r10 - r01
    # Per-component Shepperd candidates, ordered (w-, x-, y-, z-branch).
    cand_x = (s21, tx, a01, a02)
    cand_y = (s02, a01, ty, a12)
    cand_z = (s10, a02, a12, tz)
    cand_w = (tw, s21, s02, s10)
    m_w = (tw >= tx) & (tw >= ty) & (tw >= tz)
    m_x = (~m_w) & (tx >= ty) & (tx >= tz)
    m_y = (~m_w) & (~m_x) & (ty >= tz)

    def pick(c):
        return torch.where(m_w, c[0], torch.where(
            m_x, c[1], torch.where(m_y, c[2], c[3])))

    x, y, z, w = pick(cand_x), pick(cand_y), pick(cand_z), pick(cand_w)
    neg = w < 0.0  # double cover: w >= 0
    x, y, z, w = (torch.where(neg, -x, x), torch.where(neg, -y, y),
                  torch.where(neg, -z, z), torch.where(neg, -w, w))

    v2 = x * x + y * y + z * z
    n2 = v2 + w * w
    vn = torch.sqrt(v2)
    half = atan2_nonneg(vn, w, approx)  # theta/2, in [0, pi/2]
    theta = 2.0 * half
    small = v2 <= EPSILON * n2
    inv_w = 1.0 / torch.where(small, w.clamp_min(1e-30), w)
    u = v2 * inv_w * inv_w
    taylor = inv_w * (1.0 - u / 3.0 + (u * u) / 5.0)
    tt = 2.0 * torch.where(small, taylor, half / torch.where(small, 1.0, vn))
    w_log = [x * tt, y * tt, z * tt]
    inv_n2 = 1.0 / n2
    sin_t = 2.0 * vn * w * inv_n2
    cos_t = (w * w - v2) * inv_n2
    return w_log, (theta, theta * theta, sin_t, cos_t)


def _trig_from_w(w: Vec, approx: bool = False):
    """(theta, theta2, sin, cos) of a rotation vector's angle."""
    theta2 = vec_dot(w, w)
    theta = torch.sqrt(theta2)
    s, c = sincos(theta, approx)
    return theta, theta2, s, c


def _hat_coeffs_trig(trig):
    """a = sin(t)/t, b = (1-cos t)/t^2, branchless, from shared trig."""
    theta, theta2, s, c = trig
    small = theta2 <= EPSILON
    inv_t2 = 1.0 / torch.where(small, 1.0, theta2)
    t4 = theta2 * theta2
    a = torch.where(small, 1.0 - theta2 / 6.0 + t4 / 120.0,
                    s * theta * inv_t2)
    b = torch.where(small, 0.5 - theta2 / 24.0 + t4 / 720.0,
                    (1.0 - c) * inv_t2)
    return a, b, small, inv_t2


def so3_right_jacobian_trig(w: Vec, trig) -> Mat:
    a, b, small, inv_t2 = _hat_coeffs_trig(trig)
    theta2 = trig[1]
    t4 = theta2 * theta2
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0,
                    (1.0 - a) * inv_t2)
    e = (b - 2.0 * c) / (2.0 * a)
    return add_hat_terms(1.0, w, 0.5, e)


def so3_right_jacobian_from_w(w: Vec, approx: bool = False) -> Mat:
    return so3_right_jacobian_trig(w, _trig_from_w(w, approx))


# --- SE(3) ------------------------------------------------------------------


def se3_log_trig(w: Vec, t: Vec, trig) -> Vec:
    """[v; w] with v = V^{-1} t, given w = log(R) and its trig."""
    theta, theta2, s, c = trig
    small = theta2 <= EPSILON
    inv_t2 = 1.0 / torch.where(small, 1.0, theta2)
    coef_exact = (1.0 - 0.5 * theta * s
                  / (1.0 - c).clamp_min(1e-30)) * inv_t2
    t4 = theta2 * theta2
    coef_taylor = 1.0 / 12.0 + theta2 / 720.0 + t4 / 30240.0
    coef = torch.where(small, coef_taylor, coef_exact)
    v_inv = add_hat_terms(1.0, w, -0.5, coef)
    v = mat_vec(v_inv, t)
    return v + list(w)


def se3_log_from_w(w: Vec, t: Vec, approx: bool = False) -> Vec:
    return se3_log_trig(w, t, _trig_from_w(w, approx))


def se3_log(r: Mat, t: Vec, approx: bool = False) -> Vec:
    """[v; w] = log of the rigid transform (R, t)."""
    w, trig = rot_log_terms(r, approx)
    return se3_log_trig(w, t, trig)


def se3_right_jacobian_blocks_trig(w: Vec, t: Vec, trig):
    """(J_r(w), Q(t, w)) blocks of the 6x6 right Jacobian, shared trig."""
    theta, theta2, s, c = trig
    small = theta2 <= EPSILON
    inv_t2 = 1.0 / torch.where(small, 1.0, theta2)

    s_t = s * theta * inv_t2  # sin(theta)/theta
    inv_1mc = 1.0 / (2.0 * (1.0 - c)).clamp_min(1e-30)
    a_exact = inv_t2 - s_t * inv_1mc
    b_exact = -2.0 * inv_t2 * inv_t2 + (1.0 + s_t) * inv_1mc * inv_t2
    a = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, a_exact)
    b = torch.where(small, 1.0 / 360.0, b_exact)

    d = vec_dot(w, t)
    cvec = vec_sub(vec_scale(w, b * d), vec_scale(t, theta2 * b + 2.0 * a))

    # C = 0.5 [t]_x + cvec w^T + a w t^T + d a I
    da = d * a
    tx, ty, tz = t
    wx, wy, wz = w
    C = [
        [cvec[0] * wx + a * wx * tx + da,
         -0.5 * tz + cvec[0] * wy + a * wx * ty,
         0.5 * ty + cvec[0] * wz + a * wx * tz],
        [0.5 * tz + cvec[1] * wx + a * wy * tx,
         cvec[1] * wy + a * wy * ty + da,
         -0.5 * tx + cvec[1] * wz + a * wy * tz],
        [-0.5 * ty + cvec[2] * wx + a * wz * tx,
         0.5 * tx + cvec[2] * wy + a * wz * ty,
         cvec[2] * wz + a * wz * tz + da],
    ]
    jr = so3_right_jacobian_trig(w, trig)
    q = mat_mul(C, jr)
    return jr, q


def se3_right_jacobian_blocks(w: Vec, t: Vec, approx: bool = False):
    """:func:`se3_right_jacobian_blocks_trig` with the angle's trig computed
    from ``w`` itself."""
    return se3_right_jacobian_blocks_trig(w, t, _trig_from_w(w, approx))


# --- chain kinematics -------------------------------------------------------


def chain_constants(spec):
    """Static per-joint constants as plain Python floats.

    Returns (origins_r, origins_t, axes, prismatic, tip_r, tip_t, has_tip).
    """
    a = spec.origin_r.shape[0]
    org_r = [[[float(spec.origin_r[j, i, k]) for k in range(3)]
              for i in range(3)] for j in range(a)]
    org_t = [[float(spec.origin_t[j, i]) for i in range(3)] for j in range(a)]
    axes = [[float(spec.axis[j, i]) for i in range(3)] for j in range(a)]
    pris = [bool(spec.prismatic[j] > 0.5) for j in range(a)]
    tip_r = [[float(spec.tip_r[i, k]) for k in range(3)] for i in range(3)]
    tip_t = [float(spec.tip_t[i]) for i in range(3)]
    has_tip = not (np.allclose(spec.tip_r, np.eye(3))
                   and np.allclose(spec.tip_t, 0.0))
    return org_r, org_t, axes, pris, tip_r, tip_t, has_tip


def fk_joints(consts, q: Vec, approx: bool = False):
    """FK over the chain; q is a list of A lane tensors.

    Returns (frames, r_ee, t_ee): frames[j] = (R_j, p_j) world joint frames
    (the tip applies to the EE only).
    """
    org_r, org_t, axes, pris, tip_r, tip_t, has_tip = consts
    r, t = None, None  # None = identity prefix
    frames = []
    for j in range(len(q)):
        if pris[j]:
            lr = org_r[j]
            lt = vec_add(org_t[j], mat_vec(org_r[j], vec_scale(axes[j], q[j])))
        else:
            lr = mat_mul(org_r[j], rodrigues(axes[j], q[j], approx))
            lt = org_t[j]
        if r is None:
            r, t = lr, list(lt)
        else:
            t = vec_add(mat_vec(r, lt), t)
            r = mat_mul(r, lr)
        frames.append((r, t))

    r_ee, t_ee = r, t
    if has_tip:
        t_ee = vec_add(mat_vec(r_ee, tip_t), t_ee)
        r_ee = mat_mul(r_ee, tip_r)
    return frames, r_ee, t_ee


def fk_with_ee(consts, q: Vec, ee_r: Mat = None, ee_t: Vec = None,
               approx: bool = False):
    """FK + optional EE offset: (frames, r_ee, t_ee)."""
    frames, r_ee, t_ee = fk_joints(consts, q, approx)
    if ee_r is not None:
        t_ee = vec_add(mat_vec(r_ee, ee_t), t_ee)
        r_ee = mat_mul(r_ee, ee_r)
    return frames, r_ee, t_ee


def jacobian_cols(consts, frames, r_ee: Mat, t_ee: Vec):
    """Geometric Jacobian columns (EE/local frame), one 6-list per joint."""
    axes = consts[2]
    pris = consts[3]
    cols = []
    for j in range(len(frames)):
        rj, pj = frames[j]
        dir_w = mat_vec(rj, axes[j])
        if pris[j]:
            lin_l = mat_tvec(r_ee, dir_w)
            cols.append(lin_l + [0.0, 0.0, 0.0])
        else:
            lin_w = vec_cross(dir_w, vec_sub(t_ee, pj))
            lin_l = mat_tvec(r_ee, lin_w)
            ang_l = mat_tvec(r_ee, dir_w)
            cols.append(lin_l + ang_l)
    return cols


def residual_and_jtask(consts, q: Vec, tgt_r: Mat, tgt_t: Vec,
                       ee_r: Mat = None, ee_t: Vec = None,
                       weight6: Mat = None, approx: bool = False):
    """Fused hot path: (residual [6], J_task [6][A]).

    The weighted pose error r = M log6(T_tgt^-1 T(q)) and its Jacobian
    M Jlog6 Jgeo from one FK pass.
    """
    frames, r_ee, t_ee = fk_with_ee(consts, q, ee_r, ee_t, approx)

    # X = T_tgt^-1 * T_ee
    xr = mat_mul(mat_t(tgt_r), r_ee)
    xt = mat_tvec(tgt_r, vec_sub(t_ee, tgt_t))

    w_log, trig = rot_log_terms(xr, approx)
    e = se3_log_trig(w_log, xt, trig)

    a = len(q)
    cols = jacobian_cols(consts, frames, r_ee, t_ee)

    jr, qq = se3_right_jacobian_blocks_trig(w_log, xt, trig)
    # J_task = [[jr, qq], [0, jr]] @ Jgeo  -> 6 x A
    jt = [[None] * a for _ in range(6)]
    for j in range(a):
        col = cols[j]
        for i in range(3):
            jt[i][j] = sadd(
                ssum([smul(jr[i][k], col[k]) for k in range(3)]),
                ssum([smul(qq[i][k], col[3 + k]) for k in range(3)]))
            jt[3 + i][j] = ssum([smul(jr[i][k], col[3 + k])
                                 for k in range(3)])

    if weight6 is not None:
        e = mat_vec(weight6, e)
        jt = mat_mul(weight6, jt)
    return e, jt


def weights_are_identity(w) -> bool:
    """Static check (objective.rs:13,25)."""
    if w is None:
        return True
    return bool(np.all(np.abs(np.asarray(w) - 1.0) <= IDENTITY_EPS))


def weight6_from_config(tgt_r: Mat, wl, wa):
    """6x6 weighting M = blockdiag(R^T diag(wl) R, R^T diag(wa) R) or None."""
    lin_id = weights_are_identity(wl)
    ang_id = weights_are_identity(wa)
    if lin_id and ang_id:
        return None

    def conj(w):
        return [[sum(tgt_r[k][i] * float(w[k]) * tgt_r[k][j]
                     for k in range(3)) for j in range(3)] for i in range(3)]

    def ident():
        return [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]

    m_l = ident() if lin_id else conj(wl)
    m_a = ident() if ang_id else conj(wa)
    out = [[0.0] * 6 for _ in range(6)]
    for i in range(3):
        for j in range(3):
            out[i][j] = m_l[i][j]
            out[3 + i][3 + j] = m_a[i][j]
    return out
