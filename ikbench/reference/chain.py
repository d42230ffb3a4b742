"""A serial chain read from URDF text, and its forward kinematics.

The plain reference's own reading of a robot: ``xml.etree`` and torch, in
any float dtype, on any device.  Fixed joints fold into the next movable
joint's origin; trailing fixed joints become the tip.  Origins follow the
URDF convention: ``xyz``, then ``rpy`` as Rz(yaw) Ry(pitch) Rx(roll).  A
joint whose ``<limit>`` spans nothing (``upper - lower <= 0``) is unbounded
and samples in [-pi, pi].
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import List, NamedTuple, Tuple

import numpy as np
import torch


class Joint(NamedTuple):
    prismatic: bool
    origin_r: np.ndarray   # (3, 3) float64, fixed joints before it folded in
    origin_t: np.ndarray   # (3,)
    axis: np.ndarray       # (3,) unit


def _rpy(r: float, p: float, y: float) -> np.ndarray:
    cr, sr, cp, sp = math.cos(r), math.sin(r), math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], np.float64)
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], np.float64)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float64)
    return rz @ ry @ rx


def _floats(el, key: str, default) -> np.ndarray:
    if el is None or key not in el.attrib:
        return np.array(default, np.float64)
    return np.array([float(v) for v in el.attrib[key].split()], np.float64)


class Chain:
    """The movable joints from ``base`` to ``ee``, their limits and tip."""

    def __init__(self, urdf_text: str, base: str, ee: str):
        root = ET.fromstring(urdf_text)
        by_child = {}
        for j in root.findall("joint"):
            by_child[j.find("child").attrib["link"]] = j
        path, link = [], ee
        while link != base:
            if link not in by_child:
                raise ValueError(f"no chain from {base!r} to {ee!r}")
            j = by_child[link]
            path.append(j)
            link = j.find("parent").attrib["link"]
        path.reverse()
        acc_r, acc_t = np.eye(3), np.zeros(3)
        joints: List[Joint] = []
        lower, upper = [], []
        for j in path:
            origin = j.find("origin")
            o_r = _rpy(*_floats(origin, "rpy", [0, 0, 0]))
            o_t = _floats(origin, "xyz", [0, 0, 0])
            # accumulated * origin
            f_r, f_t = acc_r @ o_r, acc_r @ o_t + acc_t
            kind = j.attrib["type"]
            if kind == "fixed":
                acc_r, acc_t = f_r, f_t
                continue
            if kind not in ("revolute", "continuous", "prismatic"):
                raise ValueError(f"joint type {kind!r}")
            axis = _floats(j.find("axis"), "xyz", [1, 0, 0])
            joints.append(Joint(kind == "prismatic", f_r, f_t,
                                axis / np.linalg.norm(axis)))
            lim = j.find("limit")
            lo = float(lim.attrib.get("lower", 0)) if lim is not None else 0.0
            hi = float(lim.attrib.get("upper", 0)) if lim is not None else 0.0
            if not hi - lo > 0:
                lo, hi = -math.inf, math.inf
            lower.append(lo)
            upper.append(hi)
            acc_r, acc_t = np.eye(3), np.zeros(3)
        self.joints = joints
        self.lower = np.array(lower, np.float64)
        self.upper = np.array(upper, np.float64)
        self.tip_r, self.tip_t = acc_r, acc_t
        self._consts = {}

    def consts(self, dtype, device):
        """Per joint ``(origin_r, origin_t, axis, K, K^2)`` with ``K`` the
        axis's cross-product matrix, and the tip, as tensors of ``dtype``
        on ``device`` (made once)."""
        key = (dtype, str(device))
        if key not in self._consts:
            def t(v):
                return torch.tensor(v, dtype=dtype, device=device)

            def joint(j):
                k = hat(torch.tensor(j.axis, dtype=torch.float64))
                return (t(j.origin_r), t(j.origin_t), t(j.axis),
                        k.to(dtype=dtype, device=device),
                        (k @ k).to(dtype=dtype, device=device))

            self._consts[key] = ([joint(j) for j in self.joints],
                                 t(self.tip_r), t(self.tip_t))
        return self._consts[key]

    @property
    def dof(self) -> int:
        return len(self.joints)

    def sample_box(self) -> Tuple[np.ndarray, np.ndarray]:
        """The limits with unbounded joints in [-pi, pi]."""
        return (np.where(np.isfinite(self.lower), self.lower, -math.pi),
                np.where(np.isfinite(self.upper), self.upper, math.pi))

    def frames(self, q: torch.Tensor):
        """World frames of the joints and of the end effector for ``q``
        (..., A): ``([(R_j, p_j)], R_ee, p_ee)``, where joint j's frame is
        taken after its own motion (its axis is ``R_j @ axis_j``)."""
        joints, tip_r, tip_t = self.consts(q.dtype, q.device)
        r = t = None
        out = []
        for k, (jt, (o_r, o_t, axis, kx, kx2)) in enumerate(
                zip(self.joints, joints)):
            if r is None:
                r, t = o_r.expand(q.shape[:-1] + (3, 3)), o_t
            else:
                t = t + (r @ o_t[:, None])[..., 0]
                r = r @ o_r
            if jt.prismatic:
                t = t + (r @ axis[:, None])[..., 0] * q[..., k, None]
            else:
                r = r @ rotation(kx, kx2, q[..., k])
            out.append((r, t))
        return out, r @ tip_r, t + (r @ tip_t[:, None])[..., 0]

    def fk(self, q: torch.Tensor):
        """End-effector pose ``(R (..., 3, 3), p (..., 3))``."""
        _, r, p = self.frames(q)
        return r, p

    def world_jacobian(self, q: torch.Tensor) -> torch.Tensor:
        """(..., 6, A): rows linear velocity then angular velocity of the
        end effector in the world frame per unit joint velocity."""
        frames, _, p_ee = self.frames(q)
        cols = []
        for jt, (_, _, axis, _, _), (r, p) in zip(
                self.joints, self.consts(q.dtype, q.device)[0], frames):
            z = (r @ axis[:, None])[..., 0]
            if jt.prismatic:
                cols.append(torch.cat([z, torch.zeros_like(z)], -1))
            else:
                cols.append(torch.cat([torch.linalg.cross(z, p_ee - p), z],
                                      -1))
        return torch.stack(cols, -1)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> the (..., 3, 3) cross-product matrix."""
    z = torch.zeros_like(w[..., 0])
    x, y, zz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([torch.stack([z, -zz, y], -1),
                        torch.stack([zz, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def rotation(k: torch.Tensor, k2: torch.Tensor,
             angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: R = I + sin(a) K + (1 - cos(a)) K^2, ``k`` = K the
    axis's cross-product matrix, ``k2`` = K^2."""
    s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None,
                                                              None]
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return eye + s * k + (1 - c) * k2


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation vector of R (..., 3, 3), through the unit quaternion on
    its w >= 0 cover (Shepperd's largest-pivot branch)."""
    r00, r01, r02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    r10, r11, r12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    r20, r21, r22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = torch.stack([1 + r00 + r11 + r22, 1 + r00 - r11 - r22,
                      1 - r00 + r11 - r22, 1 - r00 - r11 + r22], -1)
    # Quaternion (x, y, z, w) scaled by 4 s, for each pivot.
    cand = torch.stack([
        torch.stack([r21 - r12, r02 - r20, r10 - r01, tr[..., 0]], -1),
        torch.stack([tr[..., 1], r01 + r10, r02 + r20, r21 - r12], -1),
        torch.stack([r01 + r10, tr[..., 2], r12 + r21, r02 - r20], -1),
        torch.stack([r02 + r20, r12 + r21, tr[..., 3], r10 - r01], -1)], -2)
    pick = torch.argmax(tr, dim=-1)
    qv = torch.take_along_dim(cand, pick[..., None, None], dim=-2)[..., 0, :]
    qv = qv / torch.linalg.vector_norm(qv, dim=-1, keepdim=True)
    qv = torch.where(qv[..., 3:] < 0, -qv, qv)
    v, w = qv[..., :3], qv[..., 3]
    v2 = (v * v).sum(-1)
    small = v2 <= 1e-12
    vn = torch.sqrt(torch.where(small, torch.ones_like(v2), v2))
    w_safe = torch.where(small, torch.ones_like(w), w)
    scale = torch.where(small,
                        2.0 / w_safe * (1 - v2 / (3 * w_safe * w_safe)),
                        2.0 * torch.atan2(vn, w) / vn)
    return v * scale[..., None]


def se3_log(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[v; w] (..., 6) of the rigid motion (R, t): w = log R and
    v = V(w)^-1 t, V^-1 = I - [w]/2 + c [w]^2,
    c = (1 - theta sin(theta) / (2 (1 - cos(theta)))) / theta^2."""
    w = so3_log(r)
    th2 = (w * w).sum(-1)
    # Below theta^2 = 1e-4 the closed form cancels; the series' next
    # term there is under 1e-18.
    small = th2 <= 1e-4
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    exact = (1 - th * torch.sin(th) / (2 * (1 - torch.cos(th)))) / th2s
    c = torch.where(small, 1 / 12 + th2 / 720 + th2 * th2 / 30240
                    + th2 * th2 * th2 / 1209600, exact)
    k = hat(w)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    v_inv = eye - 0.5 * k + c[..., None, None] * (k @ k)
    return torch.cat([(v_inv @ t[..., None])[..., 0], w], -1)


def pose_error(chain: Chain, q, tgt_r, tgt_t) -> torch.Tensor:
    """The IK residual (..., 6): se3_log(T_tgt^-1 T(q)); its squared norm
    is the cost that ``tol_f`` bounds."""
    r, p = chain.fk(q)
    rt = tgt_r.transpose(-1, -2)
    return se3_log(rt @ r, (rt @ (p - tgt_t)[..., None])[..., 0])
