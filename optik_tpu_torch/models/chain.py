"""ChainSpec: the static, array-form kinematic chain the solvers consume.

A numpy-only copy of ``optik_tpu/models/chain.py`` (the port cannot import
``optik_tpu``, which pulls in jax), plus :meth:`ChainSpec.from_arrays` for
carrying a chain across from the JAX package.

The reference keeps a ``Vec<Joint>`` and scans it at runtime
(kinematics.rs:8-164).  Here the chain is preprocessed once, host-side, into
fixed-size per-joint arrays so that forward kinematics is a lockstep scan with
no data-dependent control flow:

  * consecutive fixed joints are folded into the next articulated joint's
    origin (kinematics.rs:54-86), so every remaining joint has exactly one
    generalized position;
  * trailing fixed joints collapse into a single constant ``tip`` transform
    applied before the caller's ``ee_offset`` (kinematics.rs:88-97);
  * joint types become a prismatic mask used for branchless local transforms
    (the reference's prismatic Jacobian column is a ``todo!()`` panic,
    kinematics.rs:185 — implemented here).

Arrays are numpy float64 on the host; the Robot facade casts them to the
compute dtype when building device constants.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import List, Tuple

import numpy as np

from . import urdf as _urdf
from .urdf import FIXED, PRISMATIC, REVOLUTE, UrdfJoint


def _compose(ra, ta, rb, tb):
    return ra @ rb, ra @ tb + ta


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Serial kinematic chain as static arrays.

    All articulated joints carry exactly one generalized position, so
    ``num_positions == len(axis)``.
    """

    joint_names: Tuple[str, ...]
    origin_r: np.ndarray      # (A, 3, 3) folded joint origins
    origin_t: np.ndarray      # (A, 3)
    axis: np.ndarray          # (A, 3) unit joint axes
    prismatic: np.ndarray     # (A,) float mask, 1.0 = prismatic
    lower: np.ndarray         # (A,) joint limits (may be +-inf)
    upper: np.ndarray         # (A,)
    tip_r: np.ndarray         # (3, 3) trailing fixed transform (identity if none)
    tip_t: np.ndarray         # (3,)

    @property
    def num_positions(self) -> int:
        return self.axis.shape[0]

    @staticmethod
    def from_joints(joints: List[UrdfJoint]) -> "ChainSpec":
        """Fold a base->EE ordered joint sequence into a ChainSpec.

        Folding accumulates fixed-joint origins in FK composition order
        (``accumulated * origin``; see the ordering note in
        optik_tpu_torch/models/urdf.py).
        """
        names = []
        org_r, org_t, axes, pris, lo, hi = [], [], [], [], [], []

        acc_r, acc_t = np.eye(3), np.zeros(3)
        for j in joints:
            if j.type == FIXED:
                acc_r, acc_t = _compose(acc_r, acc_t, j.origin_r, j.origin_t)
                continue
            fr, ft = _compose(acc_r, acc_t, j.origin_r, j.origin_t)
            acc_r, acc_t = np.eye(3), np.zeros(3)
            names.append(j.name)
            org_r.append(fr)
            org_t.append(ft)
            axes.append(j.axis)
            pris.append(1.0 if j.type == PRISMATIC else 0.0)
            lo.append(j.lower)
            hi.append(j.upper)

        if not names:
            # The reference asserts num_positions > 0 (kinematics.rs:102).
            raise ValueError("kinematic chain is empty")

        return ChainSpec(
            joint_names=tuple(names),
            origin_r=np.stack(org_r),
            origin_t=np.stack(org_t),
            axis=np.stack(axes),
            prismatic=np.array(pris),
            lower=np.array(lo),
            upper=np.array(hi),
            tip_r=acc_r,
            tip_t=acc_t,
        )

    @staticmethod
    def from_arrays(fields: dict) -> "ChainSpec":
        """Build a spec from the JAX package's ``ChainSpec`` fields.

        ``fields`` maps each field name (``joint_names, origin_r, origin_t,
        axis, prismatic, lower, upper, tip_r, tip_t``) to its value, e.g.
        ``dataclasses.asdict(jax_spec)``; arrays are copied as float64 so
        both packages compute on the same chain.
        """
        names = {f.name for f in dataclasses.fields(ChainSpec)}
        if set(fields) != names:
            raise ValueError(
                f"ChainSpec fields expected {sorted(names)}, got "
                f"{sorted(fields)}")
        kw = {k: np.array(v, dtype=np.float64, copy=True)
              for k, v in fields.items() if k != "joint_names"}
        return ChainSpec(joint_names=tuple(fields["joint_names"]), **kw)

    @staticmethod
    def from_urdf_str(xml_text: str, base_link: str, ee_link: str) -> "ChainSpec":
        model = _urdf.parse_urdf(xml_text)
        joints = _urdf.find_chain(model, base_link, ee_link)
        return ChainSpec.from_joints(joints)

    @staticmethod
    def from_urdf_file(path, base_link: str, ee_link: str) -> "ChainSpec":
        return ChainSpec.from_urdf_str(
            pathlib.Path(path).read_text(), base_link, ee_link)

    def joint_limits(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lower, upper) limit vectors, flattened per position (lib.rs:78-84)."""
        return self.lower.copy(), self.upper.copy()

    def content_key(self) -> tuple:
        """Hashable value key over the chain's content.

        Used for solver caches: ``id(spec)`` is unsafe (ids are recycled
        after GC, so a dead spec's cache entry could serve a new robot).
        """
        return (self.joint_names,
                self.origin_r.tobytes(), self.origin_t.tobytes(),
                self.axis.tobytes(), self.prismatic.tobytes(),
                self.lower.tobytes(), self.upper.tobytes(),
                self.tip_r.tobytes(), self.tip_t.tobytes())
