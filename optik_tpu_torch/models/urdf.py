"""Host-side URDF ingest: XML -> link/joint graph -> serial chain extraction.

A numpy-only copy of ``optik_tpu/models/urdf.py``, run once per robot on the
host.  The output is a :class:`~optik_tpu_torch.models.chain.ChainSpec` of
fixed-size numpy arrays that the solvers turn into chain constants.

Behavioral parity targets (kylc/optik, crates/optik/src/kinematics.rs):
  * graph build + error messages      -> kinematics.rs:269-319
  * rpy/xyz origin convention         -> kinematics.rs:263-267 (Rz(y)Ry(p)Rx(r))
  * joint-limit rule (upper - lower <= 0  =>  unbounded) -> kinematics.rs:299-303
  * cycle check                       -> kinematics.rs:21
  * base->EE path search              -> kinematics.rs:35-43 (A* over the
    directed graph with unit weights == BFS here)
  * fixed-joint folding + trailing synthetic tip -> kinematics.rs:54-97.
    NOTE on ordering: the reference accumulates consecutive fixed-joint
    origins as ``origin_new * accumulated`` (kinematics.rs:70), which is the
    *reverse* of its own FK composition order (kinematics.rs:153,
    ``tfm = tfm * origin * local``).  Its bundled test chain only ever has a
    single trailing fixed joint, so the discrepancy is unobservable there.
    We fold in FK order — ``accumulated * origin_new`` — which is the
    mathematically consistent choice and identical on all reference fixtures.
"""

from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np

REVOLUTE = 0
PRISMATIC = 1
FIXED = 2

_JOINT_TYPES = {"revolute": REVOLUTE, "prismatic": PRISMATIC, "fixed": FIXED}


def rpy_to_matrix(r: float, p: float, y: float) -> np.ndarray:
    """URDF fixed-axis roll/pitch/yaw -> rotation matrix Rz(y) Ry(p) Rx(r)."""
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


@dataclasses.dataclass
class UrdfJoint:
    name: str
    type: int
    parent: str
    child: str
    origin_r: np.ndarray  # (3, 3)
    origin_t: np.ndarray  # (3,)
    axis: np.ndarray      # (3,) unit
    lower: float
    upper: float


@dataclasses.dataclass
class UrdfModel:
    """Parsed URDF: link names + joints keyed by (parent -> child) edges."""

    name: str
    links: List[str]
    joints: List[UrdfJoint]

    def children(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for i, j in enumerate(self.joints):
            out.setdefault(j.parent, []).append(i)
        return out


def _parse_floats(s: str, n: int) -> np.ndarray:
    vals = [float(x) for x in s.split()]
    if len(vals) != n:
        raise ValueError(f"expected {n} floats, got {s!r}")
    return np.array(vals)


def parse_urdf(xml_text: str) -> UrdfModel:
    """Parse a URDF string into a link/joint model.

    Raises ``ValueError`` for malformed XML, unsupported joint types, or
    joints referencing undefined links (matching the reference's panics,
    kinematics.rs:282-296).
    """
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError as e:
        raise ValueError(f"error parsing URDF file: {e}") from None
    if root.tag != "robot":
        raise ValueError("error parsing URDF file: missing <robot> root")

    links = [ln.attrib["name"] for ln in root.findall("link")]
    link_set = set(links)

    joints: List[UrdfJoint] = []
    for jt in root.findall("joint"):
        name = jt.attrib.get("name", "")
        typ_str = jt.attrib.get("type", "")
        if typ_str not in _JOINT_TYPES:
            raise ValueError(f"joint type not supported: {typ_str!r}")
        typ = _JOINT_TYPES[typ_str]

        parent = jt.find("parent").attrib["link"]
        child = jt.find("child").attrib["link"]
        if parent not in link_set:
            raise ValueError(f"joint parent link '{parent}' does not exist")
        if child not in link_set:
            raise ValueError(f"joint child link '{child}' does not exist")

        origin = jt.find("origin")
        xyz = np.zeros(3)
        rpy = np.zeros(3)
        if origin is not None:
            if "xyz" in origin.attrib:
                xyz = _parse_floats(origin.attrib["xyz"], 3)
            if "rpy" in origin.attrib:
                rpy = _parse_floats(origin.attrib["rpy"], 3)

        axis_el = jt.find("axis")
        axis = np.array([1.0, 0.0, 0.0])  # URDF default axis
        if axis_el is not None and "xyz" in axis_el.attrib:
            axis = _parse_floats(axis_el.attrib["xyz"], 3)
        norm = np.linalg.norm(axis)
        if typ != FIXED:
            if norm == 0.0:
                raise ValueError(f"joint '{name}' has a zero axis")
            axis = axis / norm

        # URDF <limit> defaults to lower=upper=0; the reference maps a
        # non-positive span to an unbounded joint (kinematics.rs:299-303).
        limit = jt.find("limit")
        lower = float(limit.attrib.get("lower", 0.0)) if limit is not None else 0.0
        upper = float(limit.attrib.get("upper", 0.0)) if limit is not None else 0.0
        if not (upper - lower > 0.0):
            lower, upper = -math.inf, math.inf

        joints.append(
            UrdfJoint(
                name=name,
                type=typ,
                parent=parent,
                child=child,
                origin_r=rpy_to_matrix(*rpy),
                origin_t=xyz,
                axis=axis,
                lower=lower,
                upper=upper,
            )
        )

    return UrdfModel(name=root.attrib.get("name", ""), links=links,
                     joints=joints)


def find_chain(model: UrdfModel, base_link: str, ee_link: str) -> List[UrdfJoint]:
    """Extract the ordered joint sequence from ``base_link`` to ``ee_link``.

    BFS over the directed parent->child graph (equivalent to the reference's
    unit-weight A*, kinematics.rs:35-43), after a cycle check.
    """
    link_set = set(model.links)
    if base_link not in link_set:
        raise ValueError(f"base link '{base_link}' does not exist")
    if ee_link not in link_set:
        raise ValueError(f"EE link '{ee_link}' does not exist")

    children = model.children()

    # Cycle check over the directed graph (kinematics.rs:21).
    state: Dict[str, int] = {}

    def visit(link: str):
        state[link] = 1
        for ji in children.get(link, ()):  # noqa: B023
            nxt = model.joints[ji].child
            s = state.get(nxt, 0)
            if s == 1:
                raise ValueError("robot model contains loops")
            if s == 0:
                visit(nxt)
        state[link] = 2

    for ln in model.links:
        if state.get(ln, 0) == 0:
            visit(ln)

    # BFS shortest path base -> ee following joint direction.
    prev: Dict[str, Tuple[str, int]] = {}
    frontier = [base_link]
    seen = {base_link}
    while frontier:
        nxt_frontier = []
        for link in frontier:
            for ji in children.get(link, ()):
                child = model.joints[ji].child
                if child not in seen:
                    seen.add(child)
                    prev[child] = (link, ji)
                    nxt_frontier.append(child)
        frontier = nxt_frontier

    if ee_link not in seen and ee_link != base_link:
        raise ValueError("no path from base to EE link")

    path: List[int] = []
    cur = ee_link
    while cur != base_link:
        cur, ji = prev[cur]
        path.append(ji)
    return [model.joints[ji] for ji in reversed(path)]
