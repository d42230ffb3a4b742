"""Robot model ingest: URDF parsing and static chain specs.

The URDF assets are the JAX package's (``optik_tpu/models/assets/``), found
by path rather than by import, so the repository keeps one copy of the data
and importing this package never pulls in jax:
  * ``ur3e.urdf``  — the reference test fixture (Drake-derived UR3e).
  * ``panda.urdf`` — Franka Panda 7-DoF, the flagship benchmark model.
  * ``ur5.urdf``   — UR5 6-DoF, the tight-joint-limit stress model.
"""

import pathlib

from .chain import ChainSpec
from .urdf import UrdfModel, find_chain, parse_urdf

ASSETS = (pathlib.Path(__file__).resolve().parents[2] / "optik_tpu"
          / "models" / "assets")


def asset_path(name: str) -> pathlib.Path:
    return ASSETS / name


__all__ = ["ChainSpec", "UrdfModel", "parse_urdf", "find_chain", "ASSETS",
           "asset_path"]
