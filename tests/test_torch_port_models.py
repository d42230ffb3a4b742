"""Robot models shared by the port's parity tests (tests/test_torch_*.py):
each as the JAX package's Robot and the port's, both on the CPU, built from
one URDF so that both compute on the same chain; and the test that they do.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import optik_tpu
from optik_tpu.models import asset_path

import optik_tpu_torch

SCARA = """
<robot name="scara">
  <link name="base"/><link name="l1"/><link name="l2"/>
  <link name="l3"/><link name="tool"/>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.4"/><axis xyz="0 0 1"/>
    <limit lower="-2.9" upper="2.9"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0.35 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.4" upper="2.4"/>
  </joint>
  <joint name="j3" type="prismatic">
    <parent link="l2"/><child link="l3"/>
    <origin xyz="0.3 0 0"/><axis xyz="0 0 -1"/>
    <limit lower="0.0" upper="0.25"/>
  </joint>
  <joint name="j4" type="revolute">
    <parent link="l3"/><child link="tool"/>
    <origin xyz="0 0 -0.05"/><axis xyz="0 0 1"/>
    <limit lower="-3.1" upper="3.1"/>
  </joint>
</robot>
"""


def chain_urdf(n, prismatic=()):
    """Synthetic n-joint serial arm (alternating z / y axes, skew origins);
    the joints listed in ``prismatic`` slide instead of turning."""
    links = "".join(f'<link name="l{i}"/>' for i in range(n + 1))
    joints = []
    for i in range(n):
        ax = "0 0 1" if i % 2 == 0 else "0 1 0"
        kind, lim = ("prismatic", (0.0, 0.3)) if i in prismatic else \
            ("revolute", (-2.5, 2.5))
        joints.append(
            f'<joint name="j{i}" type="{kind}">'
            f'<parent link="l{i}"/><child link="l{i + 1}"/>'
            f'<origin xyz="0.2 0 0.1" rpy="0.1 0 {0.2 * i}"/>'
            f'<axis xyz="{ax}"/>'
            f'<limit lower="{lim[0]}" upper="{lim[1]}" effort="1" '
            f'velocity="1"/></joint>')
    return f'<robot name="syn{n}">{links}{"".join(joints)}</robot>'


def planar_urdf(n=6):
    """n revolute joints, all about z: J_W has rank <= 3 everywhere."""
    links = "".join(f'<link name="l{i}"/>' for i in range(n + 1))
    joints = "".join(
        f'<joint name="j{i}" type="revolute">'
        f'<parent link="l{i - 1}"/><child link="l{i}"/>'
        f'<origin xyz="0.2 0 0" rpy="0 0 0"/><axis xyz="0 0 1"/>'
        f'<limit lower="-3" upper="3" effort="1" velocity="1"/>'
        f"</joint>" for i in range(1, n + 1))
    return f'<robot name="planar{n}">{links}{joints}</robot>'


_URDFS = {
    "ur3e": lambda: (asset_path("ur3e.urdf").read_text(), "ur_base_link",
                     "ur_ee_link"),
    "panda": lambda: (asset_path("panda.urdf").read_text(), "panda_link0",
                      "panda_hand_tcp"),
    "scara": lambda: (SCARA, "base", "tool"),
    "prismatic6": lambda: (chain_urdf(6, prismatic=(0, 3)), "l0", "l6"),
    "chain4": lambda: (chain_urdf(4), "l0", "l4"),
    "chain5": lambda: (chain_urdf(5), "l0", "l5"),
    "chain8": lambda: (chain_urdf(8), "l0", "l8"),
    "planar6": lambda: (planar_urdf(6), "l0", "l6"),
}


@functools.lru_cache(maxsize=None)
def robots(name, f32=False):
    """(JAX Robot, port Robot on the CPU) of the named model."""
    args = _URDFS[name]()
    jdt, tdt = (jnp.float32, torch.float32) if f32 else \
        (jnp.float64, torch.float64)
    return (optik_tpu.Robot.from_urdf_str(*args, dtype=jdt),
            optik_tpu_torch.Robot.from_urdf_str(*args, dtype=tdt,
                                                device="cpu"))


EE_OFFSET = [[0.0, 0.0, 1.0, 0.01], [0.0, 1.0, 0.0, 0.02],
             [-1.0, 0.0, 0.0, -0.1], [0.0, 0.0, 0.0, 1.0]]


class DtypeLog(TorchDispatchMode):
    """Records the dtype of every tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.seen.setdefault(o.dtype, str(func))
        return out


@pytest.mark.parametrize("name", sorted(_URDFS))
def test_both_packages_parse_the_same_chain(name):
    """Every shared model folds to the same arrays in both packages, bit
    for bit (fixed joints, rpy origins, prismatic masks, tips)."""
    jr, tr = robots(name)
    fields = dataclasses.asdict(jr.spec)
    assert set(fields) == {f.name for f in dataclasses.fields(tr.spec)}
    for key, want in fields.items():
        got = getattr(tr.spec, key)
        if key == "joint_names":
            assert tuple(got) == tuple(want)
        else:
            np.testing.assert_array_equal(got, np.asarray(want))
    assert tr.num_positions() == jr.num_positions()
    assert tr.dtype == torch.float64 and tr.device.type == "cpu"
