"""URDF text of chains that are not in the assets: synthetic arms of any
length and the repo's Panda on a mobile base.  They give the kernel its
chains of more (or fewer) joints than the Panda's 7.
"""

from . import asset_path

# The holonomic base and lift of the mobile Panda: (joint, type, axis,
# lower, upper, origin xyz), from the world to panda_link0.
MOBILE_BASE = (("base_x", "prismatic", "1 0 0", -2.0, 2.0, "0 0 0"),
               ("base_y", "prismatic", "0 1 0", -2.0, 2.0, "0 0 0"),
               ("base_yaw", "revolute", "0 0 1", -3.14, 3.14, "0 0 0"),
               ("lift", "prismatic", "0 0 1", 0.0, 0.5, "0 0 0.2"))


def chain_urdf(n: int) -> str:
    """Synthetic n-joint serial arm (alternating z / y axes), links
    ``l0`` .. ``l<n>``."""
    links = "".join(f'<link name="l{i}"/>' for i in range(n + 1))
    joints = "".join(
        f'<joint name="j{i}" type="revolute">'
        f'<parent link="l{i}"/><child link="l{i + 1}"/>'
        f'<origin xyz="0.2 0 0.1" rpy="0 0 0"/>'
        f'<axis xyz="{"0 0 1" if i % 2 == 0 else "0 1 0"}"/>'
        f'<limit lower="-2.5" upper="2.5" effort="1" velocity="1"/>'
        f"</joint>" for i in range(n))
    return f'<robot name="syn{n}">{links}{joints}</robot>'


def planar_urdf(n: int = 6) -> str:
    """n revolute joints, all about z, links ``l0`` .. ``l<n>``: the world
    Jacobian has rank <= 3 everywhere."""
    links = "".join(f'<link name="l{i}"/>' for i in range(n + 1))
    joints = "".join(
        f'<joint name="j{i}" type="revolute">'
        f'<parent link="l{i - 1}"/><child link="l{i}"/>'
        f'<origin xyz="0.2 0 0" rpy="0 0 0"/><axis xyz="0 0 1"/>'
        f'<limit lower="-3" upper="3" effort="1" velocity="1"/>'
        f"</joint>" for i in range(1, n + 1))
    return f'<robot name="planar{n}">{links}{joints}</robot>'


def mobile_panda_urdf() -> str:
    """The repo's Panda (``asset_path("panda.urdf")``) on a holonomic base
    with a lift: 11 joints from ``mobile_base`` to ``panda_hand_tcp``,
    whole-body IK's usual chain."""
    text = asset_path("panda.urdf").read_text()
    links = ["mobile_base"] + [f"{j[0]}_link" for j in MOBILE_BASE[:-1]] \
        + ["panda_link0"]
    extra = "".join(f'<link name="{n}"/>' for n in links[:-1]) + "".join(
        f'<joint name="{name}" type="{kind}">'
        f'<parent link="{links[i]}"/><child link="{links[i + 1]}"/>'
        f'<origin xyz="{xyz}" rpy="0 0 0"/><axis xyz="{axis}"/>'
        f'<limit lower="{lo}" upper="{hi}" effort="100" velocity="1"/>'
        "</joint>"
        for i, (name, kind, axis, lo, hi, xyz) in enumerate(MOBILE_BASE))
    return text.replace("</robot>", extra + "</robot>")
