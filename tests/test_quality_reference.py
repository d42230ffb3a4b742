"""The benchmark's plain Quality reference (``ikbench/reference/
quality.py``) on the CPU, at a small size: a hand-worked case, the port's
Quality answers against it, and its check failing a planted fault in each
of three places and the bfloat16 control.

The port runs at float32 here: that is the restart stream the card's
kernel reads and the reference works out (a float64 ``Robot`` draws its
restarts at float64, another stream, as the JAX package does).
"""

import math

import numpy as np
import pytest
import torch

from ikbench import harness
from ikbench.reference import check, lm, quality
from ikbench.reference.chain import Chain
from ikbench.tests import faults_quality
from optik_tpu_torch import Robot, SolverConfig

F64 = torch.float64
POSES = 16
SOLVER = {"solution_mode": "quality", "max_restarts": 32, "seed_batch": 8,
          "max_iters": 48, "tol_f": 1e-6, "quality_max_successes": 0}
CELL = "panda7_quality.nearest-stream"

# Two joints about one axis through one point: the tool's pose depends on
# q1 + q2 alone, so every (q1, c - q1) reaches the pose of angle c.
TWIN = """<robot name="twin"><link name="base"/><link name="mid"/>
<link name="hub"/><link name="tool"/>
<joint name="j1" type="revolute"><parent link="base"/><child link="mid"/>
<axis xyz="0 0 1"/><limit lower="-3" upper="3"/></joint>
<joint name="j2" type="revolute"><parent link="mid"/><child link="hub"/>
<axis xyz="0 0 1"/><limit lower="-3" upper="3"/></joint>
<joint name="tip" type="fixed"><parent link="hub"/><child link="tool"/>
<origin xyz="0.5 0 0"/></joint></robot>"""


def _limit():
    cell = harness.load(harness.HERE / "cells" / f"{CELL}.json")
    return cell["limits"]["mismatch_share"]


@pytest.fixture(scope="module")
def panda():
    urdf = (harness.HERE / "configs" / "panda7.urdf").read_text()
    chain = Chain(urdf, "panda_link0", "panda_hand_tcp")
    robot = Robot.from_urdf_str(urdf, "panda_link0", "panda_hand_tcp",
                                dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(3)
    lo, hi = (torch.tensor(v) for v in chain.sample_box())
    q = lo + (hi - lo) * torch.rand(POSES, 7, generator=g, dtype=F64)
    x0 = lo + (hi - lo) * torch.rand(POSES, 7, generator=g, dtype=F64)
    r, p = chain.fk(q)
    inputs = tuple(v.float() for v in (r, p, x0))
    ref = quality.ik_answers(chain, SOLVER, *inputs, F64)
    return chain, robot, inputs, ref


def _port(robot, inputs, **change):
    cfg = SolverConfig.create(**dict(SOLVER, **change))
    res = robot.ik_batch(cfg, *inputs)
    return res.found, res.x, res.cost


def _judge(panda, answers):
    chain, _, inputs, ref = panda
    numbers, diag = quality.ik_numbers(chain, SOLVER, inputs, answers, ref)
    return numbers["mismatch_share"], diag


def test_quality_takes_a_later_nearer_success():
    """Lane 0's first restart starts on the solution (0.9, 0.1) of the
    pose at angle 1, restart 1 on (0.3, 0.7), restart 2 on (0.3, 0.7)
    again; the caller's seed is (0.2, 0.6).  Each succeeds at its first
    iteration.  Quality keeps restart 1 (nearer than restart 0, and
    restart 2 is no nearer); Speed ends the pose at restart 0."""
    chain = Chain(TWIN, "base", "tool")
    r, p = chain.fk(torch.tensor([[0.5, 0.5]], dtype=F64))
    far = torch.tensor([0.9, 0.1], dtype=F64)
    near = torch.tensor([0.3, 0.7], dtype=F64)
    x0 = torch.tensor([[0.2, 0.6]], dtype=F64)
    table = torch.stack([far, near, near, far])
    kw = dict(max_iters=8, tol_f=1e-6)
    one = quality.schedule(chain, r, p, table[None, :1], x0, table[:3],
                           s=1, **kw)
    assert bool(one.found[0]) and int(one.restart[0]) == 1
    assert torch.equal(one.x[0], near) and float(one.cost[0]) < 1e-20
    assert float(one.dist[0]) == pytest.approx(math.sqrt(0.02), rel=1e-12)
    # One lane, three restarts of one iteration each.
    assert one.lane_iters == 3 and one.busy_iters == 3
    # Three lanes side by side: restarts 1 and 2 tie, the lower wins; the
    # fourth restart (lane 0's second) succeeds far away and is dropped.
    side = quality.schedule(chain, r, p, table[None, :3], x0, table, s=3,
                            **kw)
    assert int(side.restart[0]) == 1 and torch.equal(side.x[0], near)
    assert side.lane_iters == 3 * 2 and side.busy_iters == 2 + 1 + 1
    speed = lm._schedule(chain, r, p, table[None, :3], table, 0, 4, 3,
                         8, 1e-6)
    assert int(speed.restart[0]) == 0 and torch.equal(speed.x[0], far)


def test_port_quality_matches_the_reference(panda):
    chain, robot, inputs, ref = panda
    found, x, cost = _port(robot, inputs)
    assert torch.equal(found, ref.found) and bool(found.all())
    dist = quality.distance(x.double(), inputs[2].double())
    assert float((dist - ref.dist).abs().max()) <= quality.DIST_TOL
    share, diag = _judge(panda, (found, x, cost))
    assert share == 0.0, diag


def _lane_start(robot, inputs):
    """The port's plain Quality solve with each lane's distance taken from
    the lane's own first seed, not from the caller's."""
    return faults_quality.lane_start_answers(
        robot, SolverConfig.create(**SOLVER), *inputs)


FAULTS = {
    # The first success (Speed's pick) in Quality's place.
    "speed_pick": lambda robot, inputs: _port(robot, inputs,
                                              solution_mode="speed"),
    # Half the restart budget (16 of 32 here, 128 of 256 in the cell).
    "half_budget": lambda robot, inputs: _port(robot, inputs,
                                               max_restarts=16),
    "lane_start_distance": _lane_start,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_quality_check_fails_a_planted_fault(panda, fault):
    _, robot, inputs, _ = panda
    share, diag = _judge(panda, FAULTS[fault](robot, inputs))
    assert share > _limit(), diag
    assert diag["farther"] > 0


def test_bfloat16_control_fails_the_check(panda):
    chain, _, inputs, _ = panda
    share, diag = _judge(panda, quality.ik_control(chain, SOLVER, inputs))
    assert share > _limit(), diag
