"""The CUDA LM kernel on an NVIDIA card (marked ``cuda``: these skip on a
machine without one).  Run on a GPU host with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
conftest imports jax, which a GPU host need not have).

The kernel is held against its plain torch version on the same uploaded
seed table, both in kernel math mode at f32.  Built without multiply-add
contraction (``fmad=False``) it rounds every operation as torch's
elementwise kernels do, so every lane's outputs must be bitwise equal.
The solver's contracted build differs at the rounding level, which moves
found-ness only for marginal poses whose cost ends within ~1e-7 of tol_f
(at B=512 at most 2 poses may differ) and may move a 7-DoF solution along
the arm's self-motion, so that build is held to poses, not joint values.
"""

import numpy as np
import pytest
import torch

from optik_tpu_torch import Robot, SolverConfig
from optik_tpu_torch.models import asset_path
from optik_tpu_torch.ops.cuda import lm_kernel

pytestmark = pytest.mark.cuda

CFG = SolverConfig(max_restarts=64, seed_batch=8, max_iters=32, tol_f=1e-6)
B = 512


@pytest.fixture(scope="module")
def robot():
    # Module-scoped fixtures run before the function-scoped skip rule in
    # tests/conftest.py, so this one decides for itself.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                "panda_hand_tcp", device="cuda")


def _problem(robot, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = robot.joint_limits()
    tr, tt = robot.fk_batch(rng.uniform(lo, hi, size=(B, 7)))
    x0 = torch.tensor(rng.uniform(lo, hi, size=(B, 7)), dtype=torch.float32,
                      device="cuda")
    return tr, tt, x0


CASES = [(64, 8), (8, 8), (24, 4)]


@pytest.mark.parametrize("restarts,seeds", CASES)
def test_uncontracted_kernel_is_bitwise_plain(robot, restarts, seeds):
    cfg = CFG.replace(max_restarts=restarts, seed_batch=seeds)
    plan = lm_kernel.KernelPlan(robot.spec, cfg)
    tr, tt, x0 = _problem(robot)
    k = lm_kernel.solve_kernel(plan, tr, tt, x0, fmad=False)
    p = lm_kernel.solve_plain(plan, tr, tt, x0)
    for name in ("x", "f", "success", "restart_index", "succ_iters"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name


@pytest.mark.parametrize("restarts,seeds", CASES)
def test_kernel_matches_plain(robot, restarts, seeds):
    cfg = CFG.replace(max_restarts=restarts, seed_batch=seeds)
    plan = lm_kernel.KernelPlan(robot.spec, cfg)
    tr, tt, x0 = _problem(robot)
    k = lm_kernel.select(plan, lm_kernel.solve_kernel(plan, tr, tt, x0), x0)
    p = lm_kernel.select(plan, lm_kernel.solve_plain(plan, tr, tt, x0), x0)
    torch.cuda.synchronize()
    assert int((k.found != p.found).sum()) <= 2
    assert bool((k.cost[k.found] <= cfg.tol_f).all())
    assert bool((p.cost[p.found] <= cfg.tol_f).all())
    r, t = robot.fk_batch(k.x[k.found])
    torch.testing.assert_close(r, tr[k.found], rtol=0, atol=2e-3)
    torch.testing.assert_close(t, tt[k.found], rtol=0, atol=2e-3)


def test_launch_counter_and_determinism(robot):
    tr, tt, x0 = _problem(robot, seed=1)
    lm_kernel.LAUNCHES = 0
    a = robot.ik_batch(CFG, tr, tt, x0)
    b = robot.ik_batch(CFG, tr, tt, x0)
    head = robot.ik_batch(CFG, tr[:100], tt[:100], x0[:100])
    assert lm_kernel.LAUNCHES == 3
    assert torch.equal(a.x, b.x) and torch.equal(a.found, b.found)
    assert torch.equal(a.x[:100], head.x) and torch.equal(a.cost[:100],
                                                          head.cost)
    assert float(a.found.float().mean()) >= 0.99


def test_kernel_rejects_float64(robot):
    plan = lm_kernel.KernelPlan(robot.spec, CFG)
    tr, tt, x0 = _problem(robot)
    with pytest.raises(TypeError, match="float32"):
        lm_kernel.solve_kernel(plan, tr.double(), tt.double(), x0.double())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        robot.ik_batch(CFG.replace(solution_mode="quality"), tr, tt, x0)


def test_ee_offset_and_six_dof_chain():
    ur5 = Robot.from_urdf_file(asset_path("ur5.urdf"), "base_link",
                               "ee_link", device="cuda")
    ee = np.eye(4)
    ee[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    ee[:3, 3] = [0.03, -0.01, 0.12]
    rng = np.random.default_rng(3)
    lo, hi = ur5.joint_limits()
    tr, tt = ur5.fk_batch(rng.uniform(lo, hi, size=(B, 6)), ee_offset=ee)
    x0 = rng.uniform(lo, hi, size=(B, 6))
    res = ur5.ik_batch(CFG, tr, tt, x0, ee_offset=ee)
    assert float(res.found.float().mean()) >= 0.9
    assert bool((res.cost[res.found] <= CFG.tol_f).all())
    r, t = ur5.fk_batch(res.x[res.found], ee_offset=ee)
    torch.testing.assert_close(r, tr[res.found], rtol=0, atol=2e-3)
    torch.testing.assert_close(t, tt[res.found], rtol=0, atol=2e-3)
