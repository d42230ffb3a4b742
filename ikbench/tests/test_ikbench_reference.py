"""The plain reference against hand-worked cases."""

import math

import numpy as np
import pytest
import torch

from ikbench import harness
from ikbench.reference import check, diffik, lm, seeds
from ikbench.reference.chain import Chain, pose_error, se3_log

F64 = torch.float64


def panda():
    return Chain((harness.HERE / "configs" / "panda7.urdf").read_text(),
                 "panda_link0", "panda_hand_tcp")


def test_threefry_known_answers():
    """Random123's known answers for Threefry-2x32, 20 rounds."""
    with np.errstate(over="ignore"):
        for key, ctr, want in [
                ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                 (0x1CB996FC, 0xBB002BE7)),
                ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                 (0xC4923A9C, 0x483DF7A0))]:
            got = seeds.threefry2x32(key, *ctr)
            assert (int(got[0]), int(got[1])) == want


def test_restart_table_rows_are_the_stream():
    lo, hi = panda().sample_box()
    t64 = seeds.restart_table(42, 64, lo, hi)
    t8 = seeds.restart_table(42, 8, lo, hi)
    assert t64.dtype == np.float32 and np.array_equal(t64[:8], t8)
    assert np.all(t64 >= lo.astype(np.float32))
    assert np.all(t64 <= hi.astype(np.float32))
    assert not np.array_equal(seeds.restart_table(43, 8, lo, hi), t8)


def test_panda_at_zero():
    """Every joint at 0: the flange points down 0.088 m in front of the
    base, 0.333 + 0.316 + 0.384 - 0.107 - 0.1034 m up, the hand turned by
    -pi/4 about its axis."""
    r, p = panda().fk(torch.zeros(7, dtype=F64))
    c = math.sqrt(0.5)
    assert torch.allclose(p, torch.tensor([0.088, 0.0, 0.8226], dtype=F64),
                          atol=1e-12)
    assert torch.allclose(r, torch.tensor([[c, c, 0], [c, -c, 0],
                                           [0, 0, -1]], dtype=F64),
                          atol=1e-12)


def test_se3_log_by_hand():
    eye = torch.eye(3, dtype=F64)
    t = torch.tensor([0.1, -0.2, 0.3], dtype=F64)
    assert torch.allclose(se3_log(eye, t), torch.cat([t, torch.zeros(3,
                                                      dtype=F64)]))
    rz = torch.tensor([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=F64)
    e = se3_log(rz, torch.tensor([1.0, 0, 0], dtype=F64))
    # w = (0, 0, pi/2); v = V^-1 t = (pi/4, -pi/4, 0)
    want = torch.tensor([math.pi / 4, -math.pi / 4, 0, 0, 0, math.pi / 2],
                        dtype=F64)
    assert torch.allclose(e, want, atol=1e-12)


def _solve(ch, q_target, x0, table, s=4):
    r, p = ch.fk(q_target)
    return lm.solve(ch, r[None], p[None], x0[None], table, s=s,
                    max_iters=32, tol_f=1e-6)


def test_speed_takes_the_first_success():
    ch = panda()
    q = torch.tensor([0.3, -0.4, 0.2, -1.9, 0.1, 1.6, 0.5], dtype=F64)
    far = torch.tensor([-2.5, 1.5, -2.5, -0.2, 2.5, 3.5, -2.5], dtype=F64)
    # At its seed, the caller's x0 is the solution: restart 0 wins at its
    # first iteration, and every lane stops there.
    table = torch.stack([far] * 8)
    ans = _solve(ch, q, q, table)
    assert bool(ans.found[0]) and int(ans.restart[0]) == 0
    assert torch.equal(ans.x[0], q) and float(ans.cost[0]) < 1e-20
    assert ans.lane_iters == 4
    # Restarts 2 and 3 start on the solution, x0 far away: both succeed at
    # the first iteration; the lower index wins.
    table = torch.stack([far, far, q, q, far, far, far, far])
    ans = _solve(ch, q, far, table)
    assert int(ans.restart[0]) == 2 and torch.equal(ans.x[0], q)


def test_unreachable_is_not_found():
    ch = panda()
    r, _ = ch.fk(torch.zeros(7, dtype=F64))
    lo, hi = ch.sample_box()
    table = torch.tensor(seeds.restart_table(42, 16, lo, hi), dtype=F64)
    ans = lm.solve(ch, r[None], torch.tensor([[3.0, 0, 0]], dtype=F64),
                   torch.zeros(1, 7, dtype=F64), table, s=4, max_iters=8,
                   tol_f=1e-6)
    assert not bool(ans.found[0]) and int(ans.restart[0]) == lm.INT_MAX
    # every lane ran all four of its restarts of 9 iterations
    assert ans.lane_iters == 4 * 4 * 9


def test_reference_solves_reachable_targets():
    ch = panda()
    g = torch.Generator().manual_seed(7)
    lo, hi = (torch.tensor(v) for v in ch.sample_box())
    q = lo + (hi - lo) * torch.rand(6, 7, generator=g, dtype=F64)
    x0 = lo + (hi - lo) * torch.rand(6, 7, generator=g, dtype=F64)
    r, p = ch.fk(q)
    solver = {"max_restarts": 64, "seed_batch": 8, "max_iters": 32,
              "tol_f": 1e-6}
    ans = check.ik_answers(ch, solver, r, p, x0, F64)
    assert bool(ans.found.all())
    e = pose_error(ch, ans.x, r, p)
    assert float((e * e).sum(-1).max()) <= 1e-6
    # The reference's own answers pass its check; a moved or lost one not.
    inputs = (r.float(), p.float(), x0.float())
    good, _ = check.ik_numbers(ch, solver, inputs,
                               (ans.found, ans.x, ans.cost))
    assert good["mismatch_share"] == 0.0
    moved, _ = check.ik_numbers(ch, solver, inputs,
                                (ans.found, ans.x + 0.05, ans.cost))
    assert moved["mismatch_share"] == 1.0
    lost = ans.found.clone()
    lost[:3] = False
    half, _ = check.ik_numbers(ch, solver, inputs, (lost, ans.x, ans.cost))
    assert half["mismatch_share"] == 0.5


@pytest.mark.parametrize("speed, alpha", [(2.0, 1.0), (4.0, 0.5)])
def test_lp_by_hand(speed, alpha):
    """J = [I | e_1]: joints 1 and 7 both move x; at |v| <= 1 the step
    reaches 2 along x."""
    jac = np.concatenate([np.eye(6), np.eye(6)[:, :1]], axis=1)
    vel = np.array([speed, 0, 0, 0, 0, 0.0])
    a, v = diffik.optimum(jac, vel, np.ones(7))
    assert a == pytest.approx(alpha, abs=1e-9)
    res = diffik.tracking_residual(jac[None], vel[None], np.array([a]),
                                   v[None])
    assert res[0] < 1e-9


def test_world_jacobian_is_the_velocity():
    ch = panda()
    q = torch.tensor([0.3, -0.4, 0.2, -1.9, 0.1, 1.6, 0.5], dtype=F64)
    jac = ch.world_jacobian(q)
    dq = torch.tensor([0.1, -0.2, 0.3, 0.1, 0.2, -0.1, 0.3], dtype=F64)
    h = 1e-6
    (r1, p1), (r0, p0) = ch.fk(q + h * dq), ch.fk(q - h * dq)
    lin = (p1 - p0) / (2 * h)
    skew = (r1 - r0) / (2 * h) @ ch.fk(q)[0].T
    ang = torch.stack([skew[2, 1], skew[0, 2], skew[1, 0]])
    assert torch.allclose(jac @ dq, torch.cat([lin, ang]), atol=1e-8)
