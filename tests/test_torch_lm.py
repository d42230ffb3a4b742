"""The port's LM solvers against the JAX package's, on shared inputs.

  * ``solver.ik.build_batch_solver`` (the plain torch loop) against the JAX
    XLA path at f64: equal found masks, equal winners (Speed: the winning
    restart index; Quality: the winning seed distance, within 1e-8), equal
    iterations-to-converge of each winner, x within 1e-8.  Torch and XLA
    order and fuse the float operations differently (last-bit
    differences), and ~30 accepted LM steps amplify that; 1e-8 is far below
    any solution-changing error.  The XLA path does not return its winner
    key, so the test wraps its ``_select`` to report it (``sel_key``, as the
    JAX kernel path does); nothing in the JAX package changes.
  * ``ops.cuda.lm_kernel.solve_plain`` (the kernel's plain version, CPU)
    against the Pallas kernel in interpret mode, both in kernel math mode at
    f32.  XLA:CPU contracts multiply-adds into FMAs and torch eager does
    not, so f32 trajectories part at the rounding level, and an attempt
    stops anywhere inside tol_f = 1e-6 (a residual of ~1e-3).  So: found
    masks differ on at most 1 of 16 poses, x agrees within 1e-3 where both
    chose the same winning restart (within 5e-3 on at most one such pose),
    and every found cost is <= tol_f.
    The same limits hold for every option the Pallas kernel runs: Quality
    (winner = the least seed distance; "same winner" there means distances
    within 1e-3), per-axis weights, a seed count that does not divide the
    tile rows, ``restart_offset`` and ``lane0_stream``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optik_tpu import Robot as JaxRobot
from optik_tpu import SolutionMode as JaxMode
from optik_tpu import SolverConfig as JaxConfig
from optik_tpu.models import asset_path
from optik_tpu.ops.pallas import lm_kernel as jax_kernel
from optik_tpu.solver import ik as jax_ik

from optik_tpu_torch import SolverConfig
from optik_tpu_torch.models import ChainSpec
from optik_tpu_torch.ops.cuda import lm_kernel
from optik_tpu_torch.solver import ik

B = 16


@pytest.fixture(scope="module")
def panda():
    jr = JaxRobot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float64)
    return jr, ChainSpec.from_arrays(dataclasses.asdict(jr.spec))


def _problem(jr, seed, dtype):
    rng = np.random.default_rng(seed)
    lo, hi = jr.joint_limits()
    tr, tt = jr.fk_batch(rng.uniform(lo, hi, size=(B, 7)))
    x0 = rng.uniform(lo, hi, size=(B, 7))
    return (np.asarray(tr, dtype), np.asarray(tt, dtype),
            np.asarray(x0, dtype))


@pytest.fixture
def jax_sel_key(monkeypatch):
    """The JAX XLA path with its per-pose winner key in ``sel_key``."""
    orig = jax_ik._select

    def select_with_key(mode, xs, fs, success, x0, restart_idx=None,
                        succ_iters=None):
        out = orig(mode, xs, fs, success, x0, restart_idx, succ_iters)
        if mode == JaxMode.SPEED:
            order = restart_idx if restart_idx is not None else \
                jnp.arange(xs.shape[0])
            key = jnp.min(jnp.where(success, order, ik.INT32_MAX))
        else:
            key = jnp.min(jnp.where(
                success, jnp.linalg.norm(xs - x0[None, :], axis=-1), jnp.inf))
        return out._replace(sel_key=key)

    monkeypatch.setattr(jax_ik, "_select", select_with_key)


@pytest.mark.parametrize("mode", ["speed", "quality"])
def test_batch_solver_matches_jax_f64(panda, jax_sel_key, mode):
    jr, spec = panda
    kw = dict(max_restarts=24, seed_batch=8, max_iters=32)
    tr, tt, x0 = _problem(jr, 0, np.float64)
    ref = jax_ik.build_batch_solver(
        jr.spec, JaxConfig.create(mode, **kw), jnp.float64)(tr, tt, x0)
    got = ik.build_batch_solver(
        spec, SolverConfig.create(mode, **kw), torch.float64)(tr, tt, x0)

    found = np.asarray(ref.found)
    assert found.sum() >= B - 2  # the comparison exercises real solves
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.x.numpy()[found], np.asarray(ref.x)[found],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy()[found],
                               np.asarray(ref.cost)[found], rtol=0, atol=1e-12)
    assert int(got.lane_iters) == int(ref.lane_iters)
    if mode == "speed":
        np.testing.assert_array_equal(got.sel_key.numpy(),
                                      np.asarray(ref.sel_key))
    else:
        np.testing.assert_allclose(got.sel_key.numpy()[found],
                                   np.asarray(ref.sel_key)[found], rtol=0,
                                   atol=1e-8)


def _assert_matches_pallas(jr, spec, mode, kw, seed, call_kw):
    """solve_plain (kernel math, CPU) against the Pallas kernel in interpret
    mode on one numpy-seeded problem; returns (plan, lanes, port result,
    per-pose |dx| of the shared winners)."""
    tr, tt, x0 = _problem(jr, seed, np.float32)
    cfg = SolverConfig.create(mode, **kw)
    s = min(kw["seed_batch"], kw["max_restarts"])
    packs = 8 // s if 8 % s == 0 else 1
    ref = jax_kernel.build_kernel_solver(
        jr.spec, JaxConfig.create(mode, **kw), p_blk=B // packs // 2,
        interpret=True)(tr, tt, x0, **call_kw)

    plan = lm_kernel.KernelPlan(spec, cfg)
    x0_t = torch.tensor(x0)
    lanes = lm_kernel.solve_lanes(plan, torch.tensor(tr), torch.tensor(tt),
                                  x0_t, **call_kw)
    got = lm_kernel.select(plan, lanes, x0_t)

    f_ref, f_got = np.asarray(ref.found), got.found.numpy()
    assert f_ref.sum() >= B - 2
    assert (f_ref != f_got).sum() <= 1
    assert np.all(np.asarray(ref.cost)[f_ref] <= cfg.tol_f)
    assert np.all(got.cost.numpy()[f_got] <= cfg.tol_f)
    key_got, key_ref = got.sel_key.numpy(), np.asarray(ref.sel_key)
    if mode == "speed":
        same = f_ref & f_got & (key_got == key_ref)
    else:
        with np.errstate(invalid="ignore"):
            same = f_ref & f_got & (np.abs(key_got - key_ref) <= 1e-3)
    assert same.sum() >= B - 2
    # Largest joint difference of each shared winner.
    dx = np.abs(got.x.numpy() - np.asarray(ref.x))[same].max(axis=1)
    return plan, lanes, got, dx


def test_kernel_plain_version_matches_pallas_interpret(panda):
    jr, spec = panda
    kw = dict(max_restarts=24, seed_batch=8, max_iters=32)
    _, lanes, _, dx = _assert_matches_pallas(jr, spec, "speed", kw, 1, {})
    assert dx.max() <= 1e-3
    # Lane outputs are on the (B, S) grid; winners are lowest successful
    # restart indices.
    assert lanes.x.shape == (B, 8, 7) and lanes.restart_index.dtype == \
        torch.int32
    assert int(lanes.lane_iters) > 0


WEIGHTS = dict(linear_weight=(0.0, 1.0, 1.0), angular_weight=(0.5, 1.0, 2.0))


@pytest.mark.parametrize("mode,kw,call_kw", [
    ("quality", dict(max_restarts=24, seed_batch=8), {}),
    ("speed", dict(max_restarts=24, seed_batch=4, **WEIGHTS), {}),
    ("speed", dict(max_restarts=24, seed_batch=3), {}),
    ("speed", dict(max_restarts=24, seed_batch=8), {"restart_offset": 64}),
    ("speed", dict(max_restarts=24, seed_batch=8), {"lane0_stream": True}),
], ids=["quality", "weighted", "three_lanes", "restart_offset",
        "lane0_stream"])
def test_kernel_plain_options_match_pallas_interpret(panda, mode, kw,
                                                     call_kw):
    jr, spec = panda
    plan, lanes, got, dx = _assert_matches_pallas(
        jr, spec, mode, dict(kw, max_iters=32), 11, call_kw)
    # x within 1e-3 on every shared winner but at most one: an attempt whose
    # cost crosses tol_f one iteration apart in the two versions stops a
    # step earlier or later, up to ~3e-3 away along the arm's self-motion
    # (7 joints, 6 constraints), and still on the target pose.
    assert (dx > 1e-3).sum() <= 1 and dx.max() <= 5e-3, dx
    assert lanes.x.shape == (B, plan.s, 7)
    if "linear_weight" in kw:
        # The weights reach the solve: zero x-weight admits solutions the
        # unweighted objective rejects (tests/test_pallas.py:147-150).
        tr, tt, x0 = _problem(jr, 11, np.float32)
        plain = lm_kernel.KernelPlan(spec, SolverConfig.create(
            mode, max_restarts=24, seed_batch=4, max_iters=32))
        x0_t = torch.tensor(x0)
        un = lm_kernel.select(plain, lm_kernel.solve_lanes(
            plain, torch.tensor(tr), torch.tensor(tt), x0_t), x0_t)
        assert not np.allclose(got.x.numpy(), un.x.numpy(), atol=1e-3)
    if call_kw:
        # Both options change the restart stream, hence the solve.
        tr, tt, x0 = _problem(jr, 11, np.float32)
        x0_t = torch.tensor(x0)
        base = lm_kernel.select(plan, lm_kernel.solve_lanes(
            plan, torch.tensor(tr), torch.tensor(tt), x0_t), x0_t)
        assert not torch.equal(base.x, got.x)
        # Restart indices stay local to the call (0..R-1).
        assert int(lanes.restart_index.max()) < 24


def test_plain_loop_track_active_counts_running_lanes(panda):
    """``track_active`` (the JAX loop's schedule probe) changes no result
    and counts, per lane, the iterations before the lane stopped."""
    jr, spec = panda
    tr, tt, x0 = (torch.tensor(v) for v in _problem(jr, 2, np.float32))
    plan = lm_kernel.KernelPlan(spec, SolverConfig(
        max_restarts=24, seed_batch=8, max_iters=32))
    plain = lm_kernel.solve_plain(plan, tr, tt, x0)
    probe = lm_kernel.solve_plain(plan, tr, tt, x0, track_active=True)
    assert plain.active_iters is None
    for name in ("x", "f", "success", "restart_index", "succ_iters"):
        assert torch.equal(getattr(plain, name), getattr(probe, name))
    act = probe.active_iters
    assert act.shape == (B, 8) and act.dtype == torch.int32
    loop_iters = int(probe.lane_iters) // (B * 8)
    assert int(act.min()) >= 1 and int(act.max()) == loop_iters
    # Speed mode freezes a pose at its first success: most lanes stop
    # long before the slowest one.
    assert int(act.sum()) < int(probe.lane_iters)
    # A lane that won ran at least its iterations-to-converge.
    won = probe.success
    assert bool((act[won] >= probe.succ_iters[won]).all())


def test_kernel_wrapper_dispatch_and_checks(panda):
    _, spec = panda
    cfg = SolverConfig(max_restarts=16, seed_batch=8, max_iters=8)
    plan = lm_kernel.KernelPlan(spec, cfg)
    tr = torch.eye(3).expand(2, 3, 3)
    tt = torch.zeros(2, 3)
    x0 = torch.zeros(2, 7)
    # CPU tensors never reach the kernel launcher.
    with pytest.raises(ValueError, match="CUDA"):
        lm_kernel.solve_kernel(plan, tr, tt, x0)
    with pytest.raises(ValueError, match="device"):
        lm_kernel.solve_lanes(plan, tr.to("meta"), tt.to("meta"),
                              x0.to("meta"))
    with pytest.raises(ValueError, match="expected"):
        lm_kernel.solve_lanes(plan, tr, tt, x0[:, :6])
    # Every option of the Pallas kernel has a plan; only more than 64 seed
    # lanes per pose is left out.
    for ok in (cfg.replace(solution_mode="quality"),
               cfg.replace(linear_weight=(0.0, 1.0, 1.0)),
               cfg.replace(seed_batch=6),
               cfg.replace(max_restarts=64, seed_batch=64)):
        lm_kernel.KernelPlan(spec, ok)
    assert [lm_kernel.padded_lanes(s) for s in (1, 3, 5, 8, 12, 24, 33, 64)] \
        == [1, 4, 8, 8, 16, 32, 64, 64]
    with pytest.raises(NotImplementedError, match="S=65"):
        lm_kernel.KernelPlan(spec, cfg.replace(max_restarts=128,
                                               seed_batch=65))
    # The explicit-seed launch checks its tensors before it builds anything.
    with pytest.raises(ValueError, match="CUDA"):
        lm_kernel.launch_lanes(plan, torch.zeros(7, 16),
                               lm_kernel.pack_targets(tr, tt), reseed=False,
                               freeze=True)


def test_fp32_operation_count_formula(panda):
    from optik_tpu_torch.ops import opcount, soa

    # The tracer: the dead side of a select, a repeated subexpression and
    # what no output needs are not counted; static 0 / +-1 terms fold.
    t = opcount.Trace()
    x, y = t.leaf("x", 2.0), t.leaf("y", 3.0)
    live, dead = x * y + 1.0, (x / y) * (x / y) * y
    out = torch.where(x > y, dead, live) + y * x
    assert out.val == 13.0 and t.cost([out]) == 3
    assert t.cost([dead]) == 3 and t.cost([out, dead]) == 6
    assert soa.smul(x, 1.0) is x and t.cost([soa.sadd(0.0, -x)]) == 0
    assert t.cost([torch.sqrt(torch.floor(x * 0.5)).clamp_min(0.1)]) == 3

    # Traced values are the plain version's: same residual and Jacobian.
    _, spec = panda
    plan = lm_kernel.KernelPlan(spec, SolverConfig())
    rng = np.random.default_rng(5)
    lo, hi = np.asarray(spec.lower), np.asarray(spec.upper)
    q, qt = rng.uniform(lo, hi), rng.uniform(lo, hi)

    def col(v):
        return [torch.tensor([u], dtype=torch.float64) for u in v]

    _, rt, tt = soa.fk_joints(plan.consts, col(qt), approx=True)
    e_ref, jt_ref = soa.residual_and_jtask(plan.consts, col(q), rt, tt,
                                           approx=True)
    t = opcount.Trace()
    e, jt = soa.residual_and_jtask(
        plan.consts, [t.leaf(f"q{i}", v) for i, v in enumerate(q)],
        [[t.leaf(f"r{i}{j}", float(v)) for j, v in enumerate(row)]
         for i, row in enumerate(rt)],
        [t.leaf(f"t{i}", float(v)) for i, v in enumerate(tt)], approx=True)
    got = [v.val for v in e] + [v.val for row in jt for v in row]
    want = [float(v) for v in e_ref] + [float(v) for row in jt_ref for v in row]
    assert got == want

    # 7-DoF Panda with its fixed tip: the count the roofline bound uses.  It
    # lies below 3,120, the kernel's own operations with both sides of every
    # select and the unfolded chain.
    n = lm_kernel.fp32_ops_per_lane_iter(plan)
    assert n == lm_kernel.fp32_ops_per_lane_iter(plan) == 2015
    assert n <= lm_kernel.fp32_ops_per_lane_iter(plan, samples=4) < 3120


def test_pack_chain_layout(panda):
    _, spec = panda
    from optik_tpu_torch.ops import soa

    consts = soa.chain_constants(spec)
    lower, upper = ik.chain_bounds(spec)
    chain = lm_kernel.pack_chain(consts, lower, upper)
    assert chain.dtype == np.float32 and chain.size == 7 * 54 + 13
    # Rodrigues coefficient form reproduces soa.rodrigues for every joint.
    q = torch.tensor([0.3, -1.2, 2.5], dtype=torch.float64)
    s, c = torch.sin(q), torch.cos(q)
    for j, axis in enumerate(consts[2]):
        c0, cc, cs, c1 = lm_kernel._rodrigues_coeffs(axis)
        rod = soa.rodrigues(axis, q)
        for a in range(3):
            for b in range(3):
                want = torch.broadcast_to(torch.as_tensor(rod[a][b],
                                                          dtype=q.dtype), (3,))
                got = c0[a, b] + c * cc[a, b] + s * cs[a, b] + \
                    (1 - c) * c1[a, b]
                torch.testing.assert_close(got, want, rtol=0, atol=1e-15)
