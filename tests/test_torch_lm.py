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
        spec, SolverConfig.create(mode, **kw), torch.float64,
        device="cpu")(tr, tt, x0)

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
    """The kernel's run-time chain array holds the tip and the limits; the
    joints' constants are compile-time (the header tests below)."""
    _, spec = panda
    from optik_tpu_torch.ops import soa

    consts = soa.chain_constants(spec)
    lower, upper = ik.chain_bounds(spec)
    chain = lm_kernel.pack_chain(consts, lower, upper)
    assert chain.dtype == np.float32 and chain.size == 13 + 2 * 7
    np.testing.assert_array_equal(chain[:9].reshape(3, 3),
                                  np.float32(consts[4]))
    np.testing.assert_array_equal(chain[9:12], np.float32(consts[5]))
    assert chain[12] == 1.0 and consts[6]       # the Panda's hand is a tip
    np.testing.assert_array_equal(chain[13:20], np.float32(lower))
    np.testing.assert_array_equal(chain[20:27], np.float32(upper))
    # An ee_offset folds into the tip: it changes this array, not the header.
    ee = (np.eye(3), np.array([0.0, 0.0, 0.1]))
    moved = lm_kernel.KernelPlan(spec, SolverConfig(), ee)
    assert moved.chain[11] == np.float32(consts[5][2] + 0.1)
    assert moved.header == lm_kernel.chain_header(consts)


# --- the chain header: the robot's constants, compile-time for the kernel ---


def _specs():
    out = {}
    for name, urdf, base, ee in (
            ("panda", "panda.urdf", "panda_link0", "panda_hand_tcp"),
            ("ur5", "ur5.urdf", "base_link", "ee_link")):
        out[name] = ChainSpec.from_urdf_file(asset_path(urdf), base, ee)
    return out


def _parse_header(text):
    """(dof, has_tip, {table: rows of Python floats}, prismatic flags,
    per-joint (zeros, ones, minus ones) from the comments)."""
    import re

    dof = int(re.search(r"kDof = (\d+);", text).group(1))
    has_tip = re.search(r"kHasTip = (true|false);", text).group(1) == "true"
    tables = {}
    for name in ("org_r", "org_t", "axis"):
        body = re.search(rf"double {name}\(int j, int i\) {{\s*constexpr "
                         rf"double v\[kDof\]\[\d\] = {{(.*?)}};", text,
                         re.S).group(1)
        tables[name] = [[float.fromhex(v) for v in row.split(",")]
                        for row in re.findall(r"{([^{}]*)}", body)]
    pris = re.search(r"bool v\[kDof\] = {([^}]*)}", text).group(1)
    pris = [v.strip() == "true" for v in pris.split(",")]
    marks = [tuple(int(v) for v in m) for m in re.findall(
        r"// joint \d+: static 0 / \+1 / -1 constants: (\d+) / (\d+) / "
        r"(\d+) of 15", text)]
    return dof, has_tip, tables, pris, marks


class _Lane:
    """A stand-in for a lane tensor that records how soa.smul folds it."""

    def __mul__(self, other):
        return ("mul", other)

    __rmul__ = __mul__

    def __neg__(self):
        return "neg"


@pytest.mark.parametrize("robot", ["panda", "ur5"])
def test_chain_header_round_trips_and_marks_the_folded_terms(robot):
    from optik_tpu_torch.ops import soa

    spec = _specs()[robot]
    consts = soa.chain_constants(spec)
    text = lm_kernel.chain_header(consts)
    dof, has_tip, tables, pris, marks = _parse_header(text)
    assert dof == spec.num_positions and has_tip == consts[6]
    assert pris == list(consts[3]) and len(marks) == dof
    # Every constant parses back to the plain version's Python float, bit
    # for bit, hence to the chain's float32 constant when a lane meets it.
    flat_r = [[v for row in consts[0][j] for v in row] for j in range(dof)]
    assert tables["org_r"] == flat_r
    assert tables["org_t"] == [list(v) for v in consts[1]]
    assert tables["axis"] == [list(v) for v in consts[2]]
    np.testing.assert_array_equal(
        np.float32(tables["org_r"]).reshape(dof, 3, 3),
        np.float32(spec.origin_r))
    # The constants the header marks static 0 / +1 / -1 are the ones
    # soa.smul folds: a dropped product, a copy, a negation.
    lane = _Lane()
    for j in range(dof):
        folded = [0, 0, 0]
        for v in flat_r[j] + tables["org_t"][j] + tables["axis"][j]:
            assert soa._static(v)
            out = soa.smul(lane, v)
            if isinstance(out, float) and out == 0.0:
                folded[0] += 1
            elif out is lane:
                folded[1] += 1
            elif out == "neg":
                folded[2] += 1
            else:
                assert out == ("mul", v)
        assert tuple(folded) == marks[j], (j, folded, marks[j])
        assert sum(folded) >= 9      # most of a joint's 15 constants fold


def test_build_key_follows_the_chain_not_the_tip_or_the_config():
    from optik_tpu_torch.ops.cuda import build

    specs = _specs()
    base = lm_kernel.KernelPlan(specs["panda"], SolverConfig())
    ee = (np.eye(3), np.array([0.01, 0.0, 0.1]))
    moved = lm_kernel.KernelPlan(specs["panda"], SolverConfig(), ee)
    other_cfg = lm_kernel.KernelPlan(specs["panda"], SolverConfig(
        max_restarts=24, seed_batch=4, max_iters=9, tol_f=1e-8))
    ur5 = lm_kernel.KernelPlan(specs["ur5"], SolverConfig())

    def key(plan, flags=("-DOPTIK_QUALITY=0",)):
        return build.build_key(lm_kernel.SOURCE, build.NVCC_FLAGS + flags,
                               {lm_kernel.CHAIN_HEADER: plan.header})

    # One robot: an ee_offset (folded into the run-time tip) and another
    # config reuse the library; another robot builds its own, and so does
    # another flag set (mode, weights, the two-warp exchange, contraction).
    assert key(moved) == key(base) == key(other_cfg)
    assert not np.array_equal(moved.chain, base.chain)
    assert key(ur5) != key(base)
    assert key(base, ("-DOPTIK_QUALITY=1",)) != key(base)
    assert key(base, ("-DOPTIK_QUALITY=0", "--fmad=false")) != key(base)


# --- what the pose work queue relies on -------------------------------------


POSE_CASES = {
    "speed_reseed_8": (SolverConfig(max_restarts=24, seed_batch=8,
                                    max_iters=12, tol_f=1e-6), {}),
    "speed_reseed_3": (SolverConfig(max_restarts=12, seed_batch=3,
                                    max_iters=12, tol_f=1e-6), {}),
    "quality_cap_8": (SolverConfig.create(
        "quality", max_restarts=16, seed_batch=8, max_iters=12, tol_f=1e-6,
        quality_max_successes=2), {}),
    "restart_offset_3": (SolverConfig(max_restarts=12, seed_batch=3,
                                      max_iters=12, tol_f=1e-6),
                         {"restart_offset": 64}),
}


@pytest.mark.parametrize("case", sorted(POSE_CASES))
def test_plain_solve_is_pose_independent(panda, case):
    """A pose's lanes depend on no other pose: solving B poses together
    equals, bit for bit and lane by lane, solving each alone.  The kernel's
    work queue hands poses to thread groups in any packing on this ground."""
    jr, spec = panda
    cfg, kw = POSE_CASES[case]
    n = 6
    tr, tt, x0 = (torch.tensor(v[:n]) for v in _problem(jr, 4, np.float32))
    plan = lm_kernel.KernelPlan(spec, cfg)
    together = lm_kernel.solve_plain(plan, tr, tt, x0, track_active=True,
                                     **kw)
    assert bool(together.success.any())
    for b in range(n):
        alone = lm_kernel.solve_plain(plan, tr[b:b + 1], tt[b:b + 1],
                                      x0[b:b + 1], track_active=True, **kw)
        for name in ("x", "f", "success", "restart_index", "succ_iters",
                     "active_iters"):
            assert torch.equal(getattr(alone, name)[0],
                               getattr(together, name)[b]), (name, b)


def test_pose_lane_iters_lies_between_needed_and_lockstep(panda):
    """The kernel's ``lane_iters`` (a pose's group runs until its last lane
    stops) from the plain loop's probe: at least what the lanes need, at
    most the lockstep loop's count, and additive over poses."""
    jr, spec = panda
    tr, tt, x0 = (torch.tensor(v) for v in _problem(jr, 2, np.float32))
    plan = lm_kernel.KernelPlan(spec, SolverConfig(
        max_restarts=24, seed_batch=8, max_iters=32))
    probe = lm_kernel.solve_plain(plan, tr, tt, x0, track_active=True)
    posewise = int(lm_kernel.pose_lane_iters(probe.active_iters))
    assert int(probe.active_iters.sum()) <= posewise <= int(probe.lane_iters)
    assert posewise < int(probe.lane_iters)     # Speed poses stop early
    assert posewise % 8 == 0
    parts = sum(int(lm_kernel.pose_lane_iters(probe.active_iters[b:b + 1]))
                for b in range(B))
    assert parts == posewise
