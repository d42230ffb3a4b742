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
    tile rows, ``restart_offset`` and ``lane0_stream``, and for chains wider
    than the Panda: the 11-joint mobile Panda (the Panda on a holonomic base
    with a lift, ``models.synthetic.mobile_panda_urdf``) and a 12-joint arm.
  * ``lm_kernel.kernel_runs``, the one rule that routes a solve to the
    kernel or to the plain loop, over device, dtype, seed lanes and DoF,
    and the run-time-chain form that takes chains above ``MAX_DOF``: its
    packed array, walked as the kernel walks it, against the port's and the
    JAX package's ``ops/soa`` FK and Jacobian at f64 on 40 and 64 joints.
    No JAX solve runs above 12 joints here (the Pallas kernel in interpret
    mode and the XLA path take minutes at 40); the solve itself is the same
    plain loop at every DoF.
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

from optik_tpu_torch import Robot, SolverConfig
from optik_tpu_torch.models import ChainSpec
from optik_tpu_torch.models.synthetic import chain_urdf, mobile_panda_urdf
from optik_tpu_torch.ops import kinematics as K
from optik_tpu_torch.ops.cuda import lm_kernel
from optik_tpu_torch.solver import ik

B = 16


@pytest.fixture(scope="module")
def panda():
    jr = JaxRobot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float64)
    return jr, ChainSpec.from_arrays(dataclasses.asdict(jr.spec))


# Chains of more than 10 joints: (URDF, base link, end link).
WIDE = {"mobile_panda": (mobile_panda_urdf, "mobile_base",
                         "panda_hand_tcp"),
        "chain12": (lambda: chain_urdf(12), "l0", "l12")}
# Chains above MAX_DOF that only the operation count takes from this
# fixture (no solve through the JAX package at that width).
COUNT_ONLY = {"chain40": (lambda: chain_urdf(40), "l0", "l40")}


@pytest.fixture(scope="module", params=["panda"] + sorted(WIDE))
def chain(request):
    """(name, JAX robot, port spec) of the Panda and of each wide chain."""
    if request.param == "panda":
        return ("panda", *request.getfixturevalue("panda"))
    urdf, base, ee = {**WIDE, **COUNT_ONLY}[request.param]
    jr = JaxRobot.from_urdf_str(urdf(), base, ee, dtype=jnp.float64)
    return (request.param, jr,
            ChainSpec.from_arrays(dataclasses.asdict(jr.spec)))


def _problem(jr, seed, dtype):
    rng = np.random.default_rng(seed)
    lo, hi = jr.joint_limits()
    tr, tt = jr.fk_batch(rng.uniform(lo, hi, size=(B, lo.shape[0])))
    x0 = rng.uniform(lo, hi, size=(B, lo.shape[0]))
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


def test_kernel_plain_version_matches_pallas_interpret(chain):
    """On the Panda and on chains of 11 and 12 joints, which the Pallas
    kernel takes like any other (it reads the DoF from the chain) and the
    CUDA kernel is built for."""
    _, jr, spec = chain
    kw = dict(max_restarts=24, seed_batch=8, max_iters=32)
    plan, lanes, _, dx = _assert_matches_pallas(jr, spec, "speed", kw, 1, {})
    assert dx.max() <= 1e-3
    # Lane outputs are on the (B, S) grid; winners are lowest successful
    # restart indices.
    assert lanes.x.shape == (B, 8, spec.num_positions)
    assert lanes.restart_index.dtype == torch.int32
    assert int(lanes.lane_iters) > 0
    assert lm_kernel.kernel_runs(spec, plan.cfg, torch.float32, "cuda")


def test_float64_plain_version_matches_pallas_interpret(panda):
    """A float64 solve is not the kernel's (``kernel_runs``): solve_lanes
    runs the plain version, with the seed table drawn at float64 as the
    JAX kernel draws it at its dtype.  Against the Pallas kernel at float64
    in interpret mode: equal found masks and winners, x within 1e-8 (the
    limit of the f64 comparison above)."""
    jr, spec = panda
    kw = dict(max_restarts=24, seed_batch=8, max_iters=8)
    tr, tt, x0 = _problem(jr, 1, np.float64)
    ref = jax_kernel.build_kernel_solver(
        jr.spec, JaxConfig.create("speed", **kw), jnp.float64, p_blk=B // 2,
        interpret=True)(tr, tt, x0)
    plan = lm_kernel.KernelPlan(spec, SolverConfig.create("speed", **kw))
    x0_t = torch.tensor(x0)
    assert not lm_kernel.kernel_runs(spec, plan.cfg, x0_t.dtype, "cuda")
    lanes = lm_kernel.solve_lanes(plan, torch.tensor(tr), torch.tensor(tt),
                                  x0_t)
    got = lm_kernel.select(plan, lanes, x0_t)
    assert got.x.dtype == torch.float64
    found = np.asarray(ref.found)
    assert found.sum() >= B - 2
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(got.sel_key.numpy(), np.asarray(ref.sel_key))
    np.testing.assert_allclose(got.x.numpy()[found], np.asarray(ref.x)[found],
                               rtol=0, atol=1e-8)


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


@pytest.mark.parametrize("entry", ["ik.build_batch_solver",
                                   "ChainParams.from_spec"])
def test_plain_loop_constructors_need_a_device(entry):
    """The plain loop's solver and chain constants name no default device,
    so a harness that leaves it out fails instead of timing the host."""
    spec = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                "panda_hand_tcp", device="cpu").spec
    with pytest.raises(TypeError, match="device"):
        if entry == "ik.build_batch_solver":
            ik.build_batch_solver(spec, SolverConfig(), torch.float64)
        else:
            K.ChainParams.from_spec(spec, torch.float64)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("lanes", [64, 128])
@pytest.mark.parametrize("dof", [7, 11, lm_kernel.MAX_DOF + 1, 64])
def test_kernel_runs_routes_by_device_dtype_lanes_and_dof(device, dtype,
                                                          lanes, dof):
    """The one predicate every route asks: the kernel takes float32 on a
    CUDA device and at most 64 seed lanes per pose, at any DoF (above
    MAX_DOF in its run-time-chain form); all else is the plain loop's.  It
    reads the config and never the device itself, so it holds here
    without a card."""
    spec = ChainSpec.from_urdf_str(chain_urdf(dof), "l0",
                                   f"l{dof}")
    cfg = SolverConfig(max_restarts=128, seed_batch=lanes)
    want = device == "cuda" and dtype == torch.float32 and lanes <= 64
    assert lm_kernel.kernel_runs(spec, cfg, dtype, device) is want
    assert lm_kernel.kernel_runs(spec, cfg, dtype, torch.device(device)) \
        is want


def test_chains_above_the_cap_take_the_runtime_chain_library():
    """A 33-joint plan takes the run-time-chain form: no header, the packed
    array, and the one library of its variant that every chain above
    MAX_DOF shares (by its build key: nothing is built here), apart from
    any folded chain's.  Its plain version still runs on the CPU, and
    check_supported refuses only a chain without joints."""
    a = lm_kernel.MAX_DOF + 1
    spec = ChainSpec.from_urdf_str(chain_urdf(a), "l0", f"l{a}")
    cfg = SolverConfig(max_restarts=4, seed_batch=4, max_iters=2)
    plan = lm_kernel.KernelPlan(spec, cfg)
    assert plan.runtime_chain and plan.header is None
    assert plan.chain.size == (lm_kernel.RUNTIME_HEAD
                               + (lm_kernel.JOINT_FLOATS + 2) * a)
    key = plan.library_path(freeze=True)
    for n in (40, 64, 128):
        wide = lm_kernel.KernelPlan(
            ChainSpec.from_urdf_str(chain_urdf(n), "l0", f"l{n}"), cfg)
        assert wide.library_path(freeze=True) == key
        assert lm_kernel.kernel_runs(wide.spec, cfg, torch.float32, "cuda")
    # The run-time form of a folded-width chain loads the same library;
    # the folded form is its robot's own.
    spec11 = ChainSpec.from_urdf_str(chain_urdf(11), "l0", "l11")
    assert lm_kernel.KernelPlan(spec11, cfg, runtime_chain=True) \
        .library_path(freeze=True) == key
    folded = lm_kernel.KernelPlan(spec11, cfg)
    assert not folded.runtime_chain
    assert folded.library_path(freeze=True) != key
    assert plan.library_path(freeze=True, fmad=False) != key
    with pytest.raises(ValueError, match="at most 32 joints"):
        lm_kernel.KernelPlan(spec, cfg, runtime_chain=False)

    rng = np.random.default_rng(0)
    q = torch.tensor(rng.uniform(*spec.joint_limits(), size=(3, a)),
                     dtype=torch.float32)
    tr, tt = Robot(spec, device="cpu").fk_batch(q)
    lanes = lm_kernel.solve_lanes(plan, tr, tt, q)
    assert lanes.x.shape == (3, 4, a)
    assert bool(lanes.success[:, 0].all())  # lane 0 starts at the answer

    for n in (1, a, 128):
        lm_kernel.check_supported(
            ChainSpec.from_urdf_str(chain_urdf(n), "l0", f"l{n}"))
    empty = dataclasses.replace(
        spec, joint_names=(), origin_r=spec.origin_r[:0],
        origin_t=spec.origin_t[:0], axis=spec.axis[:0],
        prismatic=spec.prismatic[:0], lower=spec.lower[:0],
        upper=spec.upper[:0])
    assert empty.num_positions == 0
    with pytest.raises(ValueError, match="at least one joint, got 0"):
        lm_kernel.check_supported(empty)


# FP32 operations per lane-iteration of each chain's library: the count the
# roofline bound uses.  The mobile Panda's is at least the Panda's plus the
# dense algebra of its 4 more joints (67 per joint: J J^T 42, the projected
# step 13, the gain ratio 12).
OPS = {"panda": 2015, "mobile_panda": 2361, "chain12": 2981, "chain40": 9015}


@pytest.mark.parametrize("chain", ["panda"] + sorted(WIDE) + ["chain40"],
                         indirect=True)
def test_fp32_operation_count_formula(chain):
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
    name, _, spec = chain
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
    assert len(jt) == 6 and len(jt[0]) == spec.num_positions
    # A prismatic joint's angular column is a static 0: a float, no node.
    got = [opcount._val(v) for v in e] + [opcount._val(v) for row in jt
                                          for v in row]
    want = [float(v) for v in e_ref] + [float(v) for row in jt_ref for v in row]
    assert got == want

    n = lm_kernel.fp32_ops_per_lane_iter(plan)
    assert n == lm_kernel.fp32_ops_per_lane_iter(plan) == OPS[name]
    assert n <= lm_kernel.fp32_ops_per_lane_iter(plan, samples=4)
    assert OPS["mobile_panda"] >= OPS["panda"] + 67 * 4
    if name == "panda":
        # Below 3,120, the kernel's own operations with both sides of
        # every select and the unfolded chain.
        assert lm_kernel.fp32_ops_per_lane_iter(plan, samples=4) < 3120


def _walk_runtime_chain(packed, q):
    """FK and the geometric Jacobian's columns from the run-time chain's
    array, joint by joint as ``csrc/lm_kernel.cu`` walks it
    (``local_frame_rt``, ``residual_and_jtask_rt``), on (N, A) float64 q
    with exact sin / cos: ((dir_w, p) per joint, r_ee, t_ee, columns)."""
    head, width = lm_kernel.RUNTIME_HEAD, lm_kernel.JOINT_FLOATS
    a = int(packed[13])
    rec = torch.tensor(packed[head:head + width * a].reshape(a, width))
    q = torch.as_tensor(q, dtype=torch.float64)
    r = t = None
    frames = []
    for j in range(a):
        org, org_t = rec[j, 0:9].reshape(3, 3), rec[j, 9:12]
        k, kind = rec[j, 12:15], int(rec[j, 15])
        if kind & 1:   # prismatic: lt = org_t + org_r (axis q)
            lr = org.expand(q.shape[0], 3, 3)
            lt = org_t + (q[:, j, None] * k) @ org.T
        else:          # revolute: org_r (I + s K + (1 - c) K^2)
            s, c = torch.sin(q[:, j]), torch.cos(q[:, j])
            c1 = 1.0 - c
            nkk, (pxy, pxz, pyz) = rec[j, 16:19], rec[j, 19:22]
            diag = [c if kind >> (1 + i) & 1 else 1.0 + c1 * nkk[i]
                    for i in range(3)]
            kx, ky, kz = k
            rot = torch.stack([
                diag[0], -kz * s + pxy * c1, ky * s + pxz * c1,
                kz * s + pxy * c1, diag[1], -kx * s + pyz * c1,
                -ky * s + pxz * c1, kx * s + pyz * c1, diag[2]],
                dim=-1).reshape(-1, 3, 3)
            lr, lt = org @ rot, org_t.expand(q.shape[0], 3)
        if r is None:
            r, t = lr, lt
        else:
            t = (r @ lt[:, :, None])[:, :, 0] + t
            r = r @ lr
        frames.append(((r @ k)[:, :], t))
    if packed[12] > 0.5:
        tip_r = torch.tensor(packed[:9].reshape(3, 3))
        t = (r @ torch.tensor(packed[9:12]))[:, :] + t
        r = r @ tip_r
    cols = []
    for j, (dir_w, p) in enumerate(frames):
        if int(rec[j, 15]) & 1:
            lin, ang = dir_w, torch.zeros_like(dir_w)
            cols.append(torch.cat([(r.transpose(1, 2) @ lin[:, :, None])[
                :, :, 0], ang], dim=1))
        else:
            lin = torch.linalg.cross(dir_w, t - p)
            cols.append(torch.cat([
                (r.transpose(1, 2) @ lin[:, :, None])[:, :, 0],
                (r.transpose(1, 2) @ dir_w[:, :, None])[:, :, 0]], dim=1))
    return frames, r, t, cols


@pytest.mark.parametrize("a", [40, 64])
def test_pack_runtime_chain_round_trips(a):
    """The run-time chain's array holds the plain version's chain: walked
    as the kernel walks it, it gives the port's ``soa.fk_joints`` and
    ``soa.jacobian_cols`` and the JAX package's, within 1e-12 at f64 on the
    same numpy inputs."""
    from optik_tpu.ops import soa as jax_soa
    from optik_tpu_torch.ops import soa

    urdf, ee = chain_urdf(a), f"l{a}"
    spec = ChainSpec.from_urdf_str(urdf, "l0", ee)
    consts = soa.chain_constants(spec)
    lower, upper = ik.chain_bounds(spec)
    packed = lm_kernel.pack_runtime_chain(consts, lower, upper, np.float64)
    assert packed.size == lm_kernel.RUNTIME_HEAD \
        + (lm_kernel.JOINT_FLOATS + 2) * a and packed[13] == a
    np.testing.assert_array_equal(packed[-2 * a:-a], lower)
    np.testing.assert_array_equal(packed[-a:], upper)
    # The float32 array the kernel reads is this one rounded once.
    np.testing.assert_array_equal(
        lm_kernel.pack_runtime_chain(consts, lower, upper),
        packed.astype(np.float32))

    rng = np.random.default_rng(a)
    q = rng.uniform(lower, upper, size=(6, a))
    frames, r, t, cols = _walk_runtime_chain(packed, q)

    def stacked(v):
        return np.stack([np.broadcast_to(np.asarray(x, np.float64), (6,))
                         for x in v], axis=-1)

    ref_frames, ref_r, ref_t = soa.fk_joints(
        consts, [torch.tensor(q[:, j]) for j in range(a)])
    ref_cols = soa.jacobian_cols(consts, ref_frames, ref_r, ref_t)
    jr = JaxRobot.from_urdf_str(urdf, "l0", ee, dtype=jnp.float64)
    jconsts = jax_soa.chain_constants(jr.spec)
    jframes, jr_ee, jt_ee = jax_soa.fk_joints(
        jconsts, [jnp.asarray(q[:, j]) for j in range(a)])
    jcols = jax_soa.jacobian_cols(jconsts, jframes, jr_ee, jt_ee)
    for want_frames, want_r, want_t, want_cols in (
            (ref_frames, ref_r, ref_t, ref_cols),
            (jframes, jr_ee, jt_ee, jcols)):
        kw = dict(rtol=0, atol=1e-12)
        np.testing.assert_allclose(r.numpy(), stacked(
            [v for row in want_r for v in row]).reshape(6, 3, 3), **kw)
        np.testing.assert_allclose(t.numpy(), stacked(want_t), **kw)
        for j in range(a):
            rj, pj = want_frames[j]
            np.testing.assert_allclose(frames[j][1].numpy(), stacked(pj),
                                       **kw)
            dir_w = soa.mat_vec(rj, consts[2][j])
            np.testing.assert_allclose(frames[j][0].numpy(),
                                       stacked(dir_w), **kw)
            np.testing.assert_allclose(cols[j].numpy(),
                                       stacked(want_cols[j]), **kw)


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
    for name, (urdf, base, ee) in WIDE.items():
        out[name] = ChainSpec.from_urdf_str(urdf(), base, ee)
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


@pytest.mark.parametrize("robot", ["panda", "ur5", "mobile_panda", "chain12"])
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
