"""The CUDA kernels on an NVIDIA card (marked ``cuda``: these skip on a
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
The option cases cover what ``chip_smoke.py`` covers: per-axis weights, any
seed count up to 64 (padded lanes, two-warp poses), Quality mode with and
without its success cap, ``restart_offset``, ``lane0_stream``, unlimited
restart rounds, and the three probe kernels.  The queue cases hold the
kernel's schedule to the same bitwise standard at its edges: one pose,
fewer poses than thread groups, batches that make every group (and every
pair of warps) draw many poses in one launch, padded lanes inside a group
that refills, and launches back to back on one stream.

The Jacobian and diff-IK cases at the end run no kernel of ours (that path
is plain eager tensor operations): they hold the entry points' contracts on
the card (f32 in, f32 out on the device, bounds, tracking against an f64
Jacobian, bitwise repeats and batch invariance, rescue, the ADMM route).
"""

import numpy as np
import pytest
import torch

from optik_tpu_torch import Robot, SolverConfig
from optik_tpu_torch.benchmarks import (bench_fp32_peak, exp_bisect,
                                        exp_warp_probe)
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


@pytest.fixture(scope="module", autouse=True)
def libraries(robot):
    """Build every Panda variant these tests launch, side by side (one nvcc
    each, about half a minute), instead of one after another at first use."""
    import concurrent.futures

    header = lm_kernel.KernelPlan(robot.spec, CFG).header
    # (quality, weighted, wide, fmad)
    variants = [(q, w, x, f) for q in (False, True) for w in (False, True)
                for x in (False, True) for f in (False, True)
                if not (w and x) and (not f or not (w or (q and x)))]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda v: lm_kernel.load_library(header, *v), variants))


def _problem(robot, seed=0, b=B):
    rng = np.random.default_rng(seed)
    lo, hi = robot.joint_limits()
    tr, tt = robot.fk_batch(rng.uniform(lo, hi, size=(b, 7)))
    x0 = torch.tensor(rng.uniform(lo, hi, size=(b, 7)), dtype=torch.float32,
                      device="cuda")
    return tr, tt, x0


CASES = [(64, 8), (8, 8), (24, 4), (24, 3), (48, 12), (64, 64), (40, 40)]


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


def test_more_than_64_lanes_run_the_plain_loop_on_the_card(robot):
    """S = 128 is more than the kernel holds: the facade routes the config
    to the plain loop on the card (no launch of the kernel) and solves."""
    cfg = SolverConfig.create("quality", max_restarts=256, seed_batch=128,
                              max_iters=32, tol_f=1e-6)
    tr, tt, x0 = _problem(robot, seed=6)
    lm_kernel.LAUNCHES = 0
    res = robot.ik_batch(cfg, tr, tt, x0)
    assert lm_kernel.LAUNCHES == 0
    assert res.x.is_cuda and res.x.dtype == torch.float32
    assert float(res.found.float().mean()) >= 0.99
    assert bool((res.cost[res.found] <= cfg.tol_f).all())


LANE_FIELDS = ("x", "f", "success", "restart_index", "succ_iters")
QUALITY = SolverConfig.create("quality", max_iters=32, tol_f=1e-6)
WEIGHTS = dict(linear_weight=(0.0, 1.0, 1.0), angular_weight=(0.5, 1.0, 2.0))
OPTION_CASES = {
    "weighted": (CFG.replace(**WEIGHTS), {}),
    "weighted_linear_only": (CFG.replace(linear_weight=(0.0, 1.0, 1.0)), {}),
    "weighted_quality": (QUALITY.replace(max_restarts=24, seed_batch=8,
                                         **WEIGHTS), {}),
    "quality_48_16": (QUALITY.replace(max_restarts=48, seed_batch=16), {}),
    "quality_no_reseed": (QUALITY.replace(max_restarts=8, seed_batch=8), {}),
    "quality_24_3": (QUALITY.replace(max_restarts=24, seed_batch=3), {}),
    "quality_128_64": (QUALITY.replace(max_restarts=128, seed_batch=64), {}),
    "quality_cap": (QUALITY.replace(max_restarts=12, seed_batch=4,
                                    quality_max_successes=1), {}),
    "quality_cap_two_warps": (QUALITY.replace(
        max_restarts=128, seed_batch=64, quality_max_successes=3), {}),
    "restart_offset": (CFG, {"restart_offset": 64}),
    "lane0_stream": (CFG, {"lane0_stream": True}),
    "quality_lane0_stream": (QUALITY.replace(max_restarts=24, seed_batch=8),
                             {"lane0_stream": True, "restart_offset": 24}),
}


def _lanes(robot, cfg, fmad=False, **kw):
    plan = lm_kernel.KernelPlan(robot.spec, cfg)
    tr, tt, x0 = _problem(robot)
    return plan, x0, lm_kernel.solve_kernel(plan, tr, tt, x0, fmad=fmad, **kw)


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_option_uncontracted_kernel_is_bitwise_plain(robot, case):
    cfg, kw = OPTION_CASES[case]
    plan, x0, k = _lanes(robot, cfg, **kw)
    tr, tt, _ = _problem(robot)
    p = lm_kernel.solve_plain(plan, tr, tt, x0, **kw)
    for name in LANE_FIELDS:
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    assert bool(k.success.any())
    # Restart indices stay local to the call.
    assert int(k.restart_index.max()) < plan.r_total


# (config, poses).  An H100 holds about 1,056 warps of this kernel: 4,224
# groups of 8 lanes, 8,448 of 4, 2,112 of 16, 528 pairs of warps.
QUEUE_CASES = {
    "one_pose": (CFG, 1),
    # Fewer poses than one block's groups: three are dead at their first
    # draw, and 5 is no multiple of a warp's 4 groups.
    "five_poses": (CFG, 5),
    "groups_refill_ragged": (CFG, 40003),
    # Padding lanes (S = 3 in 4 threads, 12 in 16) inside groups that draw
    # several poses.
    "three_lanes_refill": (CFG.replace(max_restarts=24, seed_batch=3), 20000),
    "twelve_lanes_refill": (CFG.replace(max_restarts=48, seed_batch=12),
                            6000),
    # A pair of warps draws several poses in one launch, with the Speed
    # freeze and with a Quality cap (both exchange every iteration).
    "pair_40_freeze": (CFG.replace(max_restarts=80, seed_batch=40), 8192),
    "pair_64_freeze": (CFG.replace(max_restarts=128, seed_batch=64), 8192),
    "pair_40_cap": (QUALITY.replace(max_restarts=80, seed_batch=40,
                                    quality_max_successes=2), 8192),
    "pair_64_cap": (QUALITY.replace(max_restarts=128, seed_batch=64,
                                    quality_max_successes=3), 8192),
}


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_queue_edges_uncontracted_kernel_is_bitwise_plain(robot, case):
    cfg, b = QUEUE_CASES[case]
    plan = lm_kernel.KernelPlan(robot.spec, cfg)
    tr, tt, x0 = _problem(robot, seed=5, b=b)
    k = lm_kernel.solve_kernel(plan, tr, tt, x0, fmad=False)
    p = lm_kernel.solve_plain(plan, tr, tt, x0, track_active=True)
    for name in LANE_FIELDS:
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    assert bool(k.success.any())
    # The groups ran each pose until its last lane stopped, no longer; the
    # warps executed at least those slots.
    assert int(k.lane_iters) == int(lm_kernel.pose_lane_iters(p.active_iters))
    assert lm_kernel.exec_slots(k) * plan.s >= int(k.lane_iters) * min(
        plan.s_pad, 32)
    prof = lm_kernel.schedule_profile(k)
    assert prof["span_ms"] > 0 and 0 <= prof["tail_share"] <= 1


def test_back_to_back_launches_reset_the_queue(robot):
    """Launches on one stream with no sync between them: each zeroes the
    queue's counter on the stream before it starts."""
    plan = lm_kernel.KernelPlan(robot.spec, CFG)
    first = _problem(robot, seed=6, b=6000)
    second = _problem(robot, seed=7, b=777)
    runs = [lm_kernel.solve_kernel(plan, *prob, fmad=False)
            for prob in (first, second, first, second)]
    torch.cuda.synchronize()
    for k, prob in zip(runs, (first, second)):
        p = lm_kernel.solve_plain(plan, *prob)
        for name in LANE_FIELDS:
            assert torch.equal(getattr(k, name), getattr(p, name)), name
    for a, b in ((runs[0], runs[2]), (runs[1], runs[3])):
        for name in LANE_FIELDS:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_options_change_the_solve(robot):
    _, x0, base = _lanes(robot, CFG)
    for case in ("weighted", "restart_offset", "lane0_stream"):
        cfg, kw = OPTION_CASES[case]
        _, _, lanes = _lanes(robot, cfg, **kw)
        assert not torch.allclose(lanes.x, base.x, atol=1e-3), case
    # lane0_stream starts lane 0 from table row 0 (the same for every
    # pose), restart_offset=64 draws another table.
    plan = lm_kernel.KernelPlan(robot.spec, CFG)
    tab0, tab64 = plan.table(x0.device), plan.table(x0.device, 64)
    assert not torch.equal(tab0, tab64)
    assert plan.table(x0.device, 64) is tab64      # cached per offset
    seeds = plan.seeds(x0, 0, lane0_stream=True)
    assert torch.equal(seeds[:, 0], tab0[0].expand(B, 7))


def test_success_cap_keeps_the_found_mask(robot):
    cfg = QUALITY.replace(max_restarts=12, seed_batch=4)
    for cap_cfg in (cfg, QUALITY.replace(max_restarts=128, seed_batch=64)):
        plan, x0, free = _lanes(robot, cap_cfg)
        _, _, capped = _lanes(robot, cap_cfg.replace(quality_max_successes=1))
        assert torch.equal(capped.success.any(dim=1), free.success.any(dim=1))
        # The cap ends a pose early: it never runs more lane-iterations.
        assert int(capped.lane_iters) < int(free.lane_iters)


def test_quality_through_the_facade(robot):
    cfg = SolverConfig.create("quality", max_restarts=256, seed_batch=64,
                              max_iters=48)
    tr, tt, x0 = _problem(robot, seed=2)
    lm_kernel.LAUNCHES = 0
    res = robot.ik_batch(cfg, tr, tt, x0)
    assert lm_kernel.LAUNCHES == 1 and res.sel_key is None
    assert float(res.found.float().mean()) >= 0.99
    assert bool((res.cost[res.found] <= cfg.tol_f).all())
    r, t = robot.fk_batch(res.x[res.found])
    torch.testing.assert_close(r, tr[res.found], rtol=0, atol=2e-3)
    torch.testing.assert_close(t, tt[res.found], rtol=0, atol=2e-3)
    # Quality returns the success nearest to the seed: never farther than
    # Speed's first success from the same restart stream.
    speed = robot.ik_batch(cfg.replace(solution_mode="speed"), tr, tt, x0)
    both = res.found & speed.found
    dq = (res.x - x0).norm(dim=1)[both]
    ds = (speed.x - x0).norm(dim=1)[both]
    assert float((dq <= ds + 1e-5).float().mean()) >= 0.99


def test_unlimited_rounds_through_the_facade(robot):
    cfg = CFG.replace(max_iters=3)       # one round leaves many unfound
    tr, tt, x0 = _problem(robot, seed=3)
    one = robot.ik_batch(cfg, tr, tt, x0)
    lm_kernel.LAUNCHES = 0
    unl = robot.ik_batch(cfg.replace(max_restarts=0, unlimited_rounds_cap=4),
                         tr, tt, x0)
    assert 1 < lm_kernel.LAUNCHES <= 4
    f1 = one.found
    assert 0 < int(f1.sum()) < B and int(unl.found.sum()) > int(f1.sum())
    assert bool((unl.found | ~f1).all())
    assert torch.equal(unl.x[f1], one.x[f1])
    assert torch.equal(unl.cost[f1], one.cost[f1])
    again = robot.ik_batch(cfg.replace(max_restarts=0,
                                       unlimited_rounds_cap=4), tr, tt, x0)
    assert torch.equal(again.x, unl.x) and torch.equal(again.found, unl.found)
    assert int(unl.lane_iters) > int(one.lane_iters)


def test_fp32_peak_kernels(robot):
    parity = bench_fp32_peak.check_parity()
    assert parity["max_rel_err"] <= 1e-5 and parity["plain_ms"] > 0
    x = bench_fp32_peak.make_input(4096, "cuda")
    bench_fp32_peak.LAUNCHES = 0
    for name in bench_fp32_peak.BODIES:
        out = bench_fp32_peak.run_body(name, x, 100)
        assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert bench_fp32_peak.LAUNCHES == 3
    with pytest.raises(ValueError, match="float32 CUDA"):
        bench_fp32_peak.run_kernel("ilp8", x.cpu(), 1)


def test_warp_probe_kernels(robot):
    exp_warp_probe.LAUNCHES = 0
    rows = exp_warp_probe.run_all("cuda")
    assert all(r["exact"] and r["max_abs_err"] == 0.0 for r in rows.values())
    assert exp_warp_probe.LAUNCHES == len(exp_warp_probe.CASES)
    for name in exp_warp_probe.LIBRARY_CASES:
        assert torch.equal(exp_warp_probe.library_case(name, "cuda"),
                           exp_warp_probe.run_kernel(name, "cuda"))


def test_bisect_variants(robot):
    prob = exp_bisect.make_problem(robot.fk_batch, robot.spec, "cuda")
    for _, max_iters, group_stop in exp_bisect.VARIANTS:
        px, pf = exp_bisect.plain_variant(prob, max_iters, group_stop)
        kx, kf = exp_bisect.kernel_variant(prob, max_iters, group_stop,
                                           fmad=False)
        assert torch.equal(kx, px) and torch.equal(kf, pf)
    # Three variants and the 2-round reseeding solve, counted at the launch.
    lm_kernel.LAUNCHES = 0
    rows = exp_bisect.run_all(prob)
    assert lm_kernel.LAUNCHES == 4 and all(r["ok"] for r in rows)
    assert rows[-1]["succ"] >= 0.9 * exp_bisect.P


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


# --- Jacobians and differential IK on the card --------------------------------


def _chain_urdf(n, planar=False):
    links = "".join(f'<link name="l{i}"/>' for i in range(n + 1))
    joints = "".join(
        f'<joint name="j{i}" type="revolute">'
        f'<parent link="l{i}"/><child link="l{i + 1}"/>'
        + ('<origin xyz="0.2 0 0" rpy="0 0 0"/><axis xyz="0 0 1"/>' if planar
           else f'<origin xyz="0.2 0 0.1" rpy="0 0 0"/>'
                f'<axis xyz="{"0 0 1" if i % 2 == 0 else "0 1 0"}"/>')
        + '<limit lower="-2.5" upper="2.5" effort="1" velocity="1"/></joint>'
        for i in range(n))
    return f'<robot name="chain{n}">{links}{joints}</robot>'


def _world_jacobian64(spec, x):
    """J_W of every configuration in f64 on the card: (B, 6, A)."""
    bot = Robot(spec, dtype=torch.float64, device="cuda")
    r, _ = bot.fk_batch(x.double())
    j = bot.jacobian_batch(x.double())
    return torch.cat([r @ j[:, :3], r @ j[:, 3:]], dim=1)


def _diffik_problem(robot, seed, b=B, reachable=False):
    rng = np.random.default_rng(seed)
    n = robot.num_positions()
    x0 = torch.tensor(rng.uniform(*robot.joint_limits(), size=(b, n)),
                      dtype=torch.float32, device="cuda")
    v_max = torch.tensor(rng.uniform(0.3, 1.2, size=(b, n)),
                         dtype=torch.float32, device="cuda")
    jw = _world_jacobian64(robot.spec, x0)
    if reachable:   # commands inside the reachable cone: alpha = 1 feasible
        inside = torch.tensor(rng.uniform(-0.2, 0.2, size=(b, n, 1)),
                              device="cuda")
        v_we = (jw @ inside)[:, :, 0].float()
    else:
        v_we = torch.tensor(rng.standard_normal((b, 6)), dtype=torch.float32,
                            device="cuda")
    return x0, v_we, v_max, jw


def _check_contracts(out, v_we, v_max, jw, track_tol=1.1e-5):
    alpha, v, ok = out
    assert alpha.dtype == v.dtype == torch.float32 and ok.dtype == torch.bool
    assert alpha.is_cuda and v.is_cuda and ok.is_cuda
    assert bool(torch.isfinite(alpha).all()) and bool(torch.isfinite(v).all())
    assert float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1 + 1e-6
    assert float((v.abs() - v_max).max()) <= 1e-6
    res = (jw @ v.double()[:, :, None])[:, :, 0] \
        - alpha.double()[:, None] * v_we.double()
    rel = res.abs().amax(dim=1) / (1 + v_we.double().abs().amax(dim=1))
    assert float(rel[ok].max()) <= track_tol


def test_jacobians_on_the_card(robot):
    from optik_tpu_torch.ops import kinematics

    x0, _, _, _ = _diffik_problem(robot, seed=20)
    jac = robot.jacobian_batch(x0)
    assert jac.shape == (B, 6, 7) and jac.dtype == torch.float32
    assert jac.is_cuda
    arr = kinematics.joint_jacobian(robot.params, x0)
    ref = Robot(robot.spec, dtype=torch.float64, device="cpu").jacobian_batch(
        x0.double().cpu())
    assert float((jac - arr).abs().max()) <= 1e-5
    assert float((jac.double().cpu() - ref).abs().max()) <= 1e-5
    row0 = robot.joint_jacobian(x0[0].double().cpu().numpy())
    assert row0.shape == (6, 7) and row0.dtype == np.float32
    assert float(np.abs(row0 - jac[0].cpu().numpy()).max()) <= 1e-5


@pytest.mark.parametrize("commands", ["random", "constant"])
def test_diff_ik_contracts_on_the_card(robot, commands):
    x0, v_we, v_max, jw = _diffik_problem(robot, seed=21)
    if commands == "constant":
        v_we = torch.tensor([0.0, 0.0, 0.1, 0.0, 0.0, 0.0],
                            device="cuda").repeat(B, 1)
        v_max = torch.full_like(v_max, 0.75)
    out = robot.diff_ik_batch(x0, v_we, v_max, rescue=False)
    _check_contracts(out, v_we, v_max, jw)
    assert float(out[2].float().mean()) >= 0.99
    # Against the port's own f64 solve on the host CPU.
    ref = Robot(robot.spec, dtype=torch.float64, device="cpu").diff_ik_batch(
        x0.double().cpu(), v_we.double().cpu(), v_max.double().cpu(),
        rescue=False)
    ok = out[2].cpu()
    assert int((ok != ref[2]).sum()) <= 1
    both = ok & ref[2]
    assert float((out[0].cpu().double() - ref[0])[both].abs().max()) <= 2e-4


def test_diff_ik_repeat_and_batch_invariance_are_bitwise(robot):
    x0, v_we, v_max, _ = _diffik_problem(robot, seed=22)
    out = robot.diff_ik_batch(x0, v_we, v_max, rescue=False)
    again = robot.diff_ik_batch(x0, v_we, v_max, rescue=False)
    part = robot.diff_ik_batch(x0[:37], v_we[:37], v_max[:37], rescue=False)
    for a, b, c in zip(out, again, part):
        assert torch.equal(a, b) and torch.equal(a[:37], c)
    one = robot.diff_ik(x0[0].double().cpu().numpy(),
                        v_we[0].double().cpu().numpy(),
                        v_max[0].double().cpu().numpy())
    assert bool(out[2][0]) and one is not None
    assert one[0] == float(out[0][0])
    assert one[1] == out[1][0].double().cpu().tolist()


def test_diff_ik_rescue_on_the_card(robot):
    # A healthy Panda batch: lanes that were ok come back bit for bit.
    x0, v_we, v_max, jw = _diffik_problem(robot, seed=23)
    a0, v0, ok0 = robot.diff_ik_batch(x0, v_we, v_max, rescue=False)
    a1, v1, ok1 = robot.diff_ik_batch(x0, v_we, v_max)
    assert bool(ok1[ok0].all())
    assert torch.equal(a1[ok0], a0[ok0]) and torch.equal(v1[ok0], v0[ok0])
    _check_contracts((a1, v1, ok1), v_we, v_max, jw)
    # The planar chain: the gauge rejects its lanes, the ADMM accepts all.
    planar = Robot.from_urdf_str(_chain_urdf(6, planar=True), "l0", "l6",
                                 device="cuda")
    x0, v_we, _, jw = _diffik_problem(planar, seed=24, b=64, reachable=True)
    v_max = torch.ones_like(x0)
    _, _, ok0 = planar.diff_ik_batch(x0, v_we, v_max, rescue=False)
    out = planar.diff_ik_batch(x0, v_we, v_max)
    assert not bool(ok0.all()) and bool(out[2].all())
    assert float(out[0].min()) >= 1 - 1e-3
    _check_contracts(out, v_we, v_max, jw, track_tol=5e-4)


def test_four_joints_route_to_the_admm_path():
    from optik_tpu_torch.solver import diffik

    bot = Robot.from_urdf_str(_chain_urdf(4), "l0", "l4", device="cuda")
    assert bot._diffik_solver() is None
    x0, v_we, _, jw = _diffik_problem(bot, seed=25, b=64, reachable=True)
    v_max = torch.ones_like(x0)
    out = bot.diff_ik_batch(x0, v_we, v_max)
    direct = diffik.diff_ik_admm_batch(bot.params, x0, v_we, v_max)
    for a, b in zip(out, direct):
        assert torch.equal(a, b)
    _check_contracts(out, v_we, v_max, jw, track_tol=2e-5)
    assert float(out[2].float().mean()) >= 0.9


def test_gauge_tie_takes_the_first_minimal_facet_on_the_card():
    from optik_tpu_torch.solver import gauge

    tie = torch.tensor([[3.0, 1.0, 1.0, 2.0], [1.0, 1.0, 1.0, 2.0],
                        [1.0, 5.0, 1.0, 2.0]], device="cuda")
    assert torch.argmin(tie, dim=0).tolist() == [1, 0, 0, 0]
    rng = np.random.default_rng(2)
    g = rng.standard_normal((7, 6, 256)).astype(np.float32)
    g[1] = g[0]
    vdir = rng.standard_normal((6, 256)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        gens = [[torch.tensor(g[i, k], device=dev) for k in range(6)]
                for i in range(7)]
        vv = [torch.tensor(vdir[k], device=dev) for k in range(6)]
        t, u = gauge.gauge_solve(gens, vv)
        assert t.dtype == torch.float32
        miss = torch.stack([sum(u[i] * gens[i][k] for i in range(7))
                            - t * vv[k] for k in range(6)]).abs().amax(dim=0)
        out[dev] = (t.cpu(), torch.stack(u).cpu(), miss.cpu() <= 1e-3)
    good = out["cuda"][2] & out["cpu"][2]
    assert int(good.sum()) >= 32
    assert float(((out["cuda"][0] - out["cpu"][0]).abs()
                  / out["cpu"][0])[good].max()) <= 1e-4
    assert float((out["cuda"][1] - out["cpu"][1])[:, good].abs().max()) <= 1e-3


# --- the multi-device paths (optik_tpu_torch.parallel) on the one card ---
# NCCL refuses two ranks on one device, so the card runs a real NCCL group
# of one rank and gloo ranks sharing it (gloo takes CUDA tensors for
# all_reduce, which is all the merge needs).  Several ranks on one card
# prove the merge, not the scaling.

QCFG = SolverConfig.create("quality", max_restarts=64, seed_batch=16,
                           max_iters=32)


def _host(*tensors):
    return tuple(t.cpu() for t in tensors)


def _same(a, b, fields=("found", "x", "cost", "iters")):
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in fields)


def _found_winners_equal(got, ref, x0=None):
    f = ref.found.cpu()
    ok = (torch.equal(got.found.cpu(), f)
          and torch.equal(got.x.cpu()[f], ref.x.cpu()[f])
          and torch.equal(got.cost.cpu()[f], ref.cost.cpu()[f]))
    if x0 is not None:
        ok = ok and torch.equal(got.x.cpu()[~f], x0.cpu()[~f]) \
            and bool(torch.isinf(got.cost.cpu()[~f]).all())
    return ok


def test_nccl_world_of_one_is_the_facade_bitwise(robot):
    from optik_tpu_torch.parallel import launch

    tr, tt, x0 = _problem(robot, seed=4)
    qtr, qtt, qx0 = _problem(robot, seed=5)
    cases = [launch.Case("seed_sharded", CFG, 1, 1, _host(tr, tt, x0)),
             launch.Case("cascade", CFG, 1, 1, _host(tr, tt, x0)),
             launch.Case("seed_sharded", QCFG, 1, 1, _host(qtr, qtt, qx0)),
             launch.Case("cascade", QCFG, 1, 1, _host(qtr, qtt, qx0))]
    (out,) = launch.spawn(launch.solve, 1, cases, robot.spec,
                          backend="nccl", timeout=300)
    ref = robot.ik_batch(CFG, tr, tt, x0)
    qref = robot.ik_batch(QCFG, qtr, qtt, qx0)
    assert _found_winners_equal(out[0][0], ref, x0)
    assert _same(out[1][0], ref) and int(out[1][0].overflow_count) == 0
    assert _found_winners_equal(out[2][0], qref, qx0)
    assert _same(out[3][0], qref)
    assert float(ref.found.float().mean()) >= 0.99


def test_gloo_ranks_sharing_the_card(robot):
    from optik_tpu_torch.parallel import launch
    from optik_tpu_torch.solver import ik as ik_mod

    tr, tt, x0 = _problem(robot, seed=6)
    qtr, qtt, qx0 = _problem(robot, seed=7)
    big, qbig = _host(tr, tt, x0), _host(qtr, qtt, qx0)
    lock = tuple(t[:128] for t in big)
    cases = [launch.Case("seed_sharded", c, *shape, inputs, repeat=2)
             for c, inputs in ((CFG, big), (QCFG, qbig))
             for shape in ((1, 2), (2, 2))]
    cases += [launch.Case("cascade", CFG, 2, 1, big),
              launch.Case("ik_sharded", CFG, 1, 2, lock)]
    ranks = launch.spawn(launch.solve, 4, cases, robot.spec, timeout=600)
    for k in range(len(cases)):
        outs = [r[k] for r in ranks if r[k] is not None]
        assert all(_same(outs[0][0], o) for run in outs for o in run)
    ref = robot.ik_batch(CFG, tr, tt, x0)
    qref = robot.ik_batch(QCFG, qtr, qtt, qx0)
    for k in (0, 1):  # Speed: the found mask; winners within the limits
        got = ranks[0][k][0]
        assert torch.equal(got.found, ref.found.cpu())
        assert bool((got.cost[got.found] <= CFG.tol_f).all())
        r, t = robot.fk_batch(got.x[got.found].cuda())
        torch.testing.assert_close(r, tr[got.found.cuda()], rtol=0,
                                   atol=2e-3)
        torch.testing.assert_close(t, tt[got.found.cuda()], rtol=0,
                                   atol=2e-3)
    for k in (2, 3):  # Quality: bitwise the single-device solve
        assert _found_winners_equal(ranks[0][k][0], qref, qx0)
    assert _same(ranks[0][4][0], ref)
    plain = ik_mod.build_batch_solver(robot.spec, CFG, torch.float32,
                                      device="cuda")(
        *(t.cuda() for t in lock))
    assert _same(ranks[0][5][0], plain)
    assert int(ranks[0][5][0].lane_iters) == int(plain.lane_iters)
