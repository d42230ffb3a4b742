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
    with pytest.raises(NotImplementedError, match="S=128"):
        robot.ik_batch(CFG.replace(max_restarts=256, seed_batch=128), tr, tt,
                       x0)


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
