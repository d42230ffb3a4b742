#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a line; any failed check exits non-zero):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. the build of every library the script uses, one nvcc per variant,
     all started together: the LM kernel (optik_tpu_torch/csrc/lm_kernel.cu)
     with the Panda's chain compiled in, in Speed, Speed+weights, Speed with
     two-warp poses and Quality, contracted and uncontracted (--fmad=false),
     Quality with two-warp poses (capped Quality at 64 lanes, phase 9),
     contracted and uncontracted, the UR5's Speed library (phase 16) and
     the UR3e's (phase 9c), contracted and uncontracted,
     phase 18's chains (the mobile Panda in Speed, Speed+weights and
     Quality, 16 joints and the widest chain folded into a library in
     Speed, each contracted and uncontracted; the widest first), the
     run-time chain's libraries (-DOPTIK_RUNTIME_CHAIN: Speed,
     Speed+weights and Quality, contracted and uncontracted, one of each
     for every chain; their registers, spills and resident warps), the
     FP32 throughput probe and the primitive probes, and beside them the
     native host library and the C++ example (optik_tpu_torch/native,
     examples/example.cpp, g++); registers, spills,
     block size and resident warps per SM of each, and the FP32 operations
     in the Speed kernel's SASS (which must hold no double-precision
     arithmetic: the chain's static terms fold at compile time);
  3. the LM kernel against its plain torch version (both in kernel math
     mode, on the same uploaded seed table) at B=4096 with the main config:
     the uncontracted build is bitwise equal to it lane by lane; the
     solver's build differs only at the rounding level, so found masks
     differ on at most 0.1% of poses, every found cost <= tol_f, FK of every
     found x is within 2e-3 of its target, and shared winners reach the
     same pose within 4e-3;
  4. bitwise determinism: a repeat solve, and the first 1024 poses solved
     alone, give identical x, found and cost;
  5. the kernel against its plain version at the main shape, B=131,072, with
     the checks of phase 3 (uncontracted bitwise in every lane; contracted
     within the rounding-level limits), both versions' times there, and the
     lane-iterations the inputs need (the plain loop's track_active probe),
     from which the kernel's roofline bound follows; the kernel's schedule
     probe there: the tail share of the launch (what remains after the last
     draw from the pose queue) and the occupied share of the warp slots it
     executed;
  6. the main path, Robot.from_urdf_file -> fk_batch -> ik_batch in Speed
     mode on the Panda at B=131,072 (64 restarts, 8 lanes, 32 iterations,
     tol_f 1e-6, f32): the launch counter rises, success >= 0.99, every
     found cost <= tol_f, FK of found x within 2e-3; solves/s; a profiler
     count of the CUDA synchronisations in 8 chained calls whose summed
     found_count is fetched once (none beyond that fetch);
  7. the Quality path at full width, Robot.ik_batch with 256 restarts, 64
     lanes, 48 iterations at B=4096, with the same checks, and the Quality
     kernel against its plain version on the same B=4096 inputs
     (uncontracted bitwise; contracted within the limits of phase 3);
  8. unlimited restart rounds (max_restarts=0, at most 4 rounds) at
     B=131,072: more than one launch per solve, a found mask that contains
     the one-round mask, round-1 results kept bitwise, repeat bitwise equal;
  9. option cases at B=512, uncontracted kernel bitwise equal to plain:
     per-axis weights (and a result that differs from the unweighted one),
     seed counts 3, 12 and 64, Quality with 16 lanes, Quality with a
     success cap, capped Quality at 256 restarts on 64 lanes (cap 8, its
     poses on a pair of warps; success >= 0.99), restart_offset and
     lane0_stream; then S=128 (Quality, 256
     restarts, 128 lanes), more lanes per pose than the kernel holds,
     through Robot.ik_batch: it runs on the card on the plain loop (the
     launch counter does not rise: the route is by config), success >=
     0.99, every found cost <= tol_f, FK of found x within 2e-3, found masks
     within 0.1% of the port's own f64 plain loop on the host CPU over the
     same inputs (a comparison, never a substitute); (9c) the UR3e,
     Robot.ik_batch in the main config at B=512: one launch, success >=
     0.99, every found cost <= tol_f, FK of found x within 2e-3, and its
     uncontracted kernel bitwise equal to plain;
 18. chains wider than the Panda, after 9 and before 10: (a) the main path
     on the 11-joint mobile Panda (the repo's Panda on a holonomic base
     with a lift, written by mobile_panda_urdf), Robot.from_urdf_str ->
     fk_batch -> ik_batch in Speed at B=131,072 with the main config: one
     launch per solve, success >= 0.99, every found cost <= tol_f, FK of
     found x within 2e-3, solves/s, and on the same inputs the kernel
     against its plain version as in phase 5; (b) its kernel against its
     plain version at B=4096 in Speed, Speed with weights and Quality (256,
     64, 48): uncontracted bitwise, contracted within the limits of phase
     3, success within 0.001; (c) 16 joints and the widest chain folded
     into a library (lm_kernel.MAX_DOF), where the per-lane state spills,
     at B=131,072: uncontracted bitwise, contracted within the limits of
     phase 3; after (a) and (c), on the same inputs and with the same
     checks, the run-time-chain form of the kernel at 11, 16 and 32
     joints, for the record; (e) the run-time chain's main path: 48 and 64
     joints through Robot.ik_batch at B=131,072 as in (a) (five solves,
     five launches, the plain loop never run), then its kernel against its
     plain version there as in phase 5; (f) 48 joints at B=4096 in Speed
     with weights and Quality (256, 64, 48) as in (b); (g) 128 joints
     through ik_batch at B=4096 as in (e): no cap; every run-time row
     loads the same library file; (d) a float64 Panda Robot through
     ik_batch on the card: no launch (lm_kernel.kernel_runs routes it to
     the plain loop), found masks within 0.1% of the host's f64 plain
     loop.  Per DoF (7, 11, 16, 32 folded; 11, 16, 32, 48, 64, 128 at run
     time): registers, spills, resident warps, nvcc seconds, the run-time
     chain's scratch bytes per lane, kernel and plain ms, lane-iterations
     per solve, FP32 operations per lane-iteration and the bound;
     lm_solve's "wide" object and the lm_solve_runtime_chain entry of the
     kernels line hold them;
 10. the probes: fp32_peak (three bodies: uncontracted bitwise at full
     shape and depth, contracted within 1e-5 relative at 4 trips, then
     Gop/s), warp_probe (seven cases exact, the four that one PyTorch call
     computes also against that call, both sides prepared alike and timed
     in turns, and each side's device time alone from the profiler) and the
     exp_bisect variants against their plain versions;
 11. a torch.profiler split of device time on the Speed and Quality paths;
 12. Jacobians: Robot.jacobian_batch (SoA path) at B=131,072 on the Panda in
     f32 against the array path (ops/kinematics.joint_jacobian) there and
     against the same call in f64 on the host CPU for the first 4,096
     configurations (both within 1e-5), and the scalar joint_jacobian
     against row 0;
 13. the diff-IK main path at full width, Robot.diff_ik_batch(x0, V_WE,
     v_max, rescue=False) on the Panda in f32 at B=4,096 and B=131,072
     (plain eager tensor operations: no kernel of the JAX package lies on
     this path, so none of ours does), with a constant command (V_WE =
     [0, 0, 0.1, 0, 0, 0], v_max = 0.75) and with random commands: f32
     outputs on the card, 0 <= alpha <= 1 + 1e-6, |v| <= v_max + 1e-6, every
     ok lane tracks |J_W v - alpha V|_inf <= 1.1e-5 (1 + |V|_inf) with J_W
     recomputed in f64 (the solver's own gate is 1e-5 on its f32 Jacobian;
     the f64 recomputation moves a residual by the Jacobian's rounding), ok
     rate >= 0.99, ok masks within 0.1% and alpha within 2e-4 of the port's
     own f64 run on the host CPU over the first 4,096 lanes (a comparison,
     never a substitute), repeat and first-1,024-alone bitwise equal, B=1
     through Robot.diff_ik equal to lane 0, no kernel whose name contains
     "double"; steps/s, device time, launches per call, device-busy share
     and peak memory;
 14. rescue and the ADMM path: rescue=True on the same batches at both
     sizes (ok lanes bitwise kept, ok rate not lower, the failed lanes
     re-solved at their true count), a planar 6-joint chain at B=64
     (rescue=False rejects lanes, rescue=True accepts all with alpha >=
     1 - 1e-3 and tracking within 5e-4), a 4-joint chain through
     diff_ik_admm_batch (bounds and tracking), and an exact tie in the
     gauge's argmin (the first minimal facet wins on the card as on the
     CPU).
16. the native latency path and the success-parity harnesses
     (optik_tpu_torch/benchmarks/parity_*.py), after 14 and before 15: (a)
     the native binding's FK and Jacobian (f64, host) on 4,096 Panda
     configurations within 2e-5 of Robot.fk_batch and jacobian_batch on the
     card, then 200 random reachable poses solved by HostChain.ik and by
     scalar Robot.ik on the card (B=1 through the kernel, warmed), p50 and
     p90 latency of each, every found solution within tol_f and FK 2e-3;
     (b) parity_native at its full 98,304 poses: kernel (Robot.ik_batch,
     lm_solve) and native success rates, the failure overlap and both wall
     times, kernel success >= 0.999, every found cost <= tol_f and FK within
     2e-3; (c) parity_hard's engine and native columns at 10,000 poses per
     cell (panda_uniform, panda_normal, ur5_tight; weak and strong budgets;
     the engine at 32 iterations beside the weak budget), every found pose
     checked as in (b), strong-budget panda_uniform >= 0.99; the SLSQP
     column (CPU time) stays off the card's run; (d) example_cpp's 10,000
     poses on the host, its two lines beside the host CPU's model; the
     phase's wall time;
15. the multi-device paths of optik_tpu_torch.parallel on
     the one card: (a) a real NCCL group of one rank, a (1, 1) mesh:
     build_seed_sharded_solver and build_sharded_cascade at the main
     config (B=131,072) and the Quality config (B=4,096), bitwise equal to
     Robot.ik_batch, one launch per solve, solves/s of all three in turns
     and the device time outside the LM kernel (the merge); (b) a gloo world
     of 4 ranks sharing the card (NCCL refuses two ranks on one device):
     seed-sharded on (1, 2) and (2, 2) meshes, found masks bitwise the
     single-device ones, Quality x and cost bitwise, Speed winners within
     tol_f, repeats bitwise, the ranks agree, each rank's kernel alone (in
     turns) with its schedule probe's tail, and the merge's time; (c) the
     sharded single-shot path on (2, 1) bitwise Robot.ik_batch on the whole
     batch; (d) ik_sharded (the plain loop) on (1, 2) at B=1,024 bitwise the
     unsharded plain loop, lane_iters equal.  Several ranks on one card
     prove the merge, not the scaling.  Phase 6 calls ik_batch in ikbench's
     form (validate_seeds=False, rescue_overflow=False; overflow_count 0).
Then one JSON line with the diff-IK, S=128, wide-chain, run-time-chain,
float64, native, parity and sharded paths, one with every kernel
(lm_solve's launches on phases 9 and 16 among its fields;
lm_solve_runtime_chain's per DoF) and, last, the result line.  Without a
card, or run from a directory that holds no checkout, it exits 2 and prints
no result.
"""

import concurrent.futures
import json
import multiprocessing
import pathlib
import re
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
B_CHECK = 4096
B_MAIN = 131072
B_QUALITY = 4096
B_OPT = 512
B_DIFFIK = (4096, 131072)
B_ADMM = 64
B_LOCKSTEP = 1024      # ik_sharded (the plain loop) on two ranks
SHARD_WORLD = 4        # gloo ranks sharing the one card
JAC_TOL = 1e-5         # f32 Jacobian entries against f64 (|J| is O(1))
TRACK_TOL = 1.1e-5     # the solver's gate, 1e-5, plus the f32 Jacobian's rounding
BOUND_EPS = 1e-6
ALPHA_TOL = 2e-4       # f32 against f64 alpha (tests/test_gauge.py, against the LP)
MAIN = dict(max_restarts=64, seed_batch=8, max_iters=32, tol_f=1e-6)
QUALITY = dict(max_restarts=256, seed_batch=64, max_iters=48)
S128 = dict(max_restarts=256, seed_batch=128)  # more lanes than a kernel pose
N_NATIVE_KIN = 4096
N_LATENCY = 200
N_PARITY_NATIVE = 98304  # parity_native's 6 batches of 16,384
N_HARD = 10000
NATIVE_TOL = 2e-5      # f32 on the card against the native f64
FK_TOL = 2e-3         # cost <= 1e-6 is a pose residual of ~1e-3
MASK_DIFF_FRAC = 1e-3  # marginal poses (cost within ~1e-7 of tol_f)
LANE_FIELDS = ("x", "f", "success", "restart_index", "succ_iters")
# Phase 18's weighted case on the mobile Panda: every weight >= 1, so a
# weighted cost <= tol_f bounds the pose error as the unweighted cost does
# and phase 3's FK check holds as it stands.
WIDE_WEIGHTS = dict(linear_weight=(1.0, 2.0, 1.5),
                    angular_weight=(2.0, 1.0, 1.5))
# Phase 18's run-time-chain arms: the main path at B_MAIN, and the chain
# that shows there is no cap at B_CHECK.
RUNTIME_MAIN_DOF = (48, 64)
RUNTIME_NO_CAP_DOF = 128


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def usage_text(u: dict) -> str:
    return (f"{u['registers']} registers, {u['stack']} B stack, "
            f"{u['spill_stores']}/{u['spill_loads']} B spilled")


def sass_fp32_counts(build, lib_path):
    """Static counts of the FP32 arithmetic opcodes in a library's SASS
    ({"FFMA": n, ...}), or None where the toolkit has no cuobjdump."""
    tool = build.find_cuda_tool("cuobjdump")
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    names = ("FFMA", "FMUL", "FADD", "MUFU", "DFMA", "DMUL", "DADD")
    ops = re.findall(r"\b(" + "|".join(names) + r")\b", out.stdout)
    return {k: ops.count(k) for k in names}


def problem(robot, b, seed):
    """Reachable targets (FK of random configurations) and random seeds."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lo, hi = robot.joint_limits()
    tr, tt = robot.fk_batch(rng.uniform(lo, hi, size=(b, lo.shape[0])))
    x0 = torch.tensor(rng.uniform(lo, hi, size=(b, lo.shape[0])),
                      dtype=torch.float32, device="cuda")
    return tr, tt, x0


def check_solutions(robot, res, tr, tt, tol_f, what):
    import torch

    n, a = res.found.shape[0], robot.num_positions()
    check(res.x.shape == (n, a) and bool(torch.isfinite(res.x).all()),
          f"{what}: x not finite of shape ({n}, {a})")
    cost = res.cost[res.found]
    check(bool((cost <= tol_f).all()),
          f"{what}: a found cost exceeds tol_f ({float(cost.max())})")
    r, t = robot.fk_batch(res.x[res.found])
    err = max(float((r - tr[res.found]).abs().max()),
              float((t - tt[res.found]).abs().max()))
    check(err <= FK_TOL, f"{what}: FK of a found x misses its target by "
          f"{err}")
    return err


def timed(fn, reps):
    """Median host-clock seconds of fn() ending in a device sync."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def profile_split(fn, reps):
    """Device time by kernel name over ``reps`` warm calls of fn():
    {"kernels": {name: ms}, "launches": device events counted,
    "window_ms": host ms of the profiled window}, or None when the
    profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    kernels, launches = {}, 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            if us > 0:
                kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
                launches += ev.count
    if not kernels:
        return None
    return {"kernels": kernels, "launches": launches, "window_ms": window_ms}


def sync_count(fn):
    """CUDA runtime synchronisations the profiler sees in one fn() beyond
    those it sees around a single fetch of a device scalar (so 0 for a
    function that synchronises once, whatever the profiler adds itself);
    None where it records no CUDA runtime call at all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def count(f):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            f()
        names = {ev.key: ev.count for ev in prof.key_averages()}
        if not any(k.startswith("cuda") for k in names):
            return None
        return sum(n for k, n in names.items()
                   if k.startswith("cuda") and "Synchronize" in k)

    one = torch.ones((), device="cuda")
    base, got = count(lambda: int(one + 1)), count(fn)
    return None if base is None or got is None else got - base


def lanes_equal(k, p, what):
    import torch

    for name in LANE_FIELDS:
        check(torch.equal(getattr(k, name), getattr(p, name)),
              f"{what}: uncontracted kernel differs from plain in lane "
              f"{name}")


def winner_restart(lanes, res):
    """Restart index of each pose's winning lane (-1 where not found):
    the lane whose solution the selection returned."""
    import torch

    hit = (lanes.x == res.x[:, None, :]).all(dim=-1) & lanes.success
    idx = torch.argmax(hit.to(torch.int8), dim=1)
    rows = torch.arange(hit.shape[0], device=hit.device)
    return torch.where(res.found, lanes.restart_index[rows, idx], -1)


def compare_contracted(robot, lm_kernel, plan, tr, tt, x0, lanes_p, what):
    """The solver's (contracted) build against the plain version, held to
    the rounding-level limits of phase 3.  Returns (kernel result, pose
    difference on shared winners)."""
    import torch

    b = x0.shape[0]
    lanes_k = lm_kernel.solve_kernel(plan, tr, tt, x0)
    k = lm_kernel.select(plan, lanes_k, x0)
    p = lm_kernel.select(plan, lanes_p, x0)
    torch.cuda.synchronize()
    n_diff = int((k.found != p.found).sum())
    check(n_diff <= max(1, MASK_DIFF_FRAC * b),
          f"{what}: found masks differ on {n_diff} of {b} poses")
    tol_f = plan.cfg.tol_f
    fk_k = check_solutions(robot, k, tr, tt, tol_f, f"{what} kernel")
    fk_p = check_solutions(robot, p, tr, tt, tol_f, f"{what} plain")
    # Where both picked the same restart, both reached the same pose; x
    # itself may drift along the arm's self-motion (7 joints, 6 pose
    # constraints) once contraction-level differences part the paths.
    same = k.found & p.found & (winner_restart(lanes_k, k)
                                == winner_restart(lanes_p, p))
    rk, tk = robot.fk_batch(k.x[same])
    rp, tp = robot.fk_batch(p.x[same])
    pose_err = max(float((rk - rp).abs().max()),
                   float((tk - tp).abs().max()))
    check(pose_err <= 2 * FK_TOL,
          f"{what}: kernel and plain poses differ by {pose_err} on a shared "
          f"winner")
    print(f"{what}: kernel vs plain @B={b}: found {int(k.found.sum())} / "
          f"{int(p.found.sum())}, mask differs on {n_diff}, same winner on "
          f"{int(same.sum())}, pose |d| {pose_err:.3g} (limit {2 * FK_TOL}), "
          f"x drift {float((k.x[same] - p.x[same]).abs().max()):.3g}, FK "
          f"err {fk_k:.3g} / {fk_p:.3g} (limit {FK_TOL})", flush=True)
    return k, pose_err


def schedule_line(lm_kernel, lanes, what):
    """Print and return the kernel's schedule probe of one launch."""
    prof = lm_kernel.schedule_profile(lanes)
    print(f"schedule {what}: {prof['warps']} warps, span "
          f"{prof['span_ms']:.3f} ms, tail after the last draw "
          f"{prof['tail_ms']:.3f} ms = {100 * prof['tail_share']:.1f}%; 50 / "
          f"90 / 99 / 100% of the warps had left by "
          + " / ".join(f"{v:.3f}" for v in prof["exit_ms"]) + " ms; pose "
          f"groups ran {prof['lane_iters_per_solve']:.1f} lane-iterations "
          f"per solve in {prof['held_slots_per_solve']:.1f} held slots "
          f"({prof['executed_slots_per_solve']:.1f} executed): occupied "
          f"share {prof['occupied_share']:.3f}", flush=True)
    return prof


def lm_bytes(a, b, s, r):
    """Bytes one solve must move: seeds, targets and the seed table read
    once, x, f, success, restart index and iterations written once."""
    lanes = b * s
    return (a * lanes * 4 + 12 * b * 4 + r * a * 4
            + (a + 1) * lanes * 4 + 9 * lanes)


def bound(ops, nbytes):
    """(bound_ms, bound_by) on this card: the larger of operations over the
    FP32 peak and bytes over the memory rate (utils/roofline.py)."""
    import torch

    from optik_tpu_torch.utils import roofline

    return roofline.bound_ms(ops, nbytes, torch.cuda.get_device_name(0))


def world_jacobian(robot, x):
    """J_W = blockdiag(R_WE) J_local of every configuration, in the
    robot's dtype on its device: (B, 6, A)."""
    import torch

    r, _ = robot.fk_batch(x)
    j = robot.jacobian_batch(x)
    return torch.cat([r @ j[:, :3], r @ j[:, 3:]], dim=1)


def track_residual(jw, alpha, v, v_we):
    """|J_W v - alpha V|_inf / (1 + |V|_inf) per lane, in jw's dtype."""
    v_we = v_we.to(jw.dtype)
    res = (jw @ v.to(jw.dtype)[:, :, None])[:, :, 0] \
        - alpha.to(jw.dtype)[:, None] * v_we
    return res.abs().amax(dim=1) / (1.0 + v_we.abs().amax(dim=1))


def check_diffik_contracts(out, v_we, v_max, jw, what, track_tol=TRACK_TOL):
    """The bound and tracking contracts of one diff-IK result; returns
    (ok rate, largest tracking residual over the ok lanes)."""
    import torch

    alpha, v, ok = out
    b, n = v_max.shape
    check(alpha.shape == (b,) and v.shape == (b, n) and ok.shape == (b,),
          f"{what}: output shapes {tuple(alpha.shape)}, {tuple(v.shape)}, "
          f"{tuple(ok.shape)}")
    check(alpha.dtype == torch.float32 and v.dtype == torch.float32
          and ok.dtype == torch.bool and alpha.is_cuda and v.is_cuda
          and ok.is_cuda, f"{what}: outputs are not f32 / bool on the card")
    check(bool(torch.isfinite(alpha).all()) and bool(torch.isfinite(v).all()),
          f"{what}: alpha or v not finite")
    check(float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1 + BOUND_EPS,
          f"{what}: alpha outside [0, 1] ({float(alpha.min())}, "
          f"{float(alpha.max())})")
    over = float((v.abs() - v_max).max())
    check(over <= BOUND_EPS, f"{what}: |v| exceeds v_max by {over}")
    check(bool(ok.any()), f"{what}: no lane is ok")
    res = float(track_residual(jw, alpha, v, v_we)[ok].max())
    check(res <= track_tol, f"{what}: an ok lane misses J_W v = alpha V by "
          f"{res} (1 + |V|), limit {track_tol}")
    return float(ok.float().mean()), res


def diffik_phases(robot, Robot, event_ms):
    """Phases 12-14; returns the entries of the ``paths`` line."""
    import numpy as np
    import torch

    from optik_tpu_torch.ops import kinematics
    from optik_tpu_torch.models.synthetic import chain_urdf, planar_urdf
    from optik_tpu_torch.solver import diffik, gauge

    panda = robot.spec
    cpu64 = Robot(panda, dtype=torch.float64, device="cpu")
    gpu64 = Robot(panda, dtype=torch.float64, device="cuda")
    b_small, b_big = B_DIFFIK
    h = 1024
    rng = np.random.default_rng(4)
    lo, hi = robot.joint_limits()
    x0 = torch.tensor(rng.uniform(lo, hi, size=(b_big, 7)),
                      dtype=torch.float32, device="cuda")
    paths = []

    # 12. Jacobians: SoA against the array path and against f64 on the host.
    jac = robot.jacobian_batch(x0)
    check(jac.shape == (b_big, 6, 7) and jac.dtype == torch.float32
          and jac.is_cuda and bool(torch.isfinite(jac).all()),
          "jacobian_batch: not a finite f32 (B, 6, 7) tensor on the card")
    jac_arr = kinematics.joint_jacobian(robot.params, x0)
    d_arr = float((jac - jac_arr).abs().max())
    jac_ref = cpu64.jacobian_batch(x0[:b_small].double().cpu())
    d_ref = float((jac[:b_small].double().cpu() - jac_ref).abs().max())
    row0 = robot.joint_jacobian(x0[0].double().cpu().numpy())
    d_row = float(np.abs(row0 - jac[0].cpu().numpy()).max())
    check(row0.shape == (6, 7) and max(d_arr, d_ref, d_row) <= JAC_TOL,
          f"Jacobians differ: SoA against the array path {d_arr}, against "
          f"f64 on the host {d_ref}, scalar against row 0 {d_row} (limit "
          f"{JAC_TOL})")
    jac_s = timed(lambda: robot.jacobian_batch(x0), 5)
    jac_ms = event_ms(lambda: robot.jacobian_batch(x0), 5)
    jac_prof = profile_split(lambda: robot.jacobian_batch(x0), 1)
    jac_launches = None if jac_prof is None else jac_prof["launches"]
    print(f"Jacobians @B={b_big}: jacobian_batch (SoA) against the array "
          f"path |d| {d_arr:.3g}, against f64 on the host CPU (first "
          f"{b_small}) {d_ref:.3g}, scalar joint_jacobian against row 0 "
          f"{d_row:.3g} (limit {JAC_TOL}); {b_big / jac_s:.0f} Jacobians/s "
          f"(median of 5, {jac_s * 1e3:.2f} ms/call), {jac_ms:.2f} ms by "
          f"CUDA events, launches per call "
          + ("not measured" if jac_launches is None else f"{jac_launches}"),
          flush=True)
    paths.append({"name": "jacobian_batch", "B": b_big, "per_s": b_big / jac_s,
                  "ms": jac_s * 1e3, "event_ms": jac_ms,
                  "launches_per_call": jac_launches,
                  "max_abs_err_vs_f64": d_ref})
    del jac, jac_arr

    # 13. The diff-IK main path.  The small batch is the first lanes of the
    # large one, so every batch-invariance check compares lanes bitwise.
    jw64 = world_jacobian(gpu64, x0.double())
    commands = {
        "constant": (
            torch.tensor([0.0, 0.0, 0.1, 0.0, 0.0, 0.0], dtype=torch.float32,
                         device="cuda").repeat(b_big, 1),
            torch.full((b_big, 7), 0.75, dtype=torch.float32, device="cuda")),
        "random": (
            torch.tensor(rng.standard_normal((b_big, 6)), dtype=torch.float32,
                         device="cuda"),
            torch.tensor(rng.uniform(0.3, 1.2, size=(b_big, 7)),
                         dtype=torch.float32, device="cuda")),
    }
    gauge_out = {}
    for name, (v_we, v_max) in commands.items():
        ref = cpu64.diff_ik_batch(
            x0[:b_small].double().cpu(), v_we[:b_small].double().cpu(),
            v_max[:b_small].double().cpu(), rescue=False)
        outs = {}
        for b in (b_big, b_small):
            args = (x0[:b], v_we[:b], v_max[:b])

            def step():
                return robot.diff_ik_batch(*args, rescue=False)

            what = f"diff-IK {name} @B={b}"
            step()  # warm: subset tables, allocator
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mb = torch.cuda.memory_allocated() / 2**20
            out = step()
            torch.cuda.synchronize()
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            rate, res = check_diffik_contracts(out, v_we[:b], v_max[:b],
                                               jw64[:b], what)
            check(rate >= 0.99, f"{what}: ok rate {rate} < 0.99")
            again = step()
            check(all(torch.equal(a, c) for a, c in zip(out, again)),
                  f"{what}: a repeat call is not bitwise equal")
            outs[b] = out
            # Against the port's own f64 run on the host CPU (first lanes).
            a32, ok32 = out[0][:b_small].cpu(), out[2][:b_small].cpu()
            n_diff = int((ok32 != ref[2]).sum())
            check(n_diff <= max(1, MASK_DIFF_FRAC * b_small),
                  f"{what}: ok masks differ from f64 on {n_diff} of "
                  f"{b_small} lanes")
            both = ok32 & ref[2]
            d_alpha = float((a32.double() - ref[0])[both].abs().max())
            check(d_alpha <= ALPHA_TOL, f"{what}: alpha differs from f64 by "
                  f"{d_alpha} (limit {ALPHA_TOL})")
            step_s = timed(step, 5)
            dev_ms = event_ms(step, 3)
            prof = profile_split(step, 1)
            if prof is None:
                launches = busy = prof_ms = None
                prof_text = "the profiler saw no device time (launches and "\
                    "device-busy share not measured)"
            else:
                doubles = sorted(k for k in prof["kernels"] if "double" in k)
                check(not doubles, f"{what}: float64 kernels in an f32 "
                      f"call: {doubles[:3]}")
                launches = prof["launches"]
                prof_ms = sum(prof["kernels"].values())
                busy = prof_ms / (step_s * 1e3)
                prof_text = (f"{launches} launches per call, "
                             f"{prof_ms:.2f} ms of device time in them "
                             f"(profiler) = device-busy share {busy:.3f} of "
                             f"the unprofiled call, no float64 kernel")
            print(f"{what}: ok rate {rate:.6f}, tracking residual of ok "
                  f"lanes <= {res:.3g} (1 + |V|) in f64 (limit {TRACK_TOL}), "
                  f"alpha in [{float(out[0].min()):.3g}, "
                  f"{float(out[0].max()):.7g}]; against f64 on the host CPU "
                  f"(comparison, first {b_small} lanes): masks differ on "
                  f"{n_diff}, alpha |d| {d_alpha:.3g} (limit {ALPHA_TOL}); "
                  f"repeat bitwise equal; {b / step_s:.0f} steps/s (median "
                  f"of 5, {step_s * 1e3:.2f} ms/call), {dev_ms:.2f} ms from "
                  f"first to last kernel (CUDA events); {prof_text}; peak "
                  f"memory {peak_mb:.1f} MB ({base_mb:.1f} MB held before "
                  f"the call)", flush=True)
            paths.append({
                "name": "diff_ik_batch", "commands": name, "B": b,
                "steps_per_s": b / step_s, "ms": step_s * 1e3,
                "event_ms": dev_ms, "launches_per_call": launches,
                "profiler_device_ms": prof_ms, "device_busy_share": busy,
                "peak_memory_mb": peak_mb, "held_before_mb": base_mb,
                "ok_rate": rate, "track_residual": res,
                "alpha_abs_err_vs_f64": d_alpha, "ok_mask_diff_vs_f64": n_diff})
        big, small = outs[b_big], outs[b_small]
        alone = robot.diff_ik_batch(x0[:h], v_we[:h], v_max[:h], rescue=False)
        check(all(torch.equal(a[:b_small], c) for a, c in zip(big, small))
              and all(torch.equal(a[:h], c) for a, c in zip(big, alone)),
              f"diff-IK {name}: lanes depend on the batch they are solved in")
        one = robot.diff_ik(x0[0].double().cpu().numpy(),
                            v_we[0].double().cpu().numpy(),
                            v_max[0].double().cpu().numpy())
        # Lane 0 is ok for both command sets of this seed (diff_ik rescues
        # by default, so a rejected lane would prove nothing here).
        check(bool(big[2][0]) and one is not None
              and one[0] == float(big[0][0])
              and one[1] == big[1][0].double().cpu().tolist(),
              f"diff-IK {name}: Robot.diff_ik differs from lane 0")
        print(f"diff-IK {name}: the first {b_small} and the first {h} lanes "
              f"solved alone are bitwise equal to those lanes of B={b_big}; "
              f"Robot.diff_ik (B=1) equals lane 0", flush=True)
        gauge_out[name] = outs

    # 14a. Rescue on the same batches: lanes that were ok are kept bitwise,
    # the failed ones are re-solved by the ADMM path at their true count.
    for name, (v_we, v_max) in commands.items():
        for b in (b_small, b_big):
            args = (x0[:b], v_we[:b], v_max[:b])
            a0, v0, ok0 = gauge_out[name][b]
            t0 = time.perf_counter()
            a1, v1, ok1 = robot.diff_ik_batch(*args, rescue=True)
            torch.cuda.synchronize()
            rescue_ms = 1e3 * (time.perf_counter() - t0)
            check(bool(ok1[ok0].all()) and torch.equal(a1[ok0], a0[ok0])
                  and torch.equal(v1[ok0], v0[ok0]),
                  f"rescue {name} @B={b}: a lane that was ok changed")
            rate, res = check_diffik_contracts(
                (a1, v1, ok1), args[1], args[2], jw64[:b],
                f"rescue {name} @B={b}")
            n_bad = int((~ok0).sum())
            print(f"rescue {name} @B={b}: {n_bad} lanes failed the gauge, "
                  f"{int((~ok1).sum())} stay failed after the ADMM re-solve "
                  f"(ok rate {float(ok0.float().mean()):.6f} -> {rate:.6f}), "
                  f"ok lanes bitwise kept, tracking <= {res:.3g}; the call "
                  f"took {rescue_ms:.1f} ms", flush=True)
            paths.append({"name": "diff_ik_batch rescue", "commands": name,
                          "B": b, "failed_lanes": n_bad, "ms": rescue_ms,
                          "ok_rate": rate})
    del jw64, gauge_out

    # 14b. The planar chain: commands inside the reachable cone.
    def cone_problem(urdf, n, seed):
        bot = Robot.from_urdf_str(urdf, "l0", f"l{n}", device="cuda")
        bot64 = Robot(bot.spec, dtype=torch.float64, device="cuda")
        r = np.random.default_rng(seed)
        q = torch.tensor(r.uniform(*bot.joint_limits(), size=(B_ADMM, n)),
                         dtype=torch.float32, device="cuda")
        jw = world_jacobian(bot64, q.double())
        inside = torch.tensor(r.uniform(-0.2, 0.2, size=(B_ADMM, n, 1)),
                              device="cuda")
        v_cmd = (jw @ inside)[:, :, 0].float()
        return bot, q, v_cmd, torch.ones_like(q), jw

    bot, q, v_cmd, vm, jw = cone_problem(planar_urdf(), 6, seed=0)
    _, _, ok0 = bot.diff_ik_batch(q, v_cmd, vm, rescue=False)
    check(not bool(ok0.all()), "planar chain: the gauge certified a "
          "rank-deficient Jacobian")
    out = bot.diff_ik_batch(q, v_cmd, vm)
    rate, res = check_diffik_contracts(out, v_cmd, vm, jw, "planar rescue",
                                       track_tol=5e-4)
    check(rate == 1.0 and float(out[0].min()) >= 1 - 1e-3,
          f"planar rescue: ok rate {rate}, least alpha {float(out[0].min())}")
    planar_s = timed(lambda: bot.diff_ik_batch(q, v_cmd, vm), 3)
    print(f"planar 6-joint chain @B={B_ADMM}: rescue=False rejects "
          f"{int((~ok0).sum())} lanes, rescue=True accepts all, alpha >= "
          f"{float(out[0].min()):.6f}, tracking <= {res:.3g} (limit 5e-4); "
          f"{planar_s * 1e3:.1f} ms per call (gauge, then ADMM on the "
          f"rejected lanes; median of 3)", flush=True)

    # 14c. Four joints route to the ADMM path.
    bot4, q, v_cmd, vm, jw = cone_problem(chain_urdf(4), 4, seed=1)
    check(bot4._diffik_solver() is None, "a 4-joint chain did not route to "
          "the ADMM path")
    out = bot4.diff_ik_batch(q, v_cmd, vm)
    direct = diffik.diff_ik_admm_batch(bot4.params, q, v_cmd, vm)
    check(all(torch.equal(a, c) for a, c in zip(out, direct)),
          "the 4-joint facade result differs from diff_ik_admm_batch")
    rate, res = check_diffik_contracts(out, v_cmd, vm, jw, "4-joint ADMM",
                                       track_tol=2e-5)
    check(rate >= 0.9, f"4-joint ADMM: ok rate {rate} on reachable commands")
    admm_s = timed(lambda: diffik.diff_ik_admm_batch(bot4.params, q, v_cmd,
                                                     vm), 3)
    admm_prof = profile_split(
        lambda: diffik.diff_ik_admm_batch(bot4.params, q, v_cmd, vm), 1)
    admm_launches = None if admm_prof is None else admm_prof["launches"]
    print(f"4-joint chain @B={B_ADMM} through diff_ik_admm_batch: ok rate "
          f"{rate:.4f}, alpha >= {float(out[0][out[2]].min()):.6f}, tracking "
          f"<= {res:.3g} (limit 2e-5); ADMM {admm_s * 1e3:.1f} ms per "
          f"lane-batch (median of 3), launches per call "
          + ("not measured" if admm_launches is None
             else f"{admm_launches}"), flush=True)
    paths.append({"name": "diff_ik_admm_batch", "B": B_ADMM, "joints": 4,
                  "ms": admm_s * 1e3, "launches_per_call": admm_launches,
                  "ok_rate": rate, "planar_rescue_ms": planar_s * 1e3})

    # 14d. An exact tie: two identical generators give pairs of subsets with
    # the same normal and the same cut.  The first minimal row must win on
    # the card as it does on the CPU; t must not depend on the choice.  A
    # subset holding both copies is degenerate (its "normal" is a rounding
    # direction, a valid cut but no facet), so the comparison keeps the
    # lanes whose boundary point is consistent on both devices.
    tie = torch.tensor([[3.0, 1.0, 1.0, 2.0], [1.0, 1.0, 1.0, 2.0],
                        [1.0, 5.0, 1.0, 2.0]], device="cuda")
    check(torch.argmin(tie, dim=0).tolist() == [1, 0, 0, 0]
          and torch.argmin(tie.cpu(), dim=0).tolist() == [1, 0, 0, 0],
          "argmin does not return the first minimal row")
    r = np.random.default_rng(2)
    g = r.standard_normal((7, 6, 256)).astype(np.float32)
    g[1] = g[0]
    vdir = r.standard_normal((6, 256)).astype(np.float32)
    tie_out = {}
    for dev in ("cuda", "cpu"):
        gens = [[torch.tensor(g[i, k], device=dev) for k in range(6)]
                for i in range(7)]
        vv = [torch.tensor(vdir[k], device=dev) for k in range(6)]
        t, u = gauge.gauge_solve(gens, vv)
        check(t.dtype == torch.float32 and bool(torch.isfinite(t).all()),
              f"tie input on {dev}: t is not finite f32")
        miss = torch.stack([sum(u[i] * gens[i][k] for i in range(7))
                            - t * vv[k] for k in range(6)]).abs().amax(dim=0)
        tie_out[dev] = (t.cpu(), torch.stack(u).cpu(), miss.cpu() <= 1e-3)
    (t_g, u_g, good_g), (t_c, u_c, good_c) = tie_out["cuda"], tie_out["cpu"]
    good = good_g & good_c
    check(int(good.sum()) >= 32, f"tie input: only {int(good.sum())} lanes "
          "have a consistent boundary point on both devices")
    d_t = float(((t_g - t_c).abs() / t_c)[good].max())
    d_u = float((u_g - u_c)[:, good].abs().max())
    check(d_t <= 1e-4 and d_u <= 1e-3, f"tie input: the card differs from "
          f"the CPU by {d_t} relative in t, {d_u} in u")
    print(f"argmin tie (two identical generators, 256 lanes, "
          f"{int(good.sum())} with a consistent boundary point on both "
          f"devices): the first minimal row wins on the card and on the "
          f"CPU; there t agrees within {d_t:.3g} relative (limit 1e-4) and "
          f"u within {d_u:.3g} (limit 1e-3)", flush=True)
    return paths


def percentiles_us(seconds):
    """(p50, p90) of per-call host seconds, in microseconds."""
    import numpy as np

    return tuple(float(v) for v in 1e6 * np.percentile(seconds, [50, 90]))


def native_phases(robot, cfg):
    """Phase 16: the native latency path (optik_tpu_torch.native) beside the
    card's scalar path, the success-parity harnesses' engine and native
    columns, then the C++ example on the host.  Returns the entries of the
    ``paths`` line and the LM kernel's launches per part."""
    import numpy as np
    import torch

    from optik_tpu_torch.benchmarks import parity_hard, parity_native
    from optik_tpu_torch.benchmarks.timing import host_cpu
    from optik_tpu_torch.models import asset_path
    from optik_tpu_torch.native import HostChain
    from optik_tpu_torch.native import host as native_host
    from optik_tpu_torch.ops.cuda import lm_kernel

    t_phase = time.perf_counter()
    cpu = host_cpu()
    paths, launches = [], {}
    chain = HostChain.from_urdf_file(asset_path(parity_native.PANDA[0]),
                                     *parity_native.PANDA[1:])
    lo, hi = robot.joint_limits()

    # 16a. The native binding's FK and Jacobian (f64, host) against the
    # card's SoA path (f32), then single-solve latency on both.
    rng = np.random.default_rng(16)
    q = rng.uniform(lo, hi, size=(N_NATIVE_KIN, 7))
    r, t = robot.fk_batch(q)
    jac = robot.jacobian_batch(q)
    fk_n = np.stack([chain.fk(v) for v in q])
    jac_n = np.stack([chain.jacobian(v) for v in q])
    fk_err = max(float(np.abs(r.double().cpu().numpy() - fk_n[:, :3, :3]).max()),
                 float(np.abs(t.double().cpu().numpy() - fk_n[:, :3, 3]).max()))
    jac_err = float(np.abs(jac.double().cpu().numpy() - jac_n).max())
    check(fk_err <= NATIVE_TOL and jac_err <= NATIVE_TOL,
          f"native FK / Jacobian differ from the card's by {fk_err} / "
          f"{jac_err} (limit {NATIVE_TOL})")

    rng = np.random.default_rng(7)  # the JAX package's latency script's seed
    targets = [chain.fk(rng.uniform(lo, hi)) for _ in range(N_LATENCY)]
    seeds = [rng.uniform(lo, hi) for _ in range(N_LATENCY)]
    budget = dict(tol_f=cfg.tol_f, max_iters=cfg.max_iters,
                  max_restarts=cfg.total_restarts)
    chain.ik(targets[0], seeds[0], **budget)
    robot.ik(cfg, targets[0], seeds[0])  # warm: plan, table upload
    lat = {"native": [], "card": []}
    ok = {"native": 0, "card": 0}
    lm_kernel.LAUNCHES = 0
    for tgt, x0 in zip(targets, seeds):
        for side in ("native", "card"):
            t0 = time.perf_counter()
            out = chain.ik(tgt, x0, **budget) if side == "native" \
                else robot.ik(cfg, tgt, x0)
            lat[side].append(time.perf_counter() - t0)
            if out is not None:
                ok[side] += 1
                x = np.asarray(out[0], np.float64)
                err = float(np.abs(chain.fk(x) - tgt).max())
                check(out[1] <= cfg.tol_f and err <= FK_TOL,
                      f"scalar {side} IK: a found solution misses its target "
                      f"(cost {out[1]}, FK err {err})")
    launches["scalar Robot.ik"] = lm_kernel.LAUNCHES
    check(launches["scalar Robot.ik"] == N_LATENCY,
          f"scalar Robot.ik launched the kernel {lm_kernel.LAUNCHES} times "
          f"in {N_LATENCY} solves")
    p_nat, p_card = percentiles_us(lat["native"]), percentiles_us(lat["card"])
    print(f"native binding vs the card @{N_NATIVE_KIN} configurations: FK "
          f"within {fk_err:.3g}, Jacobian within {jac_err:.3g} (limit "
          f"{NATIVE_TOL}); single-solve latency over {N_LATENCY} reachable "
          f"poses (the main config): HostChain.ik p50 {p_nat[0]:.1f} "
          f"/ p90 {p_nat[1]:.1f} us ({ok['native']} found; host CPU {cpu}), "
          f"scalar Robot.ik on the card p50 {p_card[0]:.1f} / p90 "
          f"{p_card[1]:.1f} us ({ok['card']} found, one launch each)",
          flush=True)
    paths.append({"name": "native latency", "poses": N_LATENCY,
                  "host_cpu": cpu,
                  "native_p50_us": p_nat[0], "native_p90_us": p_nat[1],
                  "native_found": ok["native"],
                  "card_scalar_p50_us": p_card[0],
                  "card_scalar_p90_us": p_card[1],
                  "card_scalar_found": ok["card"],
                  "fk_err": fk_err, "jacobian_err": jac_err})

    # 16b. parity_native at its full size.
    lm_kernel.LAUNCHES = 0
    summary, batches = parity_native.run(robot, chain, N_PARITY_NATIVE)
    launches["parity_native"] = lm_kernel.LAUNCHES
    check(launches["parity_native"] == len(batches),
          f"parity_native launched the kernel {lm_kernel.LAUNCHES} times in "
          f"{len(batches)} batches")
    for b in batches:
        check_solutions(robot, b.res, b.tgt_r, b.tgt_t, cfg.tol_f,
                        "parity_native kernel column")
    check(summary["kernel_success_rate"] >= 0.999,
          f"parity_native kernel success {summary['kernel_success_rate']}")
    print("parity_native @" + f"{N_PARITY_NATIVE} poses: kernel success "
          f"{summary['kernel_success_rate']:.6f}, native "
          f"{summary['native_success_rate']:.6f}; both fail "
          f"{summary['both_fail']}, kernel only {summary['kernel_only_fail']}"
          f", native only {summary['native_only_fail']}; wall: kernel "
          f"{summary['kernel_wall_s']:.2f} s, native "
          f"{summary['native_wall_s']:.2f} s", flush=True)
    paths.append({"name": "parity_native", **summary,
                  "launches": launches["parity_native"]})

    # 16c. parity_hard's engine and native columns (the SLSQP column is
    # CPU time and stays off the card's run).
    cells = []
    lm_kernel.LAUNCHES = 0
    for line, results, (tgt_r, tgt_t, _), hrobot in parity_hard.run(
            robot.device, N_HARD, scipy_column=False):
        tr = torch.tensor(tgt_r, dtype=hrobot.dtype, device=hrobot.device)
        tt = torch.tensor(tgt_t, dtype=hrobot.dtype, device=hrobot.device)
        for col, res in results.items():
            check_solutions(hrobot, res, tr, tt, cfg.tol_f,
                            f"parity_hard {line['set']} {line['budget']} "
                            f"{col}")
        cells.append(line)
        at32 = line["engine_success_iters32"]
        print(f"parity_hard {line['set']} {line['budget']} @{N_HARD}: "
              f"engine {line['engine_success']:.4f}"
              + ("" if at32 is None else f" (@32 iterations {at32:.4f})")
              + f", native {line['native_success']:.4f}; both fail "
              f"{line['both_fail_engine_native']}, engine only "
              f"{line['engine_only_fail_vs_native']}, native only "
              f"{line['native_only_fail_vs_engine']}; wall engine "
              f"{line['engine_wall_s']:.2f} s, native "
              f"{line['native_wall_s']:.2f} s", flush=True)
    launches["parity_hard"] = lm_kernel.LAUNCHES
    check(len(cells) == 6 and launches["parity_hard"] == 9,
          f"parity_hard ran {len(cells)} cells in {lm_kernel.LAUNCHES} "
          "launches, expected 6 in 9")
    strong = next(c for c in cells if c["set"] == "panda_uniform"
                  and c["budget"] == "strong")
    check(strong["engine_success"] >= 0.99, f"parity_hard panda_uniform "
          f"strong engine success {strong['engine_success']} < 0.99")

    # 16d. The C++ example on the host.
    exe = native_host.build_example()
    panda = asset_path("panda.urdf")
    t0 = time.perf_counter()
    ex = subprocess.run([str(exe), str(panda), "panda_link0",
                         "panda_hand_tcp"], capture_output=True, text=True,
                        timeout=600)
    check(ex.returncode == 0, f"example_cpp exited {ex.returncode}: "
          f"{ex.stderr}")
    lines = ex.stdout.strip().splitlines()[-2:]
    check(lines[0].startswith("Successes: ")
          and lines[1].startswith("Average time per solve: "),
          f"example_cpp printed {lines}")
    print(f"example_cpp ({time.perf_counter() - t0:.1f} s, host CPU "
          f"{cpu}): {lines[0]} / {lines[1]}", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 16 took {phase_s:.1f} s", flush=True)
    paths.append({"name": "parity_hard", "poses": N_HARD, "cells": cells,
                  "launches": launches["parity_hard"], "phase_s": phase_s})
    paths.append({"name": "example_cpp", "lines": lines, "host_cpu": cpu})
    return paths, launches


def sharded_rank(cases, spec, timed_cases):
    """One rank of phases 15b-d, in a process of its own (launch.spawn).

    Drives ``cases`` through launch.solve with the launch counter set to 0
    just before and read just after.  Then, for each timed case (name,
    config, data, seed, inputs), this rank's slice of the seed-sharded
    solve: its kernel alone on the card (the ranks take turns, so each
    time is what the rank's own card would take) with its schedule probe,
    and the merge, timed with every rank of the mesh in it."""
    import torch
    import torch.distributed as dist

    from optik_tpu_torch.benchmarks.timing import event_ms
    from optik_tpu_torch.config import SolutionMode
    from optik_tpu_torch.ops.cuda import lm_kernel
    from optik_tpu_torch.parallel import distributed, launch
    from optik_tpu_torch.parallel import mesh as mesh_mod
    from optik_tpu_torch.solver import ik as ik_mod

    lm_kernel.LAUNCHES = 0
    results = launch.solve(cases, spec)
    launches = lm_kernel.LAUNCHES
    rank, world = dist.get_rank(), dist.get_world_size()
    device = distributed.local_device()
    timings = []
    for name, cfg, data, seed, inputs in timed_cases:
        mesh = mesh_mod.make_mesh(range(data * seed), data=data, seed=seed)
        entry = {"name": name, "rank": rank, "coord": mesh.coord}
        if mesh.coord is not None:
            r_sub = cfg.total_restarts // seed
            plan = lm_kernel.KernelPlan(spec,
                                        cfg.replace(max_restarts=r_sub))
            tr, tt, x0 = (torch.as_tensor(v, device=device) for v in inputs)
            rows, d = mesh.shard(tr.shape[0]), mesh.index("seed")
            part = (plan, tr[rows], tt[rows], x0[rows])
            off = d * r_sub

            def one_launch():
                return lm_kernel.solve_kernel(*part, restart_offset=off,
                                              lane0_stream=d > 0)

            res = lm_kernel.select(plan, one_launch(), x0[rows])
            key = res.sel_key
            if cfg.solution_mode == SolutionMode.SPEED:
                key = torch.where(res.found, key.to(torch.int64) + off,
                                  ik_mod.INT32_MAX)
        for turn in range(world):
            if turn == rank and mesh.coord is not None:
                entry["kernel_ms"] = event_ms(one_launch, 3)
                entry["schedule"] = lm_kernel.schedule_profile(one_launch())
            dist.barrier()
        if mesh.coord is not None:
            merge_ms = []
            for _ in range(3):
                dist.barrier(group=mesh.groups["mesh"])
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                mesh.merge(res, key)
                torch.cuda.synchronize(device)
                merge_ms.append(1e3 * (time.perf_counter() - t0))
            entry["merge_ms"] = sorted(merge_ms)[1]
        timings.append(entry)
    return {"results": results, "launches": launches, "timings": timings}


def same_results(a, b, fields=("found", "x", "cost", "iters")):
    import torch

    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in fields)


def check_found_winners(got, ref, what, x0=None):
    """found bitwise equal to ``ref``'s; x and cost bitwise on found poses;
    not-found poses carry (x0, +inf) where ``x0`` is given."""
    import torch

    got_f, ref_f = got.found.cpu(), ref.found.cpu()
    check(torch.equal(got_f, ref_f), f"{what}: found mask differs from the "
          f"single-device solve on {int((got_f != ref_f).sum())} poses")
    gx, rx = got.x.cpu()[ref_f], ref.x.cpu()[ref_f]
    bad = (gx != rx).any(dim=1) | (got.cost.cpu()[ref_f]
                                   != ref.cost.cpu()[ref_f])
    check(not bool(bad.any()), f"{what}: x or cost differs from the "
          f"single-device solve on {int(bad.sum())} found poses, by up to "
          f"{float((gx - rx).abs().max()):.3g}")
    if x0 is not None:
        check(torch.equal(got.x.cpu()[~ref_f], x0.cpu()[~ref_f])
              and bool(torch.isinf(got.cost.cpu()[~ref_f]).all()),
              f"{what}: a not-found pose does not carry (x0, +inf)")


def sharded_phases(robot, cfg, qcfg, main_in, q_in, main_ref, q_ref):
    """Phase 15: the multi-device paths (optik_tpu_torch.parallel).
    Returns the entries of the ``paths`` line and the launches per path."""
    import torch

    from optik_tpu_torch.ops.cuda import lm_kernel
    from optik_tpu_torch.parallel import distributed, launch
    from optik_tpu_torch.parallel import mesh as mesh_mod
    from optik_tpu_torch.solver import ik as ik_mod

    paths, launches = [], {}
    t_phase = time.perf_counter()

    # 15a. A real NCCL group of one rank, here: the seed-sharded solve and
    # the sharded single-shot path on a (1, 1) mesh are Robot.ik_batch bit
    # for bit; their cost over it is the merge and the assembly.
    distributed.initialize(f"tcp://localhost:{launch.free_port()}", 1, 0,
                           backend="nccl", timeout=300)
    try:
        mesh = mesh_mod.make_mesh(data=1, seed=1)
        for label, c, (a_tr, a_tt, a_x0), ref, b in (
                ("Speed", cfg, main_in, main_ref, B_MAIN),
                ("Quality", qcfg, q_in, q_ref, B_QUALITY)):
            seeded_fn = mesh_mod.build_seed_sharded_solver(robot, c, mesh)
            casc_fn = mesh_mod.build_sharded_cascade(robot, c, mesh)
            fns = {
                "ik_batch": lambda: robot.ik_batch(
                    c, a_tr, a_tt, a_x0, validate_seeds=False,
                    rescue_overflow=False),
                "seed_sharded": lambda: seeded_fn(a_tr, a_tt, a_x0),
                "sharded_cascade": lambda: casc_fn(a_tr, a_tt, a_x0)}
            for name in ("seed_sharded", "sharded_cascade"):
                fns[name]()  # warm: plan, the group's communicator
                lm_kernel.LAUNCHES = 0
                out = fns[name]()
                torch.cuda.synchronize()
                n = lm_kernel.LAUNCHES
                check(n == 1, f"NCCL {label} {name} launched the kernel {n} "
                      "times in one solve")
                launches[f"nccl (1, 1) {label} {name}"] = n
                check_found_winners(out, ref, f"NCCL (1, 1) {label} {name}",
                                    a_x0 if name == "seed_sharded" else None)
                if name == "sharded_cascade":
                    check(same_results(out, ref) and int(out.overflow_count)
                          == 0, f"NCCL (1, 1) {label} {name} differs from "
                          "Robot.ik_batch")
            # Solves/s in turns, then device time outside the LM kernel.
            per_s = {k: [] for k in fns}
            for _ in range(2):
                for k, fn in fns.items():
                    per_s[k].append(b / timed(fn, 5))
            other_ms = {}
            for k, fn in fns.items():
                split = profile_split(fn, 3)
                other_ms[k] = None if split is None else sum(
                    v for n, v in split["kernels"].items()
                    if "lm_solve" not in n) / 3
            merge_ms = None if None in other_ms.values() else \
                other_ms["seed_sharded"] - other_ms["ik_batch"]
            print(f"NCCL world of 1, (1, 1) mesh, {label} @B={b}: "
                  "build_seed_sharded_solver and build_sharded_cascade "
                  "bitwise equal to Robot.ik_batch (found; x and cost of "
                  "found poses; the cascade in every field); solves/s "
                  "(median of 5, two turns): " + "; ".join(
                      f"{k} " + " / ".join(f"{v:.0f}" for v in vs)
                      for k, vs in per_s.items())
                  + "; device ms per call outside the LM kernel "
                  "(profiler): " + ", ".join(
                      f"{k} " + ("not measured" if v is None
                                 else f"{v:.4f}")
                      for k, v in other_ms.items())
                  + "; the merge: " + ("not measured" if merge_ms is None
                                       else f"{merge_ms:.4f} ms")
                  + f" ({time.perf_counter() - t_phase:.1f} s into phase 15)",
                  flush=True)
            paths.append({"name": "nccl (1, 1)", "mode": label, "B": b,
                          "solves_per_s": per_s,
                          "device_ms_outside_kernel": other_ms,
                          "merge_device_ms": merge_ms})
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()

    # 15b-d. Gloo ranks sharing the card: seed-sharded at (1, 2) and
    # (2, 2), the sharded single-shot path at (2, 1), ik_sharded at (1, 2).
    def host(t3):
        return tuple(t.cpu() for t in t3)

    big, qbig = host(main_in), host(q_in)
    lock = tuple(t[:B_LOCKSTEP] for t in big)
    cases, timed_cases = [], []
    for label, c, inputs in (("Speed", cfg, big), ("Quality", qcfg, qbig)):
        for shape in ((1, 2), (2, 2)):
            cases.append(launch.Case("seed_sharded", c, *shape, inputs,
                                     repeat=2))
            timed_cases.append((f"{label} {shape}", c, *shape, inputs))
    cases.append(launch.Case("cascade", cfg, 2, 1, big))
    cases.append(launch.Case("ik_sharded", cfg, 1, 2, lock))
    t0 = time.perf_counter()
    ranks = launch.spawn(sharded_rank, SHARD_WORLD, cases, robot.spec,
                         timed_cases, timeout=600)
    spawn_s = time.perf_counter() - t0
    for k, case in enumerate(cases):
        outs = [r["results"][k] for r in ranks if r["results"][k] is not None]
        check(all(isinstance(o, list) for o in outs),
              f"gloo case {k} failed: {outs[0]}")
        check(all(same_results(a, b) for o in outs for a, b in zip(outs[0], o)),
              f"gloo case {k}: the ranks' results differ")
        check(all(same_results(outs[0][0], a) for a in outs[0][1:]),
              f"gloo case {k}: a repeat is not bitwise equal")
    want = [9, 9, 4, 4]  # one launch per seed-sharded or cascade solve
    got_launch = [r["launches"] for r in ranks]
    check(got_launch == want, f"gloo ranks launched the kernel {got_launch} "
          f"times, expected {want}")
    launches["gloo ranks (seed-sharded and cascade)"] = got_launch
    k = 0
    for label, ref, x0_ in (("Speed", main_ref, main_in[2]),
                            ("Quality", q_ref, q_in[2])):
        for shape in ((1, 2), (2, 2)):
            got = ranks[0]["results"][k][0]
            what = f"gloo {shape} seed-sharded {label}"
            if label == "Quality":
                check_found_winners(got, ref, what, x0_)
            else:
                check(torch.equal(got.found, ref.found.cpu()),
                      f"{what}: found mask differs from the single-device "
                      "solve")
                moved = got._replace(x=got.x.cuda(), cost=got.cost.cuda(),
                                     found=got.found.cuda())
                check_solutions(robot, moved, main_in[0], main_in[1],
                                cfg.tol_f, what)
            k += 1
    casc = ranks[0]["results"][k][0]
    check(same_results(casc, main_ref),
          "gloo (2, 1) sharded single-shot path differs from Robot.ik_batch "
          "on the whole batch")
    lock_out = ranks[0]["results"][k + 1][0]
    ref_lock = ik_mod.build_batch_solver(robot.spec, cfg, torch.float32,
                                         device="cuda")(
        *(t.cuda() for t in lock))
    check(same_results(lock_out, ref_lock)
          and int(lock_out.lane_iters) == int(ref_lock.lane_iters),
          "gloo (1, 2) ik_sharded differs from the unsharded plain loop")
    for entry in (e for r in ranks for e in r["timings"]):
        if "kernel_ms" not in entry:
            continue
        sched = entry["schedule"]
        print(f"gloo {entry['name']} rank {entry['rank']} {entry['coord']}: "
              f"kernel alone {entry['kernel_ms']:.3f} ms (CUDA events, "
              f"ranks in turns), span {sched['span_ms']:.3f} ms, tail after "
              f"the last draw {sched['tail_ms']:.3f} ms = "
              f"{100 * sched['tail_share']:.1f}%, "
              f"{sched['lane_iters_per_solve']:.1f} lane-iterations per "
              f"solve; merge {entry['merge_ms']:.3f} ms (host clock, every "
              f"rank of the mesh in it)", flush=True)
    print(f"gloo world of {SHARD_WORLD} ranks on the one card ({spawn_s:.1f} "
          f"s with start-up): seed-sharded (1, 2) and (2, 2) found masks "
          f"bitwise the single-device ones, Quality x and cost bitwise, Speed "
          f"winners within tol_f and FK {FK_TOL}, repeats bitwise, the ranks "
          f"agree; (2, 1) sharded single-shot path bitwise Robot.ik_batch; "
          f"(1, 2) ik_sharded @B={B_LOCKSTEP} bitwise the unsharded plain "
          f"loop, lane_iters {int(lock_out.lane_iters)}; kernel launches per "
          f"rank {got_launch}; phase 15 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    paths.append({"name": "gloo ranks on one card", "world": SHARD_WORLD,
                  "spawn_s": spawn_s, "timings": [
                      e for r in ranks for e in r["timings"]
                      if "kernel_ms" in e]})
    return paths, launches


def wide_robots(Robot):
    """The chains of phase 18, keyed by DoF: the 11-joint mobile Panda, a
    16-joint arm and the widest chain folded into a library, then the
    run-time chain's arms (RUNTIME_MAIN_DOF and RUNTIME_NO_CAP_DOF)."""
    from optik_tpu_torch.models.synthetic import chain_urdf, mobile_panda_urdf
    from optik_tpu_torch.ops.cuda import lm_kernel

    out = {11: Robot.from_urdf_str(mobile_panda_urdf(), "mobile_base",
                                   "panda_hand_tcp", device="cuda")}
    for a in (16, lm_kernel.MAX_DOF, *RUNTIME_MAIN_DOF, RUNTIME_NO_CAP_DOF):
        out[a] = Robot.from_urdf_str(chain_urdf(a), "l0", f"l{a}",
                                     device="cuda")
    return out


def wide_variants(robots, cfg, qcfg):
    """The LM libraries phase 18 launches, for phase 2's pool, the widest
    folded chain first (its nvcc takes longest), then the run-time chain's
    (one library per variant for every chain): {name: (header, quality,
    weighted, wide, fmad)}."""
    from optik_tpu_torch.ops.cuda import lm_kernel

    out = {}
    for a in sorted(robots, reverse=True):
        if a > lm_kernel.MAX_DOF:
            continue
        header = lm_kernel.KernelPlan(robots[a].spec, cfg).header
        for fmad in (True, False):
            out[f"{a}-DoF speed{'' if fmad else ' uncontracted'}"] = (
                header, False, False, False, fmad)
        if a == 11:
            plan_q = lm_kernel.KernelPlan(robots[a].spec, qcfg)
            for fmad in (True, False):
                tag = "" if fmad else " uncontracted"
                out[f"11-DoF speed weighted{tag}"] = (header, False, True,
                                                     False, fmad)
                out[f"11-DoF quality{tag}"] = (header, True, False,
                                              plan_q.wide(False), fmad)
    plan_q = lm_kernel.KernelPlan(robots[RUNTIME_MAIN_DOF[0]].spec, qcfg)
    for fmad in (True, False):
        tag = "" if fmad else " uncontracted"
        out[f"runtime speed{tag}"] = (None, False, False, False, fmad)
        out[f"runtime speed weighted{tag}"] = (None, False, True, False, fmad)
        out[f"runtime quality{tag}"] = (None, True, False, plan_q.wide(False),
                                        fmad)
    return out


def op_count(spec, config):
    """lm_kernel.fp32_ops_per_lane_iter of one chain under the main config
    (run in a spawned process while the card works: tracing a wide chain
    at 64 points takes seconds of host time)."""
    from optik_tpu_torch import SolverConfig
    from optik_tpu_torch.ops.cuda import lm_kernel

    return lm_kernel.fp32_ops_per_lane_iter(
        lm_kernel.KernelPlan(spec, SolverConfig(**config)))


def count_plain_loops():
    """Count the plain loop's runs from here on (every route to it calls
    lm_soa.solve_soa): returns a function that reads the count and
    restores the loop."""
    from optik_tpu_torch.solver import lm_soa

    orig, calls = lm_soa.solve_soa, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    lm_soa.solve_soa = counted

    def done():
        lm_soa.solve_soa = orig
        return calls[0]

    return done


def dof_line(a, row):
    """Print one chain's row of phase 18's per-DoF table."""
    form = ""
    if "scratch_bytes_per_lane" in row:
        form = (f" run-time chain, {row['scratch_bytes_per_lane']} B of "
                f"scratch per lane,")
    print(f"  {a} DoF @B={row['B']}:{form} {row['registers']} registers, "
          f"{row['spill_bytes']} B spilled ({row['stack']} B stack), "
          f"{row['warps_per_sm']} warps per SM, nvcc {row['nvcc_s']:.1f} s; "
          f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.1f} ms; "
          f"{row['lane_iters_per_solve']:.1f} lane-iterations per solve x "
          f"{row['fp32_ops_needed']} FP32 operations: bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({100 * row['bound_ms'] / row['ms']:.1f}% of the kernel's time)",
          flush=True)


def wide_phases(panda, robots, cfg, qcfg, panda_row, ops_jobs):
    """Phase 18: chains wider than the Panda, and float64 on the card.

    (a) the main path on the mobile Panda, Robot.from_urdf_str -> fk_batch
    -> ik_batch in Speed at B = 131,072 with the main config: one launch per
    solve, success, every found cost <= tol_f, FK of every found x within
    2e-3; the kernel against its plain version there (uncontracted
    bitwise, contracted within phase 3's limits), both timed, and the
    lane-iterations the inputs need; (b) the mobile Panda's kernel against
    its plain version at B = 4,096 in Speed, Speed with weights and Quality
    (256, 64, 48): uncontracted bitwise, contracted within phase 3's limits,
    success within 0.001; (c) as (a)'s checks and times for 16 joints and
    the widest folded chain, where the per-lane state spills, at
    B = 131,072; after each of (a) and (c) the run-time-chain form on the
    same inputs, for the record, with the same checks; (e) the run-time
    chain's main path, 48 and 64 joints through ik_batch at B = 131,072 as
    in (a), the plain loop never run, then the kernel against its plain
    version there; (f) 48 joints at B = 4,096 in Speed with weights and in
    Quality (256, 64, 48) as in (b); (g) 128 joints through ik_batch at
    B = 4,096 as in (e), to show there is no cap; (d) a float64 Panda Robot
    through ik_batch on the card: no launch (the plain loop, by
    lm_kernel.kernel_runs), found masks within 0.1% of the host's f64 plain
    loop.  Per DoF (the Panda's row from phases 2 and 5) registers, spills,
    resident warps, nvcc seconds, kernel and plain ms, lane-iterations per
    solve and the bound; the run-time chain's rows add the scratch bytes
    per lane and the library file, one for every chain.  ``panda`` is phase
    6's Robot; ``ops_jobs`` the futures of the run-time arms' operation
    counts.  Returns (paths, the lm_solve entry's "wide" object, whose
    "launches" are (a)'s, and the lm_solve_runtime_chain entry's fields,
    whose "launches" are (e)'s)."""
    import torch

    from optik_tpu_torch import Robot
    from optik_tpu_torch.benchmarks.timing import event_ms
    from optik_tpu_torch.ops.cuda import lm_kernel

    t_phase = time.perf_counter()
    mobile = robots[11]
    rows = {"7": panda_row}
    rt_rows = {}
    print("phase 18, per DoF (7: the Panda of phases 2 and 5):", flush=True)
    dof_line(7, panda_row)

    def dof_row(a, plan, b, tr, tt, x0, lanes_p, plain_ms, ops=None):
        """The kernel's row of one chain in the plan's form: its Speed
        library's report, the solver build's time and the bound of the
        work these inputs need."""
        lib = plan.library(plan.freeze)
        rep = lm_kernel.library_report(*lib)
        ms = event_ms(lambda: lm_kernel.solve_kernel(plan, tr, tt, x0), 5)
        needed = int(lanes_p.active_iters.sum())
        if ops is None:
            ops = lm_kernel.fp32_ops_per_lane_iter(plan)
        b_ms, b_by = bound(ops * needed, lm_bytes(a, b, plan.s, plan.r_total))
        row = {"B": b, "registers": rep["registers"],
               "spill_bytes": rep["spill_bytes"], "stack": rep["stack"],
               "warps_per_sm": rep["warps_per_sm"], "nvcc_s": rep["nvcc_s"],
               "ms": ms, "plain_ms": plain_ms,
               "lane_iters_per_solve": needed / b, "fp32_ops_needed": ops,
               "bound_ms": b_ms, "bound_by": b_by}
        if plan.runtime_chain:
            row.update(scratch_bytes_per_lane=lm_kernel.lane_scratch_bytes(
                plan, lib[0]), library=rep["path"])
            rt_rows[str(a)] = row
        else:
            rows[str(a)] = row
        dof_line(a, row)
        return row

    def plain(plan, tr, tt, x0):
        out = []
        ms = 1e3 * timed(lambda: out.append(lm_kernel.solve_plain(
            plan, tr, tt, x0, track_active=True)), 1)
        return out[0], ms

    def full_width_checks(robot, plan, tr, tt, x0, lanes_p, what):
        """Phase 5's checks of one chain's Speed kernel: the uncontracted
        build bitwise, the solver's build within phase 3's limits; returns
        the pose difference on shared winners."""
        b = x0.shape[0]
        lanes_equal(lm_kernel.solve_kernel(plan, tr, tt, x0, fmad=False),
                    lanes_p, f"{what} @B={b}")
        print(f"{what}: uncontracted kernel vs plain @B={b}: every "
              "lane's x, f, success, restart index and iterations bitwise "
              "equal", flush=True)
        _, err = compare_contracted(robot, lm_kernel, plan, tr, tt, x0,
                                    lanes_p, what)
        return err

    def runtime_record(a, robot, tr, tt, x0, lanes_p, plain_ms, ops):
        """The run-time-chain form on a folded row's inputs, for the
        record: the same checks, its time and its bound."""
        plan = lm_kernel.KernelPlan(robot.spec, cfg, runtime_chain=True)
        err = full_width_checks(robot, plan, tr, tt, x0, lanes_p,
                                f"{a} DoF run-time chain")
        dof_row(a, plan, x0.shape[0], tr, tt, x0, lanes_p, plain_ms,
                ops)["pose_err"] = err
        return err

    # (a) The main path on the mobile Panda, through the entry points.
    tr, tt, x0 = problem(mobile, B_MAIN, seed=18)

    def solve():
        return mobile.ik_batch(cfg, tr, tt, x0, validate_seeds=False,
                               rescue_overflow=False)

    solve()  # warm: solver build and seed-table upload
    lm_kernel.LAUNCHES = 0
    runs, results = 5, []
    main_s = timed(lambda: results.append(solve()), runs)
    launches = lm_kernel.LAUNCHES
    check(launches == runs, f"the mobile Panda's main path launched the "
          f"kernel {launches} times in {runs} solves")
    res = results[-1]
    success = float(res.found.float().mean())
    check(success >= 0.99, f"mobile Panda main-path success {success} < 0.99")
    fk_err = check_solutions(mobile, res, tr, tt, cfg.tol_f,
                             "mobile Panda main path")
    print(f"mobile Panda (11 DoF) main path @B={B_MAIN}: success "
          f"{success:.6f}, {B_MAIN / main_s:.0f} solves/s (median of {runs}, "
          f"{main_s * 1e3:.2f} ms/batch), "
          f"{int(res.lane_iters) / B_MAIN:.1f} lane-iters/solve run, FK err "
          f"{fk_err:.3g}, launches {launches}", flush=True)
    plan = lm_kernel.KernelPlan(mobile.spec, cfg)
    lanes_p, plain_ms = plain(plan, tr, tt, x0)
    max_err = full_width_checks(mobile, plan, tr, tt, x0, lanes_p,
                                "mobile Panda main config")
    ops11 = dof_row(11, plan, B_MAIN, tr, tt, x0, lanes_p,
                    plain_ms)["fp32_ops_needed"]
    rt_err = runtime_record(11, mobile, tr, tt, x0, lanes_p, plain_ms, ops11)
    del lanes_p
    main_path = {"name": "mobile Panda 11-DoF ik_batch", "B": B_MAIN,
                 "config": MAIN, "launches": launches, "success": success,
                 "solves_per_s": B_MAIN / main_s, "fk_err": fk_err}

    # (b) Kernel against plain on the mobile Panda at B_CHECK.
    def option_checks(robot, seed, cases, what):
        """(b)'s checks at B_CHECK for each (name, config) of ``cases``:
        uncontracted bitwise, contracted within phase 3's limits, success
        within 0.001 of plain.  Returns ({name: result}, largest pose
        difference)."""
        wtr, wtt, wx0 = problem(robot, B_CHECK, seed=seed)
        out, worst = {}, 0.0
        for name, c in cases:
            cplan = lm_kernel.KernelPlan(robot.spec, c)
            lanes_p = lm_kernel.solve_plain(cplan, wtr, wtt, wx0)
            lanes_equal(lm_kernel.solve_kernel(cplan, wtr, wtt, wx0,
                                               fmad=False),
                        lanes_p, f"{what} {name}")
            k, err = compare_contracted(robot, lm_kernel, cplan, wtr, wtt,
                                        wx0, lanes_p, f"{what} {name}")
            p_rate = float(lm_kernel.select(cplan, lanes_p, wx0).found
                           .float().mean())
            k_rate = float(k.found.float().mean())
            check(abs(k_rate - p_rate) <= 1e-3, f"{what} {name}: kernel "
                  f"success {k_rate} against plain {p_rate}")
            worst = max(worst, err)
            out[name] = {"success": k_rate, "plain_success": p_rate,
                         "pose_err": err}
        print(f"{what} @B={B_CHECK}: " + ", ".join(out) + " uncontracted "
              "bitwise equal to plain in every lane, contracted within "
              "phase 3's limits, success within 0.001 of plain: "
              + ", ".join(f"{n} {v['success']:.6f} / {v['plain_success']:.6f}"
                          for n, v in out.items()), flush=True)
        return out, worst

    checks, err = option_checks(
        mobile, 19, (("Speed", cfg),
                     ("Speed weighted", cfg.replace(**WIDE_WEIGHTS)),
                     ("Quality (256, 64)", qcfg)), "mobile Panda")
    max_err = max(max_err, err)

    # (c) Where the per-lane state spills: 16 joints, and the widest folded
    # chain, at the main shape (a full card, as the mobile Panda's row);
    # the run-time chain on the same inputs.
    for a in (16, lm_kernel.MAX_DOF):
        robot = robots[a]
        ctr, ctt, cx0 = problem(robot, B_MAIN, seed=20 + a)
        cplan = lm_kernel.KernelPlan(robot.spec, cfg)
        lanes_p, c_plain_ms = plain(cplan, ctr, ctt, cx0)
        max_err = max(max_err, full_width_checks(
            robot, cplan, ctr, ctt, cx0, lanes_p, f"{a} DoF main config"))
        ops = dof_row(a, cplan, B_MAIN, ctr, ctt, cx0, lanes_p,
                      c_plain_ms)["fp32_ops_needed"]
        rt_err = max(rt_err, runtime_record(a, robot, ctr, ctt, cx0, lanes_p,
                                            c_plain_ms, ops))
        del lanes_p

    # (e) The run-time chain's main path, and (g) no cap.
    def runtime_main_path(a, b):
        """ik_batch on an a-joint arm: five timed solves, one launch each,
        no run of the plain loop; then the kernel against its plain
        version on the same inputs, and the row."""
        robot = robots[a]
        rtr, rtt, rx0 = problem(robot, b, seed=a)

        def solve():
            return robot.ik_batch(cfg, rtr, rtt, rx0, validate_seeds=False,
                                  rescue_overflow=False)

        solve()  # warm: solver build, chain and seed-table upload
        lm_kernel.LAUNCHES = 0
        plain_runs = count_plain_loops()
        results = []
        try:
            main_s = timed(lambda: results.append(solve()), runs)
        finally:
            n_plain = plain_runs()
        n_launch = lm_kernel.LAUNCHES
        check(n_launch == runs, f"the {a}-joint main path launched the "
              f"kernel {n_launch} times in {runs} solves")
        check(n_plain == 0, f"the {a}-joint main path ran the plain loop "
              f"{n_plain} times")
        res = results[-1]
        rate = float(res.found.float().mean())
        check(rate >= 0.99, f"{a}-joint main-path success {rate} < 0.99")
        fk = check_solutions(robot, res, rtr, rtt, cfg.tol_f,
                             f"{a}-joint main path")
        print(f"{a}-joint arm (run-time chain) main path @B={b}: success "
              f"{rate:.6f}, {b / main_s:.0f} solves/s (median of {runs}, "
              f"{main_s * 1e3:.2f} ms/batch), "
              f"{int(res.lane_iters) / b:.1f} lane-iters/solve run, FK err "
              f"{fk:.3g}, launches {n_launch}, plain-loop runs {n_plain}",
              flush=True)
        rplan = lm_kernel.KernelPlan(robot.spec, cfg)
        check(rplan.runtime_chain, f"{a} joints did not take the run-time "
              "chain")
        lanes_p, p_ms = plain(rplan, rtr, rtt, rx0)
        err = full_width_checks(robot, rplan, rtr, rtt, rx0, lanes_p,
                                f"{a} DoF main config")
        row = dof_row(a, rplan, b, rtr, rtt, rx0, lanes_p, p_ms,
                      ops_jobs[a].result())
        row.update(pose_err=err, launches=n_launch)
        path = {"name": f"{a}-joint arm ik_batch (run-time chain)", "B": b,
                "config": MAIN, "launches": n_launch,
                "plain_loop_runs": n_plain, "success": rate,
                "solves_per_s": b / main_s, "fk_err": fk}
        return path, err, n_launch

    rt_paths, rt_launches = [], 0
    for a in RUNTIME_MAIN_DOF:
        path, err, n = runtime_main_path(a, B_MAIN)
        rt_paths.append(path)
        rt_err, rt_launches = max(rt_err, err), rt_launches + n

    # (f) Weights and Quality on the run-time chain.
    rt_checks, err = option_checks(
        robots[RUNTIME_MAIN_DOF[0]], 21,
        (("Speed weighted", cfg.replace(**WIDE_WEIGHTS)),
         ("Quality (256, 64)", qcfg)), f"{RUNTIME_MAIN_DOF[0]}-joint arm")
    rt_err = max(rt_err, err)

    path, err, n = runtime_main_path(RUNTIME_NO_CAP_DOF, B_CHECK)
    rt_paths.append(path)
    rt_err = max(rt_err, err)
    libraries = {r["library"] for r in rt_rows.values()}
    check(len(libraries) == 1, f"the run-time chain's rows loaded "
          f"{len(libraries)} Speed libraries: {sorted(libraries)}")
    print(f"run-time chain: the rows of {', '.join(rt_rows)} joints all "
          f"loaded {libraries.pop()}", flush=True)

    # (d) float64 on the card: the plain loop, by config.
    panda64 = Robot(panda.spec, dtype=torch.float64, device="cuda")
    ftr, ftt, fx0 = (v.double() for v in problem(panda, B_OPT, seed=4))
    lm_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    f64 = panda64.ik_batch(cfg, ftr, ftt, fx0)
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    f64_launches = lm_kernel.LAUNCHES
    check(f64_launches == 0, f"the float64 Robot launched the LM kernel "
          f"{f64_launches} times: the route is by config, to the plain loop")
    check(f64.x.is_cuda and f64.x.dtype == torch.float64,
          "the float64 solve did not run in float64 on the card")
    f64_success = float(f64.found.float().mean())
    check_solutions(panda64, f64, ftr, ftt, cfg.tol_f, "float64 on the card")
    host = Robot(panda.spec, dtype=torch.float64, device="cpu")
    t0 = time.perf_counter()
    host_res = host.ik_batch(cfg, ftr.cpu(), ftt.cpu(), fx0.cpu())
    host_s = time.perf_counter() - t0
    f64_diff = int((f64.found.cpu() != host_res.found).sum())
    check(f64_diff <= max(1, MASK_DIFF_FRAC * B_OPT),
          f"float64: found masks differ from the host's f64 loop on "
          f"{f64_diff} of {B_OPT} poses")
    print(f"float64 Panda Robot @B={B_OPT} through Robot.ik_batch: the plain "
          f"loop on the card, {f64_launches} kernel launches, success "
          f"{f64_success:.6f}, {f64_s:.2f} s; found mask differs from the "
          f"f64 loop on the host CPU ({host_s:.2f} s) on {f64_diff} poses",
          flush=True)
    f64_path = {"name": "float64 plain loop on the card", "B": B_OPT,
                "config": MAIN, "launches": f64_launches,
                "success": f64_success, "mask_diff_vs_f64_host": f64_diff,
                "s": f64_s, "host_f64_s": host_s}
    phase_s = time.perf_counter() - t_phase
    print(f"phase 18 took {phase_s:.1f} s", flush=True)
    wide = {"dof": rows, "launches": launches, "max_abs_err": max_err,
            "mobile_panda": dict(main_path, checks=checks),
            "float64_launches": f64_launches, "phase_s": phase_s}
    head = rt_rows[str(RUNTIME_MAIN_DOF[-1])]
    runtime = {"launches": rt_launches, "max_abs_err": rt_err,
               "ms": head["ms"], "plain_ms": head["plain_ms"],
               "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
               "library_ms": None,
               "library_ms_reason": "no single PyTorch call computes an LM "
                                    "solve",
               "headline": f"{RUNTIME_MAIN_DOF[-1]} joints, B={B_MAIN}",
               "dof": rt_rows, "checks": rt_checks}
    return [main_path, *rt_paths, f64_path], wide, runtime


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    if not (REPO / "optik_tpu_torch" / "csrc" / "lm_kernel.cu").exists():
        print(f"chip_smoke: no optik_tpu_torch checkout beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from optik_tpu_torch import Robot, SolverConfig
    from optik_tpu_torch.benchmarks import (bench_fp32_peak, exp_bisect,
                                            exp_warp_probe, parity_hard)
    from optik_tpu_torch.benchmarks.timing import card_line, event_ms
    from optik_tpu_torch.models import ChainSpec, asset_path
    from optik_tpu_torch.native import host as native_host
    from optik_tpu_torch.ops.cuda import build, lm_kernel

    # 1. The card.
    card = card_line()
    print(card, flush=True)
    device_name = torch.cuda.get_device_name(0)

    # 2. Build every library this script launches, all at once.  Each LM
    # library holds one instantiation: the Panda's chain (its constants are
    # part of the build key) and (quality, weighted, wide, fmad).
    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", device="cuda")
    cfg = SolverConfig(**MAIN)
    qcfg = SolverConfig.create("quality", **QUALITY)
    plan = lm_kernel.KernelPlan(robot.spec, cfg)
    # Phase 18's chains: the mobile Panda, 16 joints and the widest folded
    # chain, and the run-time chain's arms, whose operation counts (the
    # bound's numerator) a pool of spawned processes traces meanwhile.
    wrobots = wide_robots(Robot)
    arms = (*RUNTIME_MAIN_DOF, RUNTIME_NO_CAP_DOF)
    ops_pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(arms), mp_context=multiprocessing.get_context("spawn"))
    ops_jobs = {a: ops_pool.submit(op_count, wrobots[a].spec, MAIN)
                for a in arms}
    lm_variants = {
        "speed": (False, False, False, True),
        "speed uncontracted": (False, False, False, False),
        "speed weighted uncontracted": (False, True, False, False),
        "speed wide uncontracted": (False, False, True, False),
        "quality": (True, False, False, True),
        "quality uncontracted": (True, False, False, False),
        "quality wide": (True, False, True, True),
        "quality wide uncontracted": (True, False, True, False),
    }
    # The UR5 of phase 16's tight-limits set: another chain, so another
    # library (its limits are run-time data); and the native host library.
    ur5_plan = lm_kernel.KernelPlan(parity_hard.tight_ur5(
        ChainSpec.from_urdf_file(asset_path(parity_hard.UR5[0]),
                                 *parity_hard.UR5[1:])), cfg)
    # The UR3e of phase 9c: one more six-joint chain, its own library.
    ur3e = Robot.from_urdf_file(asset_path("ur3e.urdf"), "ur_base_link",
                                "ur_ee_link", device="cuda")
    ur3e_plan = lm_kernel.KernelPlan(ur3e.spec, cfg)

    def gxx_build():
        t = time.perf_counter()
        path = native_host.build()
        native_host.build_example()
        return path, time.perf_counter() - t

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=24) as pool:
        jobs = {name: pool.submit(lm_kernel.load_library, *args)
                for name, args in wide_variants(wrobots, cfg, qcfg).items()}
        jobs.update({name: pool.submit(lm_kernel.load_library, plan.header, q,
                                       w, wide, fm)
                     for name, (q, w, wide, fm) in lm_variants.items()})
        jobs["ur5 speed"] = pool.submit(lm_kernel.load_library,
                                        ur5_plan.header)
        for fm in (True, False):
            jobs["ur3e speed" + ("" if fm else " uncontracted")] = \
                pool.submit(lm_kernel.load_library, ur3e_plan.header,
                            fmad=fm)
        jobs["fp32_peak"] = pool.submit(bench_fp32_peak.load_library, True)
        jobs["fp32_peak uncontracted"] = pool.submit(
            bench_fp32_peak.load_library, False)
        jobs["warp_probe"] = pool.submit(exp_warp_probe.load_library)
        native_job = pool.submit(gxx_build)
        libs = {name: job.result() for name, job in jobs.items()}
        native_path, gxx_s = native_job.result()
    infos = {name: pair[1] for name, pair in libs.items()}
    build_wall_s = time.perf_counter() - t0
    print(f"build: {len(infos)} CUDA libraries and the native host library "
          f"in {build_wall_s:.2f} s wall, the LM ones keyed by the chain's "
          f"constants too (nvcc seconds: " + ", ".join(
              f"{n} {i.seconds:.1f}" for n, i in infos.items())
          + f"; g++ {gxx_s:.1f} s for {native_path.name} and "
          "example_cpp)", flush=True)
    registers, occupancy = {}, {}
    for name in lm_variants:
        rep = lm_kernel.library_report(*libs[name])
        registers[name] = rep["registers"]
        occupancy[name] = {k: rep[k] for k in (
            "block_threads", "blocks_per_sm", "warps_per_sm")}
        print(f"  lm_solve Panda {name}: {rep['registers']} registers, "
              f"{rep['stack']} B stack, {rep['spill_bytes']} B spilled, "
              f"blocks of {rep['block_threads']} threads, "
              f"{rep['blocks_per_sm']} resident per SM = "
              f"{rep['warps_per_sm']} warps", flush=True)
    for name in ("fp32_peak", "warp_probe"):
        u = build.ptxas_usage(infos[name].ptxas)
        print(f"  {name} (first kernel): {usage_text(u)}", flush=True)
    for name in ("runtime speed", "runtime speed weighted", "runtime quality"):
        rep = lm_kernel.library_report(*libs[name])
        print(f"  lm_solve {name} (every chain above {lm_kernel.MAX_DOF} "
              f"joints): {rep['registers']} registers, {rep['stack']} B "
              f"stack, {rep['spill_bytes']} B spilled, "
              f"{rep['blocks_per_sm']} blocks resident per SM = "
              f"{rep['warps_per_sm']} warps, nvcc {rep['nvcc_s']:.1f} s",
              flush=True)
    main_use = build.ptxas_usage(infos["speed"].ptxas, "lm_solve_kernel")
    check(main_use["spill_stores"] == 0 and main_use["spill_loads"] == 0,
          "the Speed / identity-weights kernel spills")

    ops_iter = lm_kernel.fp32_ops_per_lane_iter(plan)
    sass = sass_fp32_counts(build, infos["speed"].path)
    what = (f"FP32 operations per lane-iteration: {ops_iter} needed (chain "
            "folded, live side of every select, traced; dense algebra by "
            "hand)")
    if sass is None:
        print(what + "; no cuobjdump for a SASS count", flush=True)
    else:
        static = 2 * sass["FFMA"] + sass["FMUL"] + sass["FADD"] + sass["MUFU"]
        print(what + f"; SASS of the whole Speed kernel, static: {sass} -> "
              f"2*FFMA+FMUL+FADD+MUFU = {static} (the draw and write-out of "
              "a pose, both sides of every branch and the IEEE division "
              "sequences included)", flush=True)
        check(sass["DFMA"] + sass["DMUL"] + sass["DADD"] == 0,
              "the chain's static terms did not fold at compile time: the "
              "Speed kernel's SASS holds double-precision arithmetic")

    # 3. Kernel against its plain version at B_CHECK, same inputs and the
    # same uploaded seed table.
    tr, tt, x0 = problem(robot, B_CHECK, seed=1)
    lanes_p = lm_kernel.solve_plain(plan, tr, tt, x0, track_active=True)
    lanes_e = lm_kernel.solve_kernel(plan, tr, tt, x0, fmad=False)
    torch.cuda.synchronize()
    lanes_equal(lanes_e, lanes_p, "main config")
    check(int(lanes_e.lane_iters)
          == int(lm_kernel.pose_lane_iters(lanes_p.active_iters)),
          "the kernel's pose iterations differ from the plain loop's")
    print(f"uncontracted kernel vs plain @B={B_CHECK}: every lane's x, f, "
          f"success, restart index and iterations bitwise equal; the inputs "
          f"need {int(lanes_p.active_iters.sum()) / B_CHECK:.1f} "
          f"lane-iterations per solve, the kernel's pose groups ran "
          f"{int(lanes_e.lane_iters) / B_CHECK:.1f} (equal to the plain "
          f"loop's per-pose count), its warps executed "
          f"{lm_kernel.exec_slots(lanes_e) / B_CHECK:.1f} slots, the lockstep loop "
          f"{int(lanes_p.lane_iters) / B_CHECK:.1f}", flush=True)
    k, max_abs_err = compare_contracted(robot, lm_kernel, plan, tr, tt, x0,
                                        lanes_p, "main config")

    # 4. Bitwise determinism across repeats and batch sizes.
    k2 = lm_kernel.select(plan, lm_kernel.solve_kernel(plan, tr, tt, x0), x0)
    h = 1024
    kh = lm_kernel.select(
        plan, lm_kernel.solve_kernel(plan, tr[:h], tt[:h], x0[:h]), x0[:h])
    for name, a, b in (("repeat", k, k2), ("first 1024 alone", k, kh)):
        n = b.found.shape[0]
        check(torch.equal(a.x[:n], b.x) and torch.equal(a.found[:n], b.found)
              and torch.equal(a.cost[:n], b.cost),
              f"kernel not bitwise deterministic ({name})")
    print("determinism: repeat and first-1024-alone solves are bitwise "
          "identical", flush=True)

    # 5. Kernel against plain at the main shape (comparison launches, not
    # the main path), both times, and the work these inputs need.
    tr, tt, x0 = problem(robot, B_MAIN, seed=2)
    kernel_ms = event_ms(lambda: lm_kernel.solve_kernel(plan, tr, tt, x0), 5)
    speed_sched = schedule_line(lm_kernel, lm_kernel.solve_kernel(
        plan, tr, tt, x0), f"Speed kernel @B={B_MAIN}")
    plain_out = []
    plain_ms = 1e3 * timed(lambda: plain_out.append(lm_kernel.solve_plain(
        plan, tr, tt, x0, track_active=True)), 1)
    lanes_p = plain_out.pop()
    needed = int(lanes_p.active_iters.sum())
    lanes_equal(lm_kernel.solve_kernel(plan, tr, tt, x0, fmad=False), lanes_p,
                f"main config @B={B_MAIN}")
    print(f"uncontracted kernel vs plain @B={B_MAIN}: every lane's x, f, "
          "success, restart index and iterations bitwise equal", flush=True)
    _, err_main = compare_contracted(robot, lm_kernel, plan, tr, tt, x0,
                                     lanes_p, "main config")
    max_abs_err = max(max_abs_err, err_main)
    del lanes_p
    lm_bound_ms, lm_bound_by = bound(
        ops_iter * needed, lm_bytes(7, B_MAIN, plan.s, plan.r_total))
    print(f"times @B={B_MAIN}: kernel {kernel_ms:.3f} ms (CUDA events, mean "
          f"of 5), plain {plain_ms:.1f} ms (host clock, 1 run); the inputs "
          f"need {needed} lane-iterations ({needed / B_MAIN:.1f} per solve) "
          f"x {ops_iter} FP32 operations = {ops_iter * needed / 1e9:.2f} "
          f"GFLOP and {lm_bytes(7, B_MAIN, plan.s, plan.r_total) / 1e6:.1f} "
          f"MB: bound {lm_bound_ms:.3f} ms by {lm_bound_by}; achieved "
          f"{ops_iter * needed / (kernel_ms * 1e-3) / 1e12:.2f} TFLOP/s of "
          f"needed work, {100 * lm_bound_ms / kernel_ms:.1f}% of the bound",
          flush=True)

    # One warp alone on the card: 4 poses whose targets lie out of reach
    # run every iteration of their budget.  Its time per iteration is the
    # dependent chain no amount of parallel work shortens: the floor of a
    # launch too small to fill the card (exp_bisect, a late unlimited round).
    far = tt[:4] + 10.0
    lone = lm_kernel.solve_kernel(plan, tr[:4], far, x0[:4])
    lone_trips = lm_kernel.exec_slots(lone) // 32
    check(lone_trips > cfg.max_iters and not bool(lone.success.any()),
          "the out-of-reach poses did not run through their restarts")
    lone_iter_ms = event_ms(lambda: lm_kernel.solve_kernel(
        plan, tr[:4], far, x0[:4]), 5) / lone_trips
    print(f"one warp alone: {lone_trips} iterations of 4 out-of-reach poses "
          f"in {lone_iter_ms * lone_trips:.3f} ms = {1e3 * lone_iter_ms:.2f} "
          "us per iteration", flush=True)

    # 6. The main path, through the user-facing entry points, in ikbench's
    # call form (ikbench/drivers/ik_stream.py).
    def solve():
        return robot.ik_batch(cfg, tr, tt, x0, validate_seeds=False,
                              rescue_overflow=False)

    solve()  # warm: solver build and seed-table upload
    lm_kernel.LAUNCHES = 0
    runs = 5
    results = []
    main_s = timed(lambda: results.append(solve()), runs)
    launches = lm_kernel.LAUNCHES
    check(launches >= runs, f"main path launched the kernel {launches} "
          f"times in {runs} solves")
    res = results[-1]
    success = float(res.found.float().mean())
    check(success >= 0.99, f"main-path success {success} < 0.99")
    fk_main = check_solutions(robot, res, tr, tt, cfg.tol_f, "main path")
    check(int(res.overflow_count) == 0, "the single-shot path reported "
          "overflow")
    lane_iters = int(res.lane_iters)
    print(f"main path @B={B_MAIN}: success {success:.6f}, "
          f"{B_MAIN / main_s:.0f} solves/s kernel path (median of {runs}, "
          f"{main_s * 1e3:.2f} ms/batch), {B_MAIN / (plain_ms / 1e3):.0f} "
          f"solves/s plain path, {lane_iters / B_MAIN:.1f} lane-iters/solve, "
          f"FK err {fk_main:.3g}, launches {launches}", flush=True)
    one_round = res

    # A stream's pass of that form, 8 chained calls with found_count summed
    # on the device and fetched once, synchronises only at its fetch.
    def pipelined_pass():
        acc = None
        for _ in range(8):
            c = solve().found_count
            acc = c if acc is None else acc + c
        int(acc)

    n_sync = sync_count(pipelined_pass)
    check(n_sync is None or n_sync == 0, f"a pipelined pass of 8 ik_batch "
          f"calls synchronised {n_sync} times more than one fetch does")
    print("pipelined pass (8 chained ik_batch calls, found_count added on "
          "the device, one fetch): "
          + ("the profiler saw no CUDA runtime call (not measured)"
             if n_sync is None else f"{n_sync} synchronisations beyond "
             "those of one scalar fetch"), flush=True)

    # 7. Quality at full width through the facade, then kernel against
    # plain on the same inputs.
    qplan = lm_kernel.KernelPlan(robot.spec, qcfg)
    qtr, qtt, qx0 = problem(robot, B_QUALITY, seed=3)

    def qsolve():
        return robot.ik_batch(qcfg, qtr, qtt, qx0, validate_seeds=False)

    qsolve()
    lm_kernel.LAUNCHES = 0
    results = []
    q_s = timed(lambda: results.append(qsolve()), 3)
    q_launches = lm_kernel.LAUNCHES
    check(q_launches >= 3, f"Quality path launched the kernel {q_launches} "
          "times in 3 solves")
    qres = results[-1]
    q_success = float(qres.found.float().mean())
    check(q_success >= 0.99, f"Quality success {q_success} < 0.99")
    fk_q = check_solutions(robot, qres, qtr, qtt, qcfg.tol_f, "Quality path")
    quality_ms = event_ms(
        lambda: lm_kernel.solve_kernel(qplan, qtr, qtt, qx0), 3)
    quality_sched = schedule_line(lm_kernel, lm_kernel.solve_kernel(
        qplan, qtr, qtt, qx0), f"Quality kernel @B={B_QUALITY}")
    print(f"Quality path @B={B_QUALITY} (256 restarts, 64 lanes, 48 "
          f"iterations): success {q_success:.6f}, {B_QUALITY / q_s:.0f} "
          f"solves/s (median of 3, {q_s * 1e3:.2f} ms/batch), kernel "
          f"{quality_ms:.3f} ms, {int(qres.lane_iters) / B_QUALITY:.1f} "
          f"lane-iters/solve, FK err {fk_q:.3g}, launches {q_launches}",
          flush=True)
    q_plain = []
    quality_plain_ms = 1e3 * timed(lambda: q_plain.append(
        lm_kernel.solve_plain(qplan, qtr, qtt, qx0)), 1)
    lanes_equal(lm_kernel.solve_kernel(qplan, qtr, qtt, qx0, fmad=False),
                q_plain[0], "Quality (256, 64)")
    print(f"Quality uncontracted kernel vs plain @B={B_QUALITY}: every "
          f"lane's best x, f, success, index and iterations bitwise equal "
          f"(plain {quality_plain_ms:.1f} ms)", flush=True)
    _, q_err = compare_contracted(robot, lm_kernel, qplan, qtr, qtt, qx0,
                                  q_plain.pop(), "Quality (256, 64)")
    max_abs_err = max(max_abs_err, q_err)

    # 8. Unlimited restart rounds at the main shape.
    ucfg = cfg.replace(max_restarts=0, unlimited_rounds_cap=4)
    lm_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    ures = robot.ik_batch(ucfg, tr, tt, x0, validate_seeds=False)
    torch.cuda.synchronize()
    u_s = time.perf_counter() - t0
    u_launches = lm_kernel.LAUNCHES
    check(u_launches > 1, f"unlimited rounds launched {u_launches} time(s)")
    f1 = one_round.found
    check(bool((ures.found | ~f1).all()), "unlimited rounds lost a pose the "
          "first round found")
    check(torch.equal(ures.x[f1], one_round.x[f1])
          and torch.equal(ures.cost[f1], one_round.cost[f1]),
          "unlimited rounds changed a round-1 result")
    check_solutions(robot, ures, tr, tt, cfg.tol_f, "unlimited rounds")
    # The repeat is timed too: the first solve also builds its plan and the
    # three later rounds' seed tables on the host.
    t0 = time.perf_counter()
    again = robot.ik_batch(ucfg, tr, tt, x0, validate_seeds=False)
    torch.cuda.synchronize()
    u_warm_s = time.perf_counter() - t0
    check(torch.equal(again.x, ures.x) and torch.equal(again.found, ures.found)
          and torch.equal(again.cost, ures.cost),
          "unlimited rounds are not bitwise repeatable")
    late_ms = (u_warm_s - main_s) * 1e3 / max(1, u_launches - 1)
    print(f"unlimited rounds @B={B_MAIN} (cap 4): {u_launches} launches in "
          f"one solve, found {int(ures.found.sum())} (one round "
          f"{int(f1.sum())}), round-1 results bitwise kept, repeat bitwise "
          f"identical, {u_s * 1e3:.2f} ms the first time (plan and seed "
          f"tables built on the host), {u_warm_s * 1e3:.2f} ms repeated: "
          f"{late_ms:.2f} ms per round after the first, against the "
          f"one-round solve's {main_s * 1e3:.2f}; "
          f"{int(ures.lane_iters) / B_MAIN:.1f} lane-iters/solve", flush=True)

    # 9. Option cases at B_OPT: uncontracted kernel bitwise equal to plain.
    otr, ott, ox0 = problem(robot, B_OPT, seed=4)
    def option_case(what, ocfg, **kw):
        oplan = lm_kernel.KernelPlan(robot.spec, ocfg)
        kk = lm_kernel.solve_kernel(oplan, otr, ott, ox0, fmad=False, **kw)
        pp = lm_kernel.solve_plain(oplan, otr, ott, ox0, **kw)
        torch.cuda.synchronize()
        lanes_equal(kk, pp, what)
        return lm_kernel.select(oplan, kk, ox0)

    base = option_case("main config", cfg)
    weighted = option_case("weighted Speed", cfg.replace(
        linear_weight=(0.0, 1.0, 1.0), angular_weight=(0.5, 1.0, 2.0)))
    check(not torch.allclose(weighted.x, base.x, atol=1e-3),
          "the weighted solve equals the unweighted one")
    for restarts, s in ((24, 3), (48, 12), (64, 64)):
        option_case(f"Speed ({restarts}, {s})",
                    cfg.replace(max_restarts=restarts, seed_batch=s))
    qsmall = SolverConfig.create("quality", max_iters=32, tol_f=1e-6)
    option_case("Quality (48, 16)",
                qsmall.replace(max_restarts=48, seed_batch=16))
    uncapped = option_case("Quality (12, 4)",
                           qsmall.replace(max_restarts=12, seed_batch=4))
    capped = option_case("Quality (12, 4) cap 1", qsmall.replace(
        max_restarts=12, seed_batch=4, quality_max_successes=1))
    check(torch.equal(capped.found, uncapped.found),
          "the success cap changed the found mask")
    # Capped Quality at full width: its pose groups on a pair of warps.
    wide_capped = option_case("Quality (256, 64) cap 8",
                              qcfg.replace(quality_max_successes=8))
    wide_capped_success = float(wide_capped.found.float().mean())
    check(wide_capped_success >= 0.99, f"capped Quality (256, 64) success "
          f"{wide_capped_success} < 0.99")
    shifted = option_case("restart_offset=64", cfg, restart_offset=64)
    streamed = option_case("lane0_stream", cfg, lane0_stream=True)
    check(not torch.equal(shifted.x, base.x)
          and not torch.equal(streamed.x, base.x),
          "restart_offset or lane0_stream left the solve unchanged")
    print(f"option cases @B={B_OPT}: weights (differs from unweighted), S = "
          f"3, 12, 64, Quality (48, 16), Quality (12, 4) with and without "
          f"cap 1 (equal found masks), Quality (256, 64) cap 8 (two-warp "
          f"poses, success {wide_capped_success:.6f}), restart_offset=64, lane0_stream: "
          f"uncontracted kernel bitwise equal to plain in every lane",
          flush=True)

    # 9b. More seed lanes per pose than the kernel holds: Robot.ik_batch
    # routes the config to the plain loop on the card (exact libm), and the
    # port's own f64 plain loop on the host CPU is its comparison.
    wide_cfg = SolverConfig.create("quality", **S128)
    lm_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    wide_res = robot.ik_batch(wide_cfg, otr, ott, ox0)
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    wide_launches = lm_kernel.LAUNCHES
    check(wide_launches == 0, f"S=128 launched the LM kernel {wide_launches} "
          "times: the route is by config, to the plain loop")
    check(wide_res.x.is_cuda and wide_res.found.is_cuda,
          "S=128 did not run on the card")
    wide_success = float(wide_res.found.float().mean())
    check(wide_success >= 0.99, f"S=128 success {wide_success} < 0.99")
    fk_wide = check_solutions(robot, wide_res, otr, ott, wide_cfg.tol_f,
                              "S=128 plain loop on the card")
    cpu64 = Robot(robot.spec, dtype=torch.float64, device="cpu")
    t0 = time.perf_counter()
    host_res = cpu64.ik_batch(wide_cfg, otr.cpu().double(),
                              ott.cpu().double(), ox0.cpu().double())
    host_s = time.perf_counter() - t0
    wide_diff = int((wide_res.found.cpu() != host_res.found).sum())
    check(wide_diff <= max(1, MASK_DIFF_FRAC * B_OPT),
          f"S=128: found masks differ from the f64 host loop on {wide_diff} "
          f"of {B_OPT} poses")
    print(f"S=128 (Quality, 256 restarts, 128 lanes) @B={B_OPT} through "
          f"Robot.ik_batch: the plain loop on the card, {wide_launches} kernel "
          f"launches, success {wide_success:.6f}, FK err {fk_wide:.3g}, "
          f"{wide_s:.2f} s; found mask differs from the f64 loop on the host "
          f"CPU ({host_s:.2f} s) on {wide_diff} poses", flush=True)
    wide_path = {"name": "S=128 plain loop on the card", "B": B_OPT,
                 "config": S128, "launches": wide_launches,
                 "success": wide_success, "mask_diff_vs_f64_host": wide_diff,
                 "s": wide_s, "host_f64_s": host_s}

    # 9c. The UR3e, a second six-joint chain: Robot.ik_batch in the main
    # config, and its uncontracted kernel bitwise equal to plain.
    utr, utt, ux0 = problem(ur3e, B_OPT, seed=19)
    lm_kernel.LAUNCHES = 0
    ur3e_res = ur3e.ik_batch(cfg, utr, utt, ux0, validate_seeds=False,
                          rescue_overflow=False)
    check(lm_kernel.LAUNCHES == 1, f"the UR3e's ik_batch launched the "
          f"kernel {lm_kernel.LAUNCHES} times")
    ur3e_success = float(ur3e_res.found.float().mean())
    check(ur3e_success >= 0.99, f"UR3e success {ur3e_success} < 0.99")
    fk_ur3e = check_solutions(ur3e, ur3e_res, utr, utt, cfg.tol_f, "UR3e")
    lanes_equal(lm_kernel.solve_kernel(ur3e_plan, utr, utt, ux0, fmad=False),
                lm_kernel.solve_plain(ur3e_plan, utr, utt, ux0), "UR3e")
    print(f"UR3e @B={B_OPT} (main config): success {ur3e_success:.6f}, FK "
          f"err {fk_ur3e:.3g}; uncontracted kernel bitwise equal to plain "
          "in every lane", flush=True)

    # 18. Chains wider than the Panda, and float64 on the card.
    speed_rep = lm_kernel.library_report(*libs["speed"])
    panda_row = {"B": B_MAIN, "registers": speed_rep["registers"],
                 "spill_bytes": speed_rep["spill_bytes"],
                 "stack": speed_rep["stack"],
                 "warps_per_sm": speed_rep["warps_per_sm"],
                 "nvcc_s": speed_rep["nvcc_s"], "ms": kernel_ms,
                 "plain_ms": plain_ms, "lane_iters_per_solve": needed / B_MAIN,
                 "fp32_ops_needed": ops_iter, "bound_ms": lm_bound_ms,
                 "bound_by": lm_bound_by}
    dof_paths, dof_entry, rt_entry = wide_phases(robot, wrobots, cfg, qcfg,
                                                 panda_row, ops_jobs)
    ops_pool.shutdown()

    # 10a. fp32_peak: comparisons first (at the timed shape and depth,
    # where contraction has drifted; at the timed shape after a few trips;
    # at the original's element count), then its entry point.
    deep = bench_fp32_peak.check_parity(
        bench_fp32_peak.N_TIMED, bench_fp32_peak.N_IT_TIMED, rtol=None)
    short = bench_fp32_peak.check_parity(bench_fp32_peak.N_TIMED)
    small = bench_fp32_peak.check_parity()
    fp_err, fp_plain_ms = deep["max_abs_err"], deep["plain_ms"]
    bench_fp32_peak.LAUNCHES = 0
    rates = bench_fp32_peak.measure("cuda")
    fp_launches = bench_fp32_peak.LAUNCHES
    check(fp_launches >= 3, "fp32_peak launched no kernel")
    fp_ms = sum(r["ms"] for r in rates.values())
    fp_ops = sum(r["ops_per_trip"] * r["n"] * r["n_it"]
                 for r in rates.values())
    fp_bound_ms, fp_bound_by = bound(
        fp_ops, 3 * 2 * bench_fp32_peak.C * bench_fp32_peak.N_TIMED * 4)
    print("fp32_peak @" + f"{bench_fp32_peak.N_TIMED} elements: " + ", ".join(
        f"{n} {r['gops_per_s']:.0f} Gop/s ({r['ms']:.2f} ms, {r['n_it']} "
        f"trips)" for n, r in rates.items())
        + f"; uncontracted bitwise equal to plain at full depth, contracted "
        f"within {bench_fp32_peak.RTOL_CONTRACTED} relative at "
        f"{bench_fp32_peak.N_IT_CHECK} trips ({short['max_rel_err']:.3g}; "
        f"{small['max_rel_err']:.3g} on {bench_fp32_peak.N_CHECK} elements) "
        f"and {deep['max_rel_err']:.3g} relative, |d| {fp_err:.3g}, at full "
        f"depth; plain {fp_plain_ms:.0f} ms", flush=True)

    # 10b. warp_probe, in two groups: the cases one PyTorch call computes
    # (held against that call too) and the loops.
    lib_cases = exp_warp_probe.LIBRARY_CASES
    loop_cases = tuple(c for c in exp_warp_probe.CASES if c not in lib_cases)

    def each(fn, cases):
        for name in cases:
            fn(name, "cuda")

    wp = {}
    for group, cases in (("fill", lib_cases), ("loops", loop_cases)):
        exp_warp_probe.LAUNCHES = 0
        probe = exp_warp_probe.run_all("cuda", cases)
        n_launch = exp_warp_probe.LAUNCHES
        check(all(r["exact"] for r in probe.values()),
              f"warp_probe cases differ from plain: {probe}")
        check(n_launch == len(cases),
              f"warp_probe launched {n_launch} kernels for {cases}")
        ms = event_ms(exp_warp_probe.prepare_many(cases, "cuda"), 20)
        # Each int32 output written once; the int8 one is a quarter of that.
        nbytes = sum(1 if c == "int8_store" else 4 for c in cases) * 8 * 256
        b_ms, b_by = bound(0, nbytes)
        wp[group] = {
            "launches": n_launch, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": max(r["max_abs_err"] for r in probe.values()),
            "plain_ms": 1e3 * timed(
                lambda: each(exp_warp_probe.plain_case, cases), 5),
            "library_ms": None, "cases": list(cases)}
    for name in lib_cases:
        check(torch.equal(exp_warp_probe.library_case(name, "cuda"),
                          exp_warp_probe.run_kernel(name, "cuda")),
              f"warp_probe {name} differs from its library call")
    # Kernel and library calls in turns, both prepared (device, dtype, case
    # numbers and stream resolved once) and both by event_ms; then what each
    # side's kernels take on the device alone, from the profiler, so that
    # the gap splits into host path and device time.
    fill = exp_warp_probe.prepare_many(lib_cases, "cuda")
    lib_calls = exp_warp_probe.prepare_library(lib_cases, "cuda")
    check(all(torch.equal(a, b) for a, b in zip(fill(), lib_calls())),
          "the prepared fill launches differ from the prepared library calls")
    lib_ms, fill_ms = [], []
    for _ in range(3):
        lib_ms.append(event_ms(lib_calls, 20))
        fill_ms.append(event_ms(fill, 20))
    wp["fill"]["ms"] = sorted(fill_ms)[1]
    wp["fill"]["library_ms"] = sorted(lib_ms)[1]
    wp["fill"]["library_unprepared_ms"] = event_ms(
        lambda: each(exp_warp_probe.library_case, lib_cases), 20)

    def device_ms(fn):
        split = profile_split(fn, 20)
        return None if split is None else sum(split["kernels"].values()) / 20
    wp["fill"]["device_ms"] = device_ms(fill)
    wp["fill"]["library_device_ms"] = device_ms(lib_calls)
    # The loops' entry carries the fill's fields: their kernels' device time
    # through the same one C call, and no library side.
    wp["loops"].update(
        device_ms=device_ms(exp_warp_probe.prepare_many(loop_cases, "cuda")),
        library_unprepared_ms=None, library_device_ms=None,
        library_ms_reason="the cases are loops or a compare followed by a "
        "cast: no single PyTorch call computes one "
        "(exp_warp_probe.LIBRARY_CASES)")

    def dev_text(v):
        return "not measured" if v is None else f"{v:.4f} ms"
    print("warp_probe: " + "; ".join(
        f"{len(g['cases'])} {name} cases exact (|d| {g['max_abs_err']:g}), "
        f"{g['ms']:.4f} ms for the launches, plain {g['plain_ms']:.3f} ms"
        for name, g in wp.items())
        + f"; the fill cases as library calls {wp['fill']['library_ms']:.4f} "
        f"ms (median of 3 turns each: kernel "
        + ", ".join(f"{v:.4f}" for v in fill_ms) + "; library "
        + ", ".join(f"{v:.4f}" for v in lib_ms) + "; not prepared, as "
        f"library_case makes them, {wp['fill']['library_unprepared_ms']:.4f})"
        f"; device time alone (profiler, per turn): the four fill kernels "
        f"{dev_text(wp['fill']['device_ms'])}, the library's "
        f"{dev_text(wp['fill']['library_device_ms'])}, the three loop kernels "
        f"{dev_text(wp['loops']['device_ms'])}", flush=True)

    # 10c. exp_bisect: each variant against plain, then its entry point.
    prob = exp_bisect.make_problem(robot.fk_batch, robot.spec, "cuda")
    bis_err, bis_needed, bis_plain_ms, bis_depth = 0.0, 0, 0.0, 0
    for name, max_iters, group_stop in exp_bisect.VARIANTS:
        pl = []
        bis_plain_ms += 1e3 * timed(lambda: pl.append(
            exp_bisect.plain_variant_lanes(prob, max_iters, group_stop,
                                           track_active=True)), 1)
        bis_needed += int(pl[0].active_iters.sum())
        bis_depth += int(pl[0].active_iters.max())
        px, pf = exp_bisect.lanes_to_outputs(pl[0])
        ex, ef = exp_bisect.kernel_variant(prob, max_iters, group_stop,
                                           fmad=False)
        check(torch.equal(ex, px) and torch.equal(ef, pf),
              f"exp_bisect {name}: uncontracted kernel differs from plain")
        kx, kf = exp_bisect.kernel_variant(prob, max_iters, group_stop)
        both = (kf <= cfg.tol_f) & (pf <= cfg.tol_f)       # (S, P)
        n_flip = int(((kf <= cfg.tol_f) != (pf <= cfg.tol_f)).sum())
        check(n_flip <= 0.01 * both.numel(),
              f"exp_bisect {name}: {n_flip} lanes converge in one version "
              "only")
        check(bool(both.any()), f"exp_bisect {name}: no lane converged")
        rk, tk = robot.fk_batch(kx.permute(1, 2, 0)[both])
        rp, tp = robot.fk_batch(px.permute(1, 2, 0)[both])
        bis_err = max(bis_err, float((rk - rp).abs().max()),
                      float((tk - tp).abs().max()))
    check(bis_err <= 2 * FK_TOL, f"exp_bisect: converged lanes reach poses "
          f"{bis_err} apart")
    # The launches of its entry point, counted at the launch: the three
    # variants and the 2-round reseeding solve.
    lm_kernel.LAUNCHES = 0
    rows = exp_bisect.run_all(prob)
    bis_launches = lm_kernel.LAUNCHES
    check(all(r["ok"] for r in rows), f"exp_bisect cases failed: {rows}")
    check(bis_launches == len(exp_bisect.VARIANTS) + 1,
          f"exp_bisect launched the kernel {bis_launches} times")

    def all_variants():
        for _, max_iters, group_stop in exp_bisect.VARIANTS:
            exp_bisect.kernel_variant(prob, max_iters, group_stop)

    bis_ms = event_ms(all_variants, 5)
    bis_bound_ms, bis_bound_by = bound(
        ops_iter * bis_needed,
        3 * lm_bytes(7, exp_bisect.P, exp_bisect.S, 0))
    print(f"exp_bisect: three no-reseed variants uncontracted bitwise equal "
          f"to plain, contracted poses within {bis_err:.3g} on converged "
          f"lanes; 2-round reseeding solve found {rows[-1]['succ']} of "
          f"{exp_bisect.P}; {bis_launches} launches in its entry point; "
          f"{bis_ms:.3f} ms for the three variants, plain "
          f"{bis_plain_ms:.0f} ms; its 2,048 lanes fill 64 warps of the "
          f"card's thousands, so beside the operations bound "
          f"({bis_bound_ms:.4f} ms) stands a latency bound: the variants' "
          f"longest poses run {bis_depth} iterations, x {1e3 * lone_iter_ms:.2f}"
          f" us for one warp alone = {bis_depth * lone_iter_ms:.3f} ms",
          flush=True)

    # 11. Where the device time goes on the two solve paths.
    for what, fn, b in (("main path", solve, B_MAIN),
                        ("Quality path", qsolve, B_QUALITY)):
        split = profile_split(fn, 5)
        if split is None:
            print(f"profile {what}: the profiler saw no device time (not "
                  "measured)", flush=True)
            continue
        total = sum(split["kernels"].values())
        top = sorted(split["kernels"].items(), key=lambda kv: -kv[1])[:4]
        print(f"profile {what} @B={b} (5 calls): device busy "
              f"{total / 5:.3f} ms/call, window {split['window_ms'] / 5:.3f} "
              f"ms/call, idle {100 * (1 - total / split['window_ms']):.1f}%; "
              + "; ".join(f"{n[:48]} {100 * t / total:.1f}%" for n, t in top),
              flush=True)

    # 12-14. Jacobians and differential IK (plain eager tensor operations).
    paths = diffik_phases(robot, Robot, event_ms)
    paths.append(wide_path)
    paths += dof_paths

    # 16. The native latency path, the success-parity harnesses and the C++
    # example.
    native_paths, native_launches = native_phases(robot, cfg)
    paths += native_paths

    # 15. The multi-device paths, last: their process groups and ranks come
    # after every single-device measurement.
    shard_paths, shard_launches = sharded_phases(
        robot, cfg, qcfg, (tr, tt, x0), (qtr, qtt, qx0), res, qres)
    paths += shard_paths

    print(f"total wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"paths": paths}), flush=True)
    lm_src = "optik_tpu_torch/csrc/lm_kernel.cu"
    print(json.dumps({"kernels": [
        {"name": "lm_solve", "route": "cuda", "source": lm_src,
         "replaces": "optik_tpu/ops/pallas/lm_kernel.py:303",
         "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
         "plain_ms": plain_ms, "bound_ms": lm_bound_ms,
         "bound_by": lm_bound_by, "library_ms": None,
         "quality_ms": quality_ms, "quality_plain_ms": quality_plain_ms,
         "quality_launches": q_launches, "unlimited_launches": u_launches,
         "registers": registers, "occupancy": occupancy,
         "schedule": {"speed": speed_sched, "quality": quality_sched},
         "fp32_ops_needed": ops_iter, "sass_static": sass,
         "lone_warp_us_per_iteration": 1e3 * lone_iter_ms,
         "unlimited_ms": u_s * 1e3, "unlimited_repeat_ms": u_warm_s * 1e3,
         "unlimited_late_round_ms": late_ms,
         "sharded_launches": shard_launches,
         "s128_launches": wide_launches,
         "phase16_launches": native_launches,
         "build_wall_s": build_wall_s, "wide": dof_entry},
        {"name": "lm_solve_runtime_chain", "route": "cuda", "source": lm_src,
         "replaces": "optik_tpu/ops/pallas/lm_kernel.py:303", **rt_entry},
        {"name": "fp32_peak", "route": "cuda",
         "source": "optik_tpu_torch/csrc/fp32_peak.cu",
         "replaces": "benchmarks/bench_vpu_peak.py:73",
         "launches": fp_launches, "max_abs_err": fp_err, "ms": fp_ms,
         "plain_ms": fp_plain_ms, "bound_ms": fp_bound_ms,
         "bound_by": fp_bound_by, "library_ms": None,
         "gops_per_s": {n: r["gops_per_s"] for n, r in rates.items()}},
        {"name": "warp_probe", "route": "cuda",
         "source": "optik_tpu_torch/csrc/warp_probe.cu",
         "replaces": "benchmarks/exp_mosaic_probe.py:24", **wp["loops"]},
        {"name": "warp_probe_fill", "route": "cuda",
         "source": "optik_tpu_torch/csrc/warp_probe.cu",
         "replaces": "benchmarks/exp_mosaic_probe.py:24", **wp["fill"]},
        {"name": "lm_bisect", "route": "cuda", "source": lm_src,
         "replaces": "benchmarks/exp_bisect.py:68",
         "launches": bis_launches, "max_abs_err": bis_err, "ms": bis_ms,
         "plain_ms": bis_plain_ms, "bound_ms": bis_bound_ms,
         "bound_by": bis_bound_by, "library_ms": None,
         "latency_bound_ms": bis_depth * lone_iter_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
