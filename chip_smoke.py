#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a line; any failed check exits non-zero):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. the build of every library the script launches, one nvcc per variant,
     all started together: the LM kernel (optik_tpu_torch/csrc/lm_kernel.cu)
     for 7 DoF in Speed, Speed+weights, Speed with two-warp poses and
     Quality, contracted and uncontracted (--fmad=false), the FP32
     throughput probe and the primitive probes; registers and spills of
     each from ptxas;
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
     from which the kernel's roofline bound follows;
  6. the main path, Robot.from_urdf_file -> fk_batch -> ik_batch in Speed
     mode on the Panda at B=131,072 (64 restarts, 8 lanes, 32 iterations,
     tol_f 1e-6, f32): the launch counter rises, success >= 0.99, every
     found cost <= tol_f, FK of found x within 2e-3; solves/s;
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
     success cap, restart_offset and lane0_stream;
 10. the probes: fp32_peak (three bodies: uncontracted bitwise at full
     shape and depth, contracted within 1e-5 relative at 4 trips, then
     Gop/s), warp_probe (seven cases exact, the four that one PyTorch call
     computes also against that call) and the exp_bisect variants against
     their plain versions;
 11. a torch.profiler split of device time on the Speed and Quality paths.
Then one JSON line with every kernel and, last, the result line.  Without a
card, or run from a directory that holds no checkout, it exits 2 and prints
no result.
"""

import concurrent.futures
import json
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
MAIN = dict(max_restarts=64, seed_batch=8, max_iters=32, tol_f=1e-6)
QUALITY = dict(max_restarts=256, seed_batch=64, max_iters=48)
FK_TOL = 2e-3         # cost <= 1e-6 is a pose residual of ~1e-3
MASK_DIFF_FRAC = 1e-3  # marginal poses (cost within ~1e-7 of tol_f)
LANE_FIELDS = ("x", "f", "success", "restart_index", "succ_iters")
# Published peaks of the H100 SXM: FP32 outside the tensor cores (a fused
# multiply-add counted as 2) and device memory.
PEAK_FP32 = 66.9e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


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
    ops = re.findall(r"\b(FFMA|FMUL|FADD|MUFU)\b", out.stdout)
    return {k: ops.count(k) for k in ("FFMA", "FMUL", "FADD", "MUFU")}


def problem(robot, b, seed):
    """Reachable targets (FK of random configurations) and random seeds."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lo, hi = robot.joint_limits()
    tr, tt = robot.fk_batch(rng.uniform(lo, hi, size=(b, 7)))
    x0 = torch.tensor(rng.uniform(lo, hi, size=(b, 7)), dtype=torch.float32,
                      device="cuda")
    return tr, tt, x0


def check_solutions(robot, res, tr, tt, tol_f, what):
    import torch

    n = res.found.shape[0]
    check(res.x.shape == (n, 7) and bool(torch.isfinite(res.x).all()),
          f"{what}: x not finite of shape ({n}, 7)")
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


def event_ms(fn, reps):
    """Mean device milliseconds of fn() over ``reps`` calls (CUDA events),
    after one warm call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_split(fn, reps):
    """Device time by kernel name over ``reps`` warm calls of fn():
    {"kernels": {name: ms}, "window_ms": host ms of the profiled window},
    or None when the profiler recorded no device time."""
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
    kernels = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            if us > 0:
                kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    if not kernels:
        return None
    return {"kernels": kernels, "window_ms": window_ms}


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


def lm_bytes(a, b, s, r):
    """Bytes one solve must move: seeds, targets and the seed table read
    once, x, f, success, restart index and iterations written once."""
    lanes = b * s
    return (a * lanes * 4 + 12 * b * 4 + r * a * 4
            + (a + 1) * lanes * 4 + 9 * lanes)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the FP32 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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
                                            exp_warp_probe)
    from optik_tpu_torch.models import asset_path
    from optik_tpu_torch.ops.cuda import build, lm_kernel

    # 1. The card.
    card = card_line()
    print(card, flush=True)
    device_name = torch.cuda.get_device_name(0)

    # 2. Build every library this script launches, all at once.  Each LM
    # library holds one instantiation: (quality, weighted, wide, fmad).
    lm_variants = {
        "speed": (False, False, False, True),
        "speed uncontracted": (False, False, False, False),
        "speed weighted uncontracted": (False, True, False, False),
        "speed wide uncontracted": (False, False, True, False),
        "quality": (True, False, False, True),
        "quality uncontracted": (True, False, False, False),
    }
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        jobs = {name: pool.submit(lm_kernel.load_library, 7, q, w, wide, fm)
                for name, (q, w, wide, fm) in lm_variants.items()}
        jobs["fp32_peak"] = pool.submit(bench_fp32_peak.load_library, True)
        jobs["fp32_peak uncontracted"] = pool.submit(
            bench_fp32_peak.load_library, False)
        jobs["warp_probe"] = pool.submit(exp_warp_probe.load_library)
        infos = {name: job.result()[1] for name, job in jobs.items()}
    print(f"build: {len(infos)} libraries in {time.perf_counter() - t0:.2f} "
          f"s wall (nvcc seconds: " + ", ".join(
              f"{n} {i.seconds:.1f}" for n, i in infos.items()) + ")",
          flush=True)
    registers = {}
    for name in lm_variants:
        u = build.ptxas_usage(infos[name].ptxas, "lm_solve_kernel")
        registers[name] = u["registers"]
        print(f"  lm_solve 7-DoF {name}: {usage_text(u)}", flush=True)
    for name in ("fp32_peak", "warp_probe"):
        u = build.ptxas_usage(infos[name].ptxas)
        print(f"  {name} (first kernel): {usage_text(u)}", flush=True)
    main_use = build.ptxas_usage(infos["speed"].ptxas, "lm_solve_kernel")
    check(main_use["spill_stores"] == 0 and main_use["spill_loads"] == 0,
          "the Speed / identity-weights kernel spills")

    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", device="cuda")
    cfg = SolverConfig(**MAIN)
    plan = lm_kernel.KernelPlan(robot.spec, cfg)
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
              f"2*FFMA+FMUL+FADD+MUFU = {static} (prologue, both sides of "
              "every branch and the IEEE division sequences included)",
              flush=True)

    # 3. Kernel against its plain version at B_CHECK, same inputs and the
    # same uploaded seed table.
    tr, tt, x0 = problem(robot, B_CHECK, seed=1)
    lanes_p = lm_kernel.solve_plain(plan, tr, tt, x0, track_active=True)
    lanes_e = lm_kernel.solve_kernel(plan, tr, tt, x0, fmad=False)
    torch.cuda.synchronize()
    lanes_equal(lanes_e, lanes_p, "main config")
    print(f"uncontracted kernel vs plain @B={B_CHECK}: every lane's x, f, "
          f"success, restart index and iterations bitwise equal; the inputs "
          f"need {int(lanes_p.active_iters.sum()) / B_CHECK:.1f} "
          f"lane-iterations per solve, the kernel's warps ran "
          f"{int(lanes_e.lane_iters) / B_CHECK:.1f}, the lockstep loop "
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

    # 6. The main path, through the user-facing entry points.
    def solve():
        return robot.ik_batch(cfg, tr, tt, x0, validate_seeds=False)

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
    lane_iters = int(res.lane_iters)
    print(f"main path @B={B_MAIN}: success {success:.6f}, "
          f"{B_MAIN / main_s:.0f} solves/s kernel path (median of {runs}, "
          f"{main_s * 1e3:.2f} ms/batch), {B_MAIN / (plain_ms / 1e3):.0f} "
          f"solves/s plain path, {lane_iters / B_MAIN:.1f} lane-iters/solve, "
          f"FK err {fk_main:.3g}, launches {launches}", flush=True)
    one_round = res

    # 7. Quality at full width through the facade, then kernel against
    # plain on the same inputs.
    qcfg = SolverConfig.create("quality", **QUALITY)
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
    again = robot.ik_batch(ucfg, tr, tt, x0, validate_seeds=False)
    check(torch.equal(again.x, ures.x) and torch.equal(again.found, ures.found)
          and torch.equal(again.cost, ures.cost),
          "unlimited rounds are not bitwise repeatable")
    print(f"unlimited rounds @B={B_MAIN} (cap 4): {u_launches} launches in "
          f"one solve, found {int(ures.found.sum())} (one round "
          f"{int(f1.sum())}), round-1 results bitwise kept, repeat bitwise "
          f"identical, {u_s * 1e3:.2f} ms, "
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
    shifted = option_case("restart_offset=64", cfg, restart_offset=64)
    streamed = option_case("lane0_stream", cfg, lane0_stream=True)
    check(not torch.equal(shifted.x, base.x)
          and not torch.equal(streamed.x, base.x),
          "restart_offset or lane0_stream left the solve unchanged")
    print(f"option cases @B={B_OPT}: weights (differs from unweighted), S = "
          f"3, 12, 64, Quality (48, 16), Quality (12, 4) with and without "
          f"cap 1 (equal found masks), restart_offset=64, lane0_stream: "
          f"uncontracted kernel bitwise equal to plain in every lane",
          flush=True)

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
        ms = event_ms(lambda: each(exp_warp_probe.run_kernel, cases), 20)
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
    wp["fill"]["library_ms"] = event_ms(
        lambda: each(exp_warp_probe.library_case, lib_cases), 20)
    print("warp_probe: " + "; ".join(
        f"{len(g['cases'])} {name} cases exact (|d| {g['max_abs_err']:g}), "
        f"{g['ms']:.4f} ms for the launches, plain {g['plain_ms']:.3f} ms"
        for name, g in wp.items())
        + f"; the fill cases as library calls {wp['fill']['library_ms']:.4f} "
        "ms", flush=True)

    # 10c. exp_bisect: each variant against plain, then its entry point.
    prob = exp_bisect.make_problem(robot.fk_batch, robot.spec, "cuda")
    bis_err, bis_needed, bis_plain_ms = 0.0, 0, 0.0
    for name, max_iters, group_stop in exp_bisect.VARIANTS:
        pl = []
        bis_plain_ms += 1e3 * timed(lambda: pl.append(
            exp_bisect.plain_variant_lanes(prob, max_iters, group_stop,
                                           track_active=True)), 1)
        bis_needed += int(pl[0].active_iters.sum())
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
          f"{bis_plain_ms:.0f} ms", flush=True)

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

    print(f"total wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    lm_src = "optik_tpu_torch/csrc/lm_kernel.cu"
    print(json.dumps({"kernels": [
        {"name": "lm_solve", "route": "cuda", "source": lm_src,
         "replaces": "optik_tpu/ops/pallas/lm_kernel.py:303",
         "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
         "plain_ms": plain_ms, "bound_ms": lm_bound_ms,
         "bound_by": lm_bound_by, "library_ms": None,
         "quality_ms": quality_ms, "quality_plain_ms": quality_plain_ms,
         "quality_launches": q_launches, "unlimited_launches": u_launches,
         "registers": registers},
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
         "bound_by": bis_bound_by, "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
