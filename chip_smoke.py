#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a line; any failed check exits non-zero):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. the LM kernel's build from optik_tpu_torch/csrc/lm_kernel.cu (nvcc at
     first use) and its ptxas register/spill report for 7 DoF;
  3. the kernel against its plain torch version (both in kernel math mode,
     on the same uploaded seed table) at B=4096 with the main config: the
     uncontracted build (--fmad=false) is bitwise equal to it lane by lane;
     the solver's build differs only at the rounding level, so found masks
     differ on at most 0.1% of poses, every found cost <= tol_f, FK of every
     found x is within 2e-3 of its target, and shared winners reach the
     same pose within 4e-3;
  4. bitwise determinism: a repeat solve, and the first 1024 poses solved
     alone, give identical x, found and cost;
  5. the kernel's and the plain version's times at the main shape;
  6. the main path, Robot.from_urdf_file -> fk_batch -> ik_batch in Speed
     mode on the Panda at B=131,072 (64 restarts, 8 lanes, 32 iterations,
     tol_f 1e-6, f32): the launch counter rises, success >= 0.99, every
     found cost <= tol_f, FK of found x within 2e-3; solves/s.
Then one JSON line per kernel and, last, the result line.  Without a card,
or run from a directory that holds no checkout, it exits 2 and prints no
result.
"""

import json
import pathlib
import re
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
B_CHECK = 4096
B_MAIN = 131072
MAIN = dict(max_restarts=64, seed_batch=8, max_iters=32, tol_f=1e-6)
FK_TOL = 2e-3         # cost <= 1e-6 is a pose residual of ~1e-3
MASK_DIFF_FRAC = 1e-3  # marginal poses (cost within ~1e-7 of tol_f)


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


def ptxas_summary(report: str, dof: int) -> str:
    """'N registers, S spill stores, L spill loads' for the DoF's kernel."""
    m = re.search(
        rf"lm_solve_kernelILi{dof}E.*?\n.*?(\d+) bytes stack frame, "
        rf"(\d+) bytes spill stores, (\d+) bytes spill loads\n"
        rf".*?Used (\d+) registers", report, re.S)
    check(m is not None, f"no ptxas report for the {dof}-DoF kernel")
    stack, st, ld, regs = m.groups()
    return (f"{regs} registers, {stack} bytes stack, {st} bytes spill "
            f"stores, {ld} bytes spill loads")


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


def main() -> int:
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
    from optik_tpu_torch.models import asset_path
    from optik_tpu_torch.ops.cuda import lm_kernel

    # 1. The card.
    card = card_line()
    print(card, flush=True)
    device_name = torch.cuda.get_device_name(0)

    # 2. Build: the solver's library and the uncontracted one (--fmad=false)
    # whose results must be bitwise equal to the plain version.
    t0 = time.perf_counter()
    _, info = lm_kernel.load_library()
    _, info_exact = lm_kernel.load_library(fmad=False)
    regs7 = ptxas_summary(info.ptxas, 7)
    print(f"build: nvcc {info.seconds:.2f} s + {info_exact.seconds:.2f} s "
          f"(uncontracted), cached={info.cached}, total "
          f"{time.perf_counter() - t0:.2f} s; 7-DoF kernel: {regs7}",
          flush=True)

    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", device="cuda")
    cfg = SolverConfig(**MAIN)
    plan = lm_kernel.KernelPlan(robot.spec, cfg)

    # 3. Kernel against its plain version at B_CHECK, same inputs and the
    # same uploaded seed table.
    tr, tt, x0 = problem(robot, B_CHECK, seed=1)
    lanes_p = lm_kernel.solve_plain(plan, tr, tt, x0)
    lanes_e = lm_kernel.solve_kernel(plan, tr, tt, x0, fmad=False)
    torch.cuda.synchronize()
    for name in ("x", "f", "success", "restart_index", "succ_iters"):
        check(torch.equal(getattr(lanes_e, name), getattr(lanes_p, name)),
              f"uncontracted kernel differs from plain in lane {name}")
    print(f"uncontracted kernel vs plain @B={B_CHECK}: every lane's x, f, "
          f"success, restart index and iterations bitwise equal", flush=True)

    k = lm_kernel.select(plan, lm_kernel.solve_kernel(plan, tr, tt, x0), x0)
    p = lm_kernel.select(plan, lanes_p, x0)
    torch.cuda.synchronize()
    n_diff = int((k.found != p.found).sum())
    check(n_diff <= MASK_DIFF_FRAC * B_CHECK,
          f"found masks differ on {n_diff} of {B_CHECK} poses")
    fk_k = check_solutions(robot, k, tr, tt, cfg.tol_f, "kernel")
    fk_p = check_solutions(robot, p, tr, tt, cfg.tol_f, "plain")
    # Where both picked the same restart, both reached the same pose; x
    # itself may drift along the arm's self-motion (7 joints, 6 pose
    # constraints) once contraction-level differences part the paths.
    same = k.found & p.found & (k.sel_key == p.sel_key)
    rk, tk = robot.fk_batch(k.x[same])
    rp, tp = robot.fk_batch(p.x[same])
    max_abs_err = max(float((rk - rp).abs().max()),
                      float((tk - tp).abs().max()))
    check(max_abs_err <= 2 * FK_TOL,
          f"kernel and plain poses differ by {max_abs_err} on a shared "
          f"winner")
    x_drift = float((k.x[same] - p.x[same]).abs().max())
    print(f"kernel vs plain @B={B_CHECK}: found {int(k.found.sum())} / "
          f"{int(p.found.sum())}, mask differs on {n_diff} (limit "
          f"{int(MASK_DIFF_FRAC * B_CHECK)}), same winner on "
          f"{int(same.sum())}, pose |d| {max_abs_err:.3g} (limit "
          f"{2 * FK_TOL}), x drift {x_drift:.3g}, FK err {fk_k:.3g} / "
          f"{fk_p:.3g} (limit {FK_TOL})", flush=True)

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

    # 5. Times at the main shape (comparison launches, not the main path).
    tr, tt, x0 = problem(robot, B_MAIN, seed=2)
    lm_kernel.solve_kernel(plan, tr, tt, x0)  # warm
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        lm_kernel.solve_kernel(plan, tr, tt, x0)
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end) / reps
    plain_ms = 1e3 * timed(lambda: lm_kernel.solve_plain(plan, tr, tt, x0),
                           1)
    print(f"times @B={B_MAIN}: kernel {kernel_ms:.3f} ms (CUDA events, mean "
          f"of {reps}), plain {plain_ms:.1f} ms (host clock, 1 run)",
          flush=True)

    # 6. The main path, through the user-facing entry points.
    def solve():
        return robot.ik_batch(cfg, tr, tt, x0, validate_seeds=False)

    solve()  # warm: solver build and seed-table upload
    lm_kernel.LAUNCHES = 0
    runs = 5
    results = []

    def run_once():
        results.append(solve())

    main_s = timed(run_once, runs)
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

    print(json.dumps({"kernels": [{
        "name": "lm_solve",
        "route": "cuda",
        "source": "optik_tpu_torch/csrc/lm_kernel.cu",
        "replaces": "optik_tpu/ops/pallas/lm_kernel.py:303",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
