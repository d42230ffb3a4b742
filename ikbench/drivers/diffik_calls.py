"""Generic driver: a closed loop of synced differential-IK calls.

Traffic parameters (``traffic/<mix>.json``, ``"kind": "diffik_calls"``):

* ``batch``: lanes per call; ``pool``: distinct input batches made in
  set-up from the seed's device generator, chained in turn: each lane's
  ``x0`` uniform in the joint limits, its command ``V_WE`` a uniformly
  random direction of linear speed ``v_lin`` (m/s) beside one of angular
  speed ``v_ang`` (rad/s); every joint's limit is the configuration's
  ``diffik.v_max``;
* ``check_sample``: lanes the check judges, drawn from the seed among the
  last answer of every pool batch;
* ``trace_calls``: calls in the traced segment of a ``--trace 1`` run.

One call at a time: ``Robot.diff_ik_batch(x0, V_WE, v_max,
rescue=config.diffik.rescue)``, then the fetch of its ``ok`` count; a
call's time runs from the call to that fetch.  The window ends at the
first call that ends at or after ``--seconds``.  ``attempted`` is the
lanes sent, ``failed`` those not ``ok`` plus sampled ``ok`` lanes the
check rejects.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import harness, trace
from ..reference import check
from . import common


def direction(g, n: int, device) -> torch.Tensor:
    """(n, 3) unit vectors, uniform on the sphere."""
    v = torch.randn((n, 3), generator=g, dtype=torch.float64, device=device)
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


def inputs(ctx, chain, g, device):
    t, b = ctx.traffic, int(ctx.traffic["batch"])
    x0 = common.uniform(chain, g, b, device)
    vel = torch.cat([t["v_lin"] * direction(g, b, device),
                     t["v_ang"] * direction(g, b, device)], dim=1)
    vmax = torch.full((b, chain.dof), float(ctx.config["diffik"]["v_max"]),
                      dtype=torch.float64, device=device)
    return tuple(v.float().contiguous() for v in (x0, vel, vmax))


def make_pool(ctx, chain, device):
    g = common.generator(ctx.seed, device)
    return [inputs(ctx, chain, g, device)
            for _ in range(int(ctx.traffic["pool"]))]


def sample(ctx, pool, kept, device):
    """The sampled inputs and, with ``kept``, answers."""
    si, ri = common.sample_rows(ctx.seed, len(pool), pool[0][0].shape[0],
                                int(ctx.traffic["check_sample"]))
    ins = [common.gather([p[j] for p in pool], si, ri, device)
           for j in range(3)]
    if kept is None:
        return ins, None
    return ins, [common.gather([o[j] for o in kept], si, ri, device)
                 for j in range(3)]


def control(ctx, device):
    """The check's numbers for the control in the program's place, on the
    inputs and sample a run of this seed makes."""
    chain = common.chain_of(ctx)
    ins, _ = sample(ctx, make_pool(ctx, chain, device), None, device)
    numbers, diag = check.diffik_numbers(chain, ins,
                                         check.diffik_control(chain, ins))
    common.note("check", **diag)
    return numbers, diag


def run(ctx) -> dict:
    device = torch.device(ctx.device)
    t = ctx.traffic
    chain = common.chain_of(ctx)
    marks = {"imported": time.perf_counter() - ctx.t0}
    robot = common.robot_of(ctx, device)
    rescue = bool(ctx.config["diffik"]["rescue"])
    harness.apply_patch(ctx)
    pool = make_pool(ctx, chain, device)
    common.sync(device)
    marks["inputs"] = time.perf_counter() - ctx.t0
    kept = [None] * len(pool)

    def call(k: int) -> int:
        i = k % len(pool)
        with record_function("ikbench.call"):
            out = robot.diff_ik_batch(*pool[i], rescue=rescue)
        kept[i] = out
        with record_function("ikbench.fetch"):
            return int(out[2].sum())

    for k in range(len(pool)):
        call(k)
    setup_s = time.perf_counter() - ctx.t0
    common.note("setup", warm=setup_s, **marks)

    spans, ok, k = [], 0, 0
    start = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        ok += call(k)
        end = time.perf_counter()
        spans.append(end - c0)
        k += 1
        if end - start >= ctx.seconds:
            break
    window_s = end - start
    peak = common.memory_peak(device)
    b = int(t["batch"])
    common.note("window", calls=k, window_s=window_s, ok=ok,
                setup_s=setup_s, call_ms_quartiles=[
                    1e3 * v for v in np.percentile(spans, [25, 50, 75])],
                calls_per_second=np.histogram(
                    np.cumsum(spans), bins=int(np.ceil(window_s)),
                    range=(0, np.ceil(window_s)))[0].tolist())
    summary = None
    if ctx.trace:
        def segment():
            for j in range(int(t["trace_calls"])):
                call(k + j)

        summary = trace.run_traced(segment)

    ins, answers = sample(ctx, pool, kept, device)
    del pool, kept, robot
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers, diag = check.diffik_numbers(chain, ins, answers)
    common.note("check", seconds=time.perf_counter() - t0, **diag)
    attempted = k * b
    return {
        "setup_s": setup_s, "window_s": window_s, "calls": k,
        "work": attempted, "call_spans": spans, "attempted": attempted,
        "failed": attempted - ok + diag["rejected_ok"],
        "memory_peak_bytes": peak, "device_name": common.device_name(device),
        "chips": 1, "check": numbers, "trace": summary, "batch": b,
        "config": ctx.config, "traffic": t, "frozen": ctx.frozen,
    }
