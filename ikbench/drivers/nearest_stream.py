"""Generic driver: a stream of Quality-mode IK batches, pipelined, judged
by the plain Quality reference.

Traffic parameters (``traffic/<mix>.json``, ``"kind": "nearest_stream"``)
and the window are ``ik_stream``'s: the same pool of batches (targets the
reference's FK of uniform configurations, seeds uniform), the same chained
calls of ``Robot.ik_batch(cfg, tgt_r, tgt_t, x0, validate_seeds=False,
rescue_overflow=False)``, one fetch of the summed ``found_count`` per
``fetch_every`` calls, the same sample and the same ``failed``.  The
configuration's solver is a Quality one: each answer is the success
nearest the caller's seed, and ``reference/quality.py`` judges it.

A ``--trace 1`` run also keeps the program's own telemetry
(``program_telemetry.segments``) after the profiled segment, as
``rec["telemetry"]``.
"""

from __future__ import annotations

import time

import torch

from .. import harness, program_telemetry, trace
from ..reference import quality
from . import common
from .ik_stream import Stream, make_pool, record, sample


def control(ctx, device):
    """The check's numbers for the control in the program's place, on the
    inputs and sample a run of this seed makes."""
    chain = common.chain_of(ctx)
    inputs, _ = sample(ctx, make_pool(ctx, chain, device), None, device)
    answers = quality.ik_control(chain, ctx.config["solver"], inputs)
    return judge(ctx, chain, inputs, answers)


def judge(ctx, chain, inputs, answers):
    t0 = time.perf_counter()
    numbers, diag = quality.ik_numbers(chain, ctx.config["solver"], inputs,
                                       answers)
    common.note("check", seconds=time.perf_counter() - t0, **diag)
    return numbers, diag


def run(ctx) -> dict:
    device = torch.device(ctx.device)
    t = ctx.traffic
    chain = common.chain_of(ctx)
    marks = {"imported": time.perf_counter() - ctx.t0}
    robot = common.robot_of(ctx, device)
    cfg = common.solver_of(ctx)
    harness.apply_patch(ctx)
    pool = make_pool(ctx, chain, device)
    common.sync(device)
    marks["inputs"] = time.perf_counter() - ctx.t0

    def solve(batch):
        return robot.ik_batch(cfg, *batch, validate_seeds=False,
                              rescue_overflow=False)

    stream = Stream(solve, pool, t["fetch_every"], device)
    stream.warm()
    setup_s = time.perf_counter() - ctx.t0
    common.note("setup", warm=setup_s, **marks)
    win = stream.window(ctx.seconds)
    peak = common.memory_peak(device)
    b = int(t["batch"])
    common.note("window", batches=win["batches"], window_s=win["window_s"],
                found=win["found"], setup_s=setup_s,
                program_lane_iters_per_solve=win["lane_iters"]
                / (win["batches"] * b))
    summary = inside = None
    if ctx.trace:
        n = int(t["trace_batches"])
        summary = trace.run_traced(lambda: stream.segment(n))
        inside = program_telemetry.segments(lambda: stream.segment(n), n)
        common.note("telemetry", **program_telemetry.digest(inside, win,
                                                            summary))
    inputs, answers = sample(ctx, pool, stream.kept, device)
    del stream, pool, robot
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, diag = judge(ctx, chain, inputs, answers)
    rec = record(ctx, setup_s, win, b, numbers, diag, peak,
                 common.device_name(device), 1, summary)
    rec["telemetry"] = inside
    return rec
