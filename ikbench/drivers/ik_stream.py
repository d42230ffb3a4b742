"""Generic driver: a stream of IK batches, pipelined.

Traffic parameters (``traffic/<mix>.json``, ``"kind": "ik_stream"``):

* ``batch``: poses per call; ``pool``: distinct batches made in set-up
  (targets the reference's FK of uniform configurations, seeds uniform,
  from the seed's device generator); the window chains them in turn;
* ``fetch_every``: calls between fetches: every call's ``found_count`` is
  added on the device, and the sum is fetched once per group;
* ``check_sample``: answers the check judges, drawn from the seed among
  the last answer of every pool batch;
* ``trace_batches``: calls in the traced segment of a ``--trace 1`` run.

The window drives ``Robot.ik_batch(cfg, tgt_r, tgt_t, x0,
validate_seeds=False, rescue_overflow=False)``.  It ends at the first
fetch at or after ``--seconds``; its rate is every pose of every call
over the time from its start to that fetch.  ``attempted`` is those
poses, ``failed`` those not found plus sampled answers found but rejected
by the check.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from .. import harness, trace
from ..reference import check
from . import common


class Stream:
    """Calls chained over a pool of batches, one fetch per group."""

    def __init__(self, solve, pool, fetch_every: int, device):
        self.solve, self.pool, self.every = solve, pool, int(fetch_every)
        self.device = device
        self.kept = [None] * len(pool)

    def zero(self):
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def _call(self, k: int):
        i = k % len(self.pool)
        with record_function("ikbench.call"):
            t0 = time.perf_counter()
            res = self.solve(self.pool[i])
            t1 = time.perf_counter()
        self.kept[i] = res
        return res, t1 - t0

    def issue(self, k: int, acc, work, spans=None):
        """Calls ``k .. k + every - 1`` queued, their counts added on the
        device; nothing waits."""
        for j in range(self.every):
            res, span = self._call(k + j)
            acc = acc + res.found_count
            work = work + res.lane_iters
            if spans is not None:
                spans.append(span)
        return acc, work

    def _group(self, k: int, acc, work, spans=None):
        acc, work = self.issue(k, acc, work, spans)
        with record_function("ikbench.fetch"):
            found = int(acc)
        return acc, work, found

    def warm(self) -> None:
        """Every batch once, then one group: whatever the window runs has
        run."""
        acc = self.zero()
        for k in range(len(self.pool)):
            acc = acc + self._call(k)[0].found_count
        int(acc)
        self._group(0, self.zero(), self.zero())

    def window(self, seconds: float) -> dict:
        """Groups until the first fetch at or after ``seconds``."""
        acc, work, spans, k = self.zero(), self.zero(), [], 0
        start = time.perf_counter()
        while True:
            acc, work, found = self._group(k, acc, work, spans)
            k += self.every
            end = time.perf_counter()
            if end - start >= seconds:
                break
        return {"window_s": end - start, "batches": k, "found": found,
                "lane_iters": int(work), "call_spans": spans}

    def segment(self, calls: int) -> None:
        k = 0
        while k < calls:
            self._group(k, self.zero(), self.zero())
            k += self.every


def make_pool(ctx, chain, device):
    g = common.generator(ctx.seed, device)
    return [common.ik_inputs(chain, g, int(ctx.traffic["batch"]), device)
            for _ in range(int(ctx.traffic["pool"]))]


def sample(ctx, pool, kept, device):
    """The sampled inputs and, with ``kept``, answers."""
    b = pool[0][0].shape[0]
    si, ri = common.sample_rows(ctx.seed, len(pool), b,
                                int(ctx.traffic["check_sample"]))
    inputs = [common.gather([p[j] for p in pool], si, ri, device)
              for j in range(3)]
    if kept is None:
        return inputs, None
    answers = [common.gather([getattr(r, f) for r in kept], si, ri, device)
               for f in ("found", "x", "cost")]
    return inputs, answers


def seed_ranks(ctx) -> int:
    return int(ctx.traffic.get("mesh", {}).get("seed", 1))


def control(ctx, device):
    """The check's numbers for the control in the program's place, on the
    inputs and sample a run of this seed makes."""
    chain = common.chain_of(ctx)
    inputs, _ = sample(ctx, make_pool(ctx, chain, device), None, device)
    answers = check.ik_control(chain, ctx.config["solver"], inputs,
                               seed_ranks(ctx))
    return judge(ctx, chain, inputs, answers, seed_ranks(ctx))


def judge(ctx, chain, inputs, answers, seed_ranks: int = 1):
    t0 = time.perf_counter()
    numbers, diag = check.ik_numbers(chain, ctx.config["solver"], inputs,
                                     answers, seed_ranks)
    common.note("check", seconds=time.perf_counter() - t0, **diag)
    return numbers, diag


def record(ctx, setup_s, win, b, numbers, diag, peak, name, chips,
           summary) -> dict:
    attempted = win["batches"] * b
    return {
        "setup_s": setup_s, "window_s": win["window_s"],
        "batches": win["batches"], "work": attempted,
        "call_spans": win["call_spans"], "attempted": attempted,
        "failed": attempted - win["found"] + diag["rejected_found"],
        "memory_peak_bytes": peak, "device_name": name, "chips": chips,
        "check": numbers, "trace": summary, "batch": b,
        "config": ctx.config, "traffic": ctx.traffic, "frozen": ctx.frozen,
    }


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
    summary = None
    if ctx.trace:
        summary = trace.run_traced(
            lambda: stream.segment(int(t["trace_batches"])))
    inputs, answers = sample(ctx, pool, stream.kept, device)
    del stream, pool, robot
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, diag = judge(ctx, chain, inputs, answers)
    return record(ctx, setup_s, win, b, numbers, diag, peak,
                  common.device_name(device), 1, summary)
