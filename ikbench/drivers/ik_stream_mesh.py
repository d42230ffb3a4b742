"""Generic driver: the IK stream of ``ik_stream`` on a (data, seed) mesh of
cards, through ``optik_tpu_torch.parallel.mesh.build_seed_sharded_solver``.

Traffic parameters: those of ``ik_stream`` (``batch`` is the whole
batch of one call, split over the data axis), and ``mesh``: ``{"data":
d, "seed": s}``, one rank per card, ``d * s`` cards.

This process is rank 0; it starts ranks 1 .. d*s - 1 (``spawn``), each on
its own card, in one NCCL world on a free localhost port (gloo and the CPU
in the rehearsals).  Every rank makes the same inputs from the seed (the
same generator on every card) and runs the same calls; the stream stops
where rank 0's clock says, a flag broadcast after each group of calls
and read ``lead_groups`` groups later (the traffic's parameter), so that
the cards stay fed while a host stands still; the window closes once all
that was sent has finished.  Each call returns
the whole batch's answers on every rank; rank 0 keeps them, and after the
window judges a sample against the reference's seed-sharded schedule
(``reference/lm.py``, ``seed_ranks = s``), which covers ``Mesh.merge``:
each pose's winner over the seed group and the assembly over the data
group.

A traced run traces the same segment on every rank; the record keeps the
trace of the rank whose device time per call is largest, and the cards'
mean device-busy time.
"""

from __future__ import annotations

import collections
import multiprocessing
import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from .. import harness, trace
from . import common, ik_stream

# Seconds a collective may wait for the other ranks.
COLLECTIVE_S = 300.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world(ctx) -> int:
    m = ctx.traffic["mesh"]
    return int(m["data"]) * int(m["seed"])


def _rank(rank: int, port: int, ctx) -> Optional[dict]:
    """One rank's run; rank 0 returns the record, the others None."""
    import datetime

    from optik_tpu_torch.parallel import distributed, mesh as mesh_mod

    world = _world(ctx)
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    cpu = ctx.device == "cpu"
    device = torch.device("cpu" if cpu else f"cuda:{rank}")
    if not cpu:
        torch.cuda.set_device(device)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo" if cpu else "nccl", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    try:
        return _run_rank(rank, ctx, device, distributed, mesh_mod)
    finally:
        dist.destroy_process_group()


def _flag(elapsed: float, seconds: float, device) -> torch.Tensor:
    """Rank 0's verdict, is the time up, on every rank's card; nothing
    waits for it."""
    flag = torch.full((1,), int(elapsed >= seconds), dtype=torch.int32,
                      device=device)
    dist.broadcast(flag, src=0)
    return flag


def window(stream, seconds: float, lead: int, device) -> dict:
    """Groups of calls queued without a wait, each followed by rank 0's
    flag; every rank reads a group's flag ``lead`` groups later, so the
    cards have that much work queued while a host stands still.  Once a
    flag says the time is up nothing more is sent; the window closes when
    every call sent has finished, and counts them all."""
    acc, work, spans, k = stream.zero(), stream.zero(), [], 0
    flags = collections.deque()
    start = time.perf_counter()
    while True:
        acc, work = stream.issue(k, acc, work, spans)
        k += stream.every
        flags.append(_flag(time.perf_counter() - start, seconds, device))
        if len(flags) > lead and flags.popleft().item():
            break
    found, lane_iters = int(acc), int(work)
    common.sync(device)
    end = time.perf_counter()
    return {"window_s": end - start, "batches": k, "found": found,
            "lane_iters": lane_iters, "call_spans": spans}


def _run_rank(rank, ctx, device, distributed, mesh_mod):
    t = ctx.traffic
    chain = common.chain_of(ctx)
    mesh = distributed.pod_mesh(seed_per_host=int(t["mesh"]["seed"]))
    robot = common.robot_of(ctx, device)
    cfg = common.solver_of(ctx)
    harness.apply_patch(ctx)
    solve = mesh_mod.build_seed_sharded_solver(robot, cfg, mesh)
    pool = ik_stream.make_pool(ctx, chain, device)
    stream = ik_stream.Stream(lambda batch: solve(*batch), pool,
                              t["fetch_every"], device)
    stream.warm()
    # The flag's collective too: the window's first one connects nothing.
    _flag(0.0, 1.0, device).item()
    dist.barrier()
    setup_s = time.perf_counter() - ctx.t0
    win = window(stream, ctx.seconds, int(t["lead_groups"]), device)
    peak = common.memory_peak(device)
    summary = None
    if ctx.trace:
        summary = trace.run_traced(
            lambda: stream.segment(int(t["trace_batches"])))
    mine = {"rank": rank, "peak": peak, "trace": summary,
            "forbidden": harness.forbidden_modules()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank != 0:
        return None
    b = int(t["batch"])
    common.note("window", batches=win["batches"], window_s=win["window_s"],
                found=win["found"], setup_s=setup_s,
                program_lane_iters_per_solve=win["lane_iters"]
                / (win["batches"] * b),
                peaks=[r["peak"] for r in every])
    bad = sorted({m for r in every for m in r["forbidden"]})
    if bad:
        raise RuntimeError(f"ranks of the run hold {bad}")
    inputs, answers = ik_stream.sample(ctx, pool, stream.kept, device)
    del stream, pool, robot, solve
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, diag = ik_stream.judge(ctx, chain, inputs, answers,
                                    int(t["mesh"]["seed"]))
    if ctx.trace:
        traces = [r["trace"] for r in every]
        summary = max(traces, key=lambda s: sum(s["device_us"].values())
                      / max(s["calls"], 1))
        busy = sum(s["busy_us"] for s in traces) / len(traces)
        summary = dict(summary, busy_us_cards=busy)
    return ik_stream.record(ctx, setup_s, win, b, numbers, diag,
                            max(r["peak"] for r in every),
                            common.device_name(device), len(every), summary)


def run(ctx) -> dict:
    world = _world(ctx)
    port = free_port()
    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=_rank, args=(r, port, ctx), daemon=True)
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        rec = _rank(0, port, ctx)
        for p in procs:
            p.join(timeout=COLLECTIVE_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"a rank of the mesh exited with {failed}")
    return rec


# The control runs on one card: it needs no mesh, only the seed split.
control = ik_stream.control
