"""The port's telemetry (``optik_tpu_torch/telemetry.py``) on the CPU.

  * off: nothing is recorded, the off path allocates nothing and enters no
    ``record_function``, and ``Robot.ik_batch`` returns bitwise what it
    returns while recording;
  * on, on the plain path: the span tree (one root per call, its children's
    parents and roots), self times, and the ring of raw spans with its
    ``dropped`` count; spans from several threads;
  * the probe's reduction (``lm_kernel.probe_row``, ``probe_counts``) on a
    hand-made probe against ``schedule_profile`` and ``exec_slots``, and
    the card counters summed from it; on a hand-made probe of poses on
    pairs of warps, the pair's wait and the lanes' busy iterations;
  * a 2-rank gloo mesh: ``optik.mesh.merge`` and ``optik.mesh.total`` once
    per call on each rank.

The kernel path's counters and the card's clock are in
``tests/test_torch_cuda.py``.
"""

import contextlib
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from optik_tpu_torch import Robot, SolverConfig, telemetry
from optik_tpu_torch.models import asset_path
from optik_tpu_torch.ops.cuda import lm_kernel
from optik_tpu_torch.parallel import launch

CFG = SolverConfig(max_restarts=16, seed_batch=4, max_iters=8, tol_f=1e-6)
CALL_SPANS = {"optik.ik_batch", "optik.ik.layout", "optik.ik.select"}


@pytest.fixture(scope="module")
def robot():
    return Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                "panda_hand_tcp", dtype=torch.float32,
                                device="cpu")


@pytest.fixture(scope="module")
def batch(robot):
    rng = np.random.default_rng(7)
    lo, hi = robot.joint_limits()
    r, t = robot.fk_batch(rng.uniform(lo, hi, (6, 7)))
    return r, t, rng.uniform(lo, hi, (6, 7))


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _empty(out):
    return (not out["spans"] and not out["raw"] and not out["calls"]
            and out["dropped"] == 0 and not out["devices"]
            and not any(out["counters"].values()))


def test_off_records_nothing_and_results_are_bitwise(robot, batch):
    off = robot.ik_batch(CFG, *batch)
    assert not telemetry.enabled()
    assert _empty(telemetry.export())
    with telemetry.recording():
        assert telemetry.enabled()
        on = robot.ik_batch(CFG, *batch)
    assert not telemetry.enabled()
    for field in ("found", "x", "cost", "iters", "lane_iters",
                  "found_count"):
        a, b = getattr(off, field), getattr(on, field)
        assert torch.equal(a, b), field
    assert telemetry.export()["calls"] == {"optik.ik_batch": 1}


def test_off_path_allocates_nothing_and_annotates_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while off")

    monkeypatch.setattr(telemetry, "record_function", refuse)
    assert telemetry.span("a") is telemetry.span("b")
    # The LM launch's probe is what it always was: no words for the lanes'
    # busy iterations, which only a Quality launch on pose groups gets while
    # recording (one a pose and warp of its group; the restart queue of
    # uncapped Quality reads them from its per-pose iterations).
    spec = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                "panda_hand_tcp", device="cpu").spec
    plans = [lm_kernel.KernelPlan(spec, CFG.replace(
        solution_mode="quality", max_restarts=r, seed_batch=s,
        quality_max_successes=cap))
        for r, s, cap in ((256, 64, 3), (32, 8, 0), (256, 64, 0))]
    speed = lm_kernel.KernelPlan(spec, CFG)
    names = [f"optik.n{i}" for i in range(8)]

    def off_path():
        for name in names:
            with telemetry.span(name):
                telemetry.count(name)
        return [lm_kernel.lane_busy_words(p, 4096) for p in plans]

    off_path()                      # warm every code path once
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            assert off_path() == [0, 0, 0]
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [d for d in after.compare_to(before, "filename")
            if d.traceback[0].filename in (telemetry.__file__,
                                            contextlib.__file__,
                                            lm_kernel.__file__)]
    assert sum(d.size_diff for d in here) <= 0, here
    assert _empty(telemetry.export())
    with telemetry.recording():
        assert [lm_kernel.lane_busy_words(p, 4096) for p in plans] == [
            2 * 4096, 0, 0]
        assert lm_kernel.lane_busy_words(speed, 4096) == 0
    assert lm_kernel.lane_busy_words(speed, 4096) == 0


def test_span_tree_self_times_and_one_root_per_call(robot, batch):
    with telemetry.recording():
        for _ in range(3):
            robot.ik_batch(CFG, *batch)
    out = telemetry.export()
    assert out["calls"] == {"optik.ik_batch": 3}
    assert set(out["spans"]) == CALL_SPANS
    assert all(s["count"] == 3 for s in out["spans"].values())
    raw = out["raw"]
    assert len(raw) == 9 and out["dropped"] == 0
    roots = {s["id"]: s for s in raw if s["parent"] is None}
    assert len(roots) == 3
    assert {s["name"] for s in roots.values()} == {"optik.ik_batch"}
    kids = {}
    for s in raw:
        if s["parent"] is None:
            assert s["root"] == s["id"]
            continue
        up = roots[s["parent"]]
        assert s["root"] == up["id"]
        assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= up["end_ns"]
        kids.setdefault(up["id"], []).append(s)
    for rid, children in kids.items():
        assert sorted(c["name"] for c in children) == [
            "optik.ik.layout", "optik.ik.select"]
        assert children[0]["end_ns"] <= children[1]["start_ns"]
    # Self time: the root less what its children cover; a leaf is its own.
    def total(name):
        return sum(s["end_ns"] - s["start_ns"] for s in raw
                   if s["name"] == name)

    for name in CALL_SPANS:
        assert out["spans"][name]["total_ns"] == total(name)
    leaf = total("optik.ik.layout") + total("optik.ik.select")
    root = out["spans"]["optik.ik_batch"]
    assert root["self_ns"] == root["total_ns"] - leaf
    assert out["spans"]["optik.ik.layout"]["self_ns"] == \
        total("optik.ik.layout")
    # Recording again adds to what is there; reset forgets it.
    with telemetry.recording():
        robot.ik_batch(CFG, *batch)
    assert telemetry.export()["calls"] == {"optik.ik_batch": 4}
    telemetry.reset()
    assert _empty(telemetry.export())


def test_raw_ring_drops_the_oldest_and_counts_them(robot, batch,
                                                   monkeypatch):
    monkeypatch.setattr(telemetry, "RAW_SPANS", 5)
    telemetry.reset()
    with telemetry.recording():
        for _ in range(3):
            robot.ik_batch(CFG, *batch)
    out = telemetry.export()
    assert out["dropped"] == 4 and len(out["raw"]) == 5
    # The ring holds spans in the order they closed: the newest five.
    ends = [s["end_ns"] for s in out["raw"]]
    assert ends == sorted(ends)
    assert [s["name"] for s in out["raw"]] == [
        "optik.ik.select", "optik.ik_batch", "optik.ik.layout",
        "optik.ik.select", "optik.ik_batch"]
    # The aggregates count every span, kept or dropped.
    assert sum(s["count"] for s in out["spans"].values()) == 9
    assert out["calls"] == {"optik.ik_batch": 3}


def test_spans_from_several_threads_nest_per_thread():
    n_threads, n = 8, 300
    errors = []

    def work(k):
        try:
            for _ in range(n):
                with telemetry.span(f"t{k}.outer"):
                    with telemetry.span(f"t{k}.inner"):
                        telemetry.count("hits")
        except BaseException as e:   # reported below, in the main thread
            errors.append(e)

    with telemetry.recording():
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    out = telemetry.export()
    assert out["counters"]["hits"] == n_threads * n
    for k in range(n_threads):
        assert out["spans"][f"t{k}.outer"]["count"] == n
        assert out["calls"][f"t{k}.outer"] == n
        assert f"t{k}.inner" not in out["calls"]
    by_id = {s["id"]: s for s in out["raw"]}
    for s in out["raw"]:
        if s["name"].endswith(".inner") and s["parent"] in by_id:
            assert by_id[s["parent"]]["name"] == \
                s["name"].replace("inner", "outer")


def _hand_probe():
    """A launch of 4 warps over B = 6 poses, S = 4, A = 7: per warp
    (start, last draw, exit) in ns and loop trips; the groups' iterations
    times S."""
    times = torch.tensor([[1_000, 5_000, 9_000],
                          [1_200, 7_500, 12_000],
                          [1_100, 1_100, 4_000],
                          [1_050, 6_000, 10_500]], dtype=torch.int64)
    trips = torch.tensor([30, 41, 9, 35], dtype=torch.int32)
    pose_iters = torch.tensor([12, 40, 28, 36, 20, 24], dtype=torch.int32) * 4
    b, s, a = 6, 4, 7
    return lm_kernel.LaneResult(
        x=torch.zeros(b, s, a), f=torch.zeros(b, s),
        success=torch.zeros(b, s, dtype=torch.bool),
        restart_index=torch.zeros(b, s, dtype=torch.int32),
        succ_iters=torch.zeros(b, s, dtype=torch.int32),
        lane_iters=pose_iters.sum(dtype=torch.int64),
        warp_trips=trips, warp_times=times, pose_iters=pose_iters[:, None])


def test_probe_reduction_matches_schedule_profile_and_exec_slots():
    lanes = _hand_probe()
    row = lm_kernel.probe_row(lanes)
    assert row.dtype == torch.int64
    assert row.tolist() == [4 * 160, 30 + 41 + 9 + 35, 1_000, 7_500, 12_000,
                            0, 0, 0, 0]
    ran, slots, span, tail, wait, busy = lm_kernel.probe_counts(
        row.tolist())
    assert ran == 4 * 160
    assert slots == 32 * (30 + 41 + 9 + 35)
    assert span == 12_000 - 1_000 and tail == 12_000 - 7_500
    # One warp per pose: no pair waits; a Speed launch records no busy.
    assert wait == 0 and busy == 0
    assert lm_kernel.exec_slots(lanes) == slots
    prof = lm_kernel.schedule_profile(lanes)
    assert prof["span_ms"] == span / 1e6 and prof["tail_ms"] == tail / 1e6
    assert prof["tail_share"] == tail / span
    assert prof["occupied_share"] == ran / slots
    assert prof["executed_slots_per_solve"] == slots / 6
    assert prof["held_slots_per_solve"] == slots / 6
    assert prof["exit_ms"][-1] == span / 1e6
    assert prof["pair_wait_share"] == 0 and prof["lane_busy_share"] is None


def _pair_probe():
    """A Quality launch of 2 pairs of warps over B = 3 poses of S = 64
    lanes (two warps each): per pose and warp its iterations times S, and
    its lanes' busy iterations."""
    s = 64
    iters = torch.tensor([[150, 190], [196, 120], [77, 77]],
                         dtype=torch.int32)
    busy = torch.tensor([[32 * 140, 32 * 180], [32 * 190, 32 * 101],
                         [32 * 70, 32 * 77]], dtype=torch.int32)
    times = torch.tensor([[1_000, 9_000, 20_000], [1_000, 9_000, 20_000],
                          [1_100, 8_000, 19_000], [1_100, 8_000, 19_000]],
                         dtype=torch.int64)
    # Each warp ran the iterations of its poses: pair 0 poses 0 and 2,
    # pair 1 pose 1.
    trips = torch.tensor([150 + 77, 190 + 77, 196, 120], dtype=torch.int32)
    b, a = 3, 7
    return lm_kernel.LaneResult(
        x=torch.zeros(b, s, a), f=torch.zeros(b, s),
        success=torch.zeros(b, s, dtype=torch.bool),
        restart_index=torch.zeros(b, s, dtype=torch.int32),
        succ_iters=torch.zeros(b, s, dtype=torch.int32),
        lane_iters=(iters.amax(dim=1) * s).sum(dtype=torch.int64),
        warp_trips=trips, warp_times=times, pose_iters=iters * s,
        lane_busy=busy)


def test_pair_wait_and_lane_busy_from_a_probe_of_pairs(monkeypatch):
    """The earlier warp of a pair idles 32 slots an iteration until the
    later one is through; with those slots counted, the occupied share of
    the held slots is at most 1 and the lanes' busy share below it."""
    lanes = _pair_probe()
    row = lm_kernel.probe_row(lanes)
    ran, slots, span, tail, wait, busy = lm_kernel.probe_counts(
        row.tolist())
    assert ran == 64 * (190 + 196 + 77)
    assert slots == 32 * (150 + 190 + 77 + 77 + 196 + 120)
    assert wait == 32 * (40 + 76 + 0)
    assert busy == int(lanes.lane_busy.sum())
    # The pair's warps held 64 slots an iteration of the later warp.
    assert slots + wait == 64 * (190 + 196 + 77)
    assert lm_kernel.exec_slots(lanes) == slots + wait
    assert ran / slots > 1           # over the warps' own trips alone
    prof = lm_kernel.schedule_profile(lanes)
    assert prof["occupied_share"] == ran / (slots + wait) == 1
    assert prof["pair_wait_share"] == wait / (slots + wait)
    assert prof["lane_busy_share"] == busy / (slots + wait)
    assert prof["executed_slots_per_solve"] == slots / 3
    assert prof["held_slots_per_solve"] == (slots + wait) / 3
    assert 0 < prof["lane_busy_share"] < prof["occupied_share"]
    # The card's counters sum the rows of every launch.
    monkeypatch.setattr(telemetry, "card_clock",
                        lambda lib, device: (0, 0))
    cpu = torch.device("cpu")
    with telemetry.recording():
        for _ in range(2):
            lm_kernel.probe_row(lanes, out=telemetry.launch_row(cpu, None))
    c = telemetry.export()["counters"]
    assert c["lm.pair_wait_slots"] == 2 * wait
    assert c["lm.lane_busy_iters"] == 2 * busy
    assert c["lm.slots"] == 2 * slots and c["lm.lane_iters"] == 2 * ran


def _queue_probe():
    """A restart-queue launch of 3 warps over B = 4 poses, S = 8, R = 16:
    per pose the iterations its restarts ran (also the busy count, taken
    while recording), per warp its draws and pose switches."""
    iters = torch.tensor([[410], [388], [512], [260]], dtype=torch.int32)
    times = torch.tensor([[1_000, 8_000, 9_500], [1_010, 8_200, 9_000],
                          [1_020, 7_900, 9_900]], dtype=torch.int64)
    trips = torch.tensor([60, 58, 64], dtype=torch.int32)
    draws = torch.tensor([[22, 19], [21, 18], [21, 20]], dtype=torch.int32)
    b, s, a = 4, 8, 7
    return lm_kernel.LaneResult(
        x=torch.zeros(b, s, a), f=torch.zeros(b, s),
        success=torch.zeros(b, s, dtype=torch.bool),
        restart_index=torch.zeros(b, s, dtype=torch.int32),
        succ_iters=torch.zeros(b, s, dtype=torch.int32),
        lane_iters=iters.sum(dtype=torch.int64), warp_trips=trips,
        warp_times=times, pose_iters=iters, lane_busy=iters, draws=draws)


def test_restart_queue_probe_counts_its_draws(monkeypatch):
    """A restart-queue launch's row: no pair waits (no pose holds a pair
    of warps), the busy iterations the lane-iterations, and its draws and
    pose switches summed into ``lm.restart_draws`` and
    ``lm.pose_switch_draws``; a pose-group launch adds 0 to both."""
    lanes = _queue_probe()
    row = lm_kernel.probe_row(lanes)
    ran, slots, span, tail, wait, busy = lm_kernel.probe_counts(
        row.tolist())
    assert ran == busy == 410 + 388 + 512 + 260
    assert wait == 0 and slots == 32 * (60 + 58 + 64)
    assert span == 9_900 - 1_000 and tail == 9_900 - 8_200
    assert lm_kernel.draw_counts(row.tolist()) == (64, 57)
    prof = lm_kernel.schedule_profile(lanes)
    assert prof["lane_busy_share"] == prof["occupied_share"] == ran / slots
    monkeypatch.setattr(telemetry, "card_clock",
                        lambda lib, device: (0, 0))
    cpu = torch.device("cpu")
    telemetry.reset()
    with telemetry.recording():
        for ln in (lanes, _hand_probe(), lanes):
            lm_kernel.probe_row(ln, out=telemetry.launch_row(cpu, None))
    c = telemetry.export()["counters"]
    telemetry.reset()
    assert c["lm.restart_draws"] == 2 * 64
    assert c["lm.pose_switch_draws"] == 2 * 57
    assert c["lm.lane_busy_iters"] == 2 * ran


def test_probe_rows_sum_on_the_card_and_exits_take_the_host_clock(
        monkeypatch):
    lanes = _hand_probe()
    later = lanes._replace(warp_times=lanes.warp_times + 1_000_000)
    monkeypatch.setattr(telemetry, "LAUNCH_ROWS", 2)
    monkeypatch.setattr(telemetry, "card_clock",
                        lambda lib, device: (5_000_000, 700))
    cpu = torch.device("cpu")
    telemetry.reset()
    assert telemetry.launch_row(cpu, lib=None) is None      # off
    telemetry.count("lm.launches")
    with telemetry.recording():
        for ln in (lanes, later, lanes, later, lanes):
            lm_kernel.probe_row(ln, out=telemetry.launch_row(cpu, None))
    out = telemetry.export()
    c = out["counters"]
    # Five launches: the ring of two folded twice, one row still held.
    assert c["lm.lane_iters"] == 5 * 640
    assert c["lm.slots"] == 5 * 32 * 115
    assert c["lm.span_ns"] == 5 * 11_000 and c["lm.tail_ns"] == 5 * 4_500
    assert c["lm.pair_wait_slots"] == 0 and c["lm.lane_busy_iters"] == 0
    assert c["lm.launches"] == 0
    card = out["devices"]["cpu"]
    assert card["launches"] == 5 and card["rows_dropped"] == 3
    assert card["clock_error_ns"] == 700
    assert card["exit_ns"] == [5_000_000 + 1_012_000, 5_000_000 + 12_000]
    assert card["span_ns"] == [11_000, 11_000]
    assert card["tail_ns"] == [4_500, 4_500]


def _mesh_case():
    robot = Robot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=torch.float32,
                                 device="cpu")
    rng = np.random.default_rng(3)
    lo, hi = robot.joint_limits()
    r, t = robot.fk_batch(rng.uniform(lo, hi, (4, 7)))
    inputs = tuple(np.asarray(v, np.float32)
                   for v in (r, t, rng.uniform(lo, hi, (4, 7))))
    cfg = SolverConfig(max_restarts=8, seed_batch=4, max_iters=6,
                       tol_f=1e-6)
    return robot.spec, launch.Case("seed_sharded", cfg, 1, 2, inputs,
                                   repeat=3)


def test_mesh_merge_and_total_once_per_call_on_each_rank():
    spec, case = _mesh_case()
    ranks = launch.spawn(telemetry.recorded, 2, launch.solve, [case], spec,
                         "cpu", timeout=300)
    assert len(ranks) == 2
    found = []
    for results, out in ranks:
        assert out["calls"] == {"optik.mesh.solve": 3}
        for name in ("optik.mesh.merge", "optik.mesh.total",
                     "optik.ik.layout", "optik.ik.select"):
            assert out["spans"][name]["count"] == 3, name
        assert "optik.lm.launch" not in out["spans"]
        roots = {s["id"] for s in out["raw"] if s["parent"] is None}
        assert all(s["parent"] in roots for s in out["raw"]
                   if s["parent"] is not None)
        found.append(torch.stack([r.found for r in results[0]]))
    assert torch.equal(found[0], found[1])
