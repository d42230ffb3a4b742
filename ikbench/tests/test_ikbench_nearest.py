"""The Quality cell (``nearest_stream``) rehearsed on the CPU at a small
size: a sound run is correct and reads its per-layer metrics where the CPU
has them; the control and three faults planted under the timed path are not
correct."""

import time

import pytest
import torch

from ikbench import harness
from optik_tpu_torch import Robot

from .common import SEED

CELL = "panda7_quality.nearest-stream"
SMALL = {"batch": 16, "pool": 2, "fetch_every": 1, "check_sample": 16,
         "trace_batches": 1}


def _context(trace=False, patch=None, small=SMALL):
    return harness.context(CELL, SEED, 0.3, trace, "cpu",
                           time.perf_counter(), small, patch)


@pytest.fixture
def restore():
    saved = Robot.ik_batch
    yield
    Robot.ik_batch = saved


def test_sound_run_is_correct_and_keeps_the_telemetry():
    ctx = _context(trace=True)
    rec = harness.driver(ctx).run(ctx)
    out = harness.result(ctx, rec)
    assert out["correct"], out["check"]
    assert out["attempted"] == rec["work"] == rec["batches"] * SMALL["batch"]
    # The CPU runs the plain loop: no LM kernel, so no counters to read.
    assert rec["telemetry"]["calls"] == SMALL["trace_batches"]
    assert rec["telemetry"]["plain"]["counters"]["lm.slots"] == 0
    # Nor a peak for the CPU's rooflines.
    for name in ("lm_pair_wait_pct", "lm_lane_busy_pct",
                 "lm_tail_pct.quality", "lm_solve_roofline.quality",
                 "ik_mfu_pct.quality"):
        assert name not in out["metrics"], name
    assert "device_idle_pct.quality" in out["metrics"]
    assert out["metrics"]["host_ms_per_batch.quality"]["value"] > 0


def test_speed_pick_is_not_correct(restore):
    out = harness.run(_context(
        patch="ikbench.tests.faults_quality:speed_pick"))
    assert not out["correct"], out["check"]


# Half the budget moves roughly one pose in six to a farther success, so
# it is judged on 64 poses, where a sample with none of them is unlikely.
@pytest.mark.parametrize("fault, poses", [("half_budget", 64),
                                          ("lane_start_distance", 16)])
def test_planted_fault_is_not_correct(restore, fault, poses):
    out = harness.run(_context(
        patch=f"ikbench.tests.faults_quality:{fault}",
        small=dict(SMALL, batch=poses, check_sample=poses)))
    assert not out["correct"], out["check"]


def test_control_is_not_correct():
    ctx = _context()
    numbers, _ = harness.driver(ctx).control(ctx, torch.device("cpu"))
    limits = ctx.frozen["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers


def test_work_count_freezes_the_busy_iterations():
    """The Quality work count gives the lanes' busy iterations, which the
    answer needs, below the lockstep count the kernel holds slots for."""
    from ikbench.workcount import lane_iters_quality
    row = lane_iters_quality.count(CELL, SEED, 2, torch.device("cpu"))
    assert 0 < row["lane_iters_per_solve"] < row["held_iters_per_solve"]
    assert row["held_iters_per_solve"] <= 64 * 4 * 49
