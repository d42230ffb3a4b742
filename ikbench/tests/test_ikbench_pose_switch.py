"""``lm_pose_switch_pct`` on hand-made records: the restart queue's pose
switches over its draws, and None where the program has no such counters
or its queue handed out nothing."""

import pytest

from ikbench import harness


def record(counters):
    return {"telemetry": None if counters is None else
            {"plain": {"counters": counters}}}


def read(rec):
    return harness.reader("lm_pose_switch_pct")(rec)


def test_share_of_draws_that_change_pose():
    rec = record({"lm.slots": 1_000, "lm.restart_draws": 4_096 * 256,
                  "lm.pose_switch_draws": 1_014_000})
    assert read(rec) == pytest.approx(100.0 * 1_014_000 / (4_096 * 256))


@pytest.mark.parametrize("counters", [
    None,                                           # no telemetry
    {"lm.slots": 10_000, "lm.lane_iters": 9_300},   # a program without them
    {"lm.slots": 10_000, "lm.restart_draws": 0,     # the pose groups
     "lm.pose_switch_draws": 0},
])
def test_none_where_nothing_was_drawn(counters):
    assert read(record(counters)) is None
