"""The frozen work counts can be counted again from ``ikbench/`` alone."""

import pytest
import torch

from ikbench import harness
from ikbench.workcount import lane_iters, ops


@pytest.mark.parametrize("config", ["panda7", "mobile_panda11"])
def test_ops_recount_is_the_frozen_number(config):
    frozen = harness.load(harness.HERE / "configs" / f"{config}.json")
    assert ops.count(config) == frozen["fp32_ops_per_lane_iter"]


def test_lane_iters_counts_on_the_cpu():
    row = lane_iters.count("panda7.ik-stream", 3, 8, torch.device("cpu"))
    assert row["poses"] == 8 and row["found_share"] == 1.0
    # every pose takes at least its adopt iteration on all 8 lanes
    assert 8 <= row["lane_iters_per_solve"] <= 8 * 33 * 8
