"""ik_mfu_pct (%): the whole IK call's share of the cards' FP32 peak: the
frozen FP32 operations of one call (operations per lane-iteration of the
configuration, times lane-iterations per solve of the cell, times the
poses) over the untraced window's time per call and the peak of every
card the cell uses."""

from ikbench import yardstick


def read(rec):
    work = rec["frozen"].get("lane_iters_per_solve")
    peaks = yardstick.peaks(rec["device_name"])
    if "batches" not in rec or work is None or peaks is None:
        return None
    ops = rec["config"]["fp32_ops_per_lane_iter"] * work * rec["batch"]
    per_call = rec["window_s"] / rec["batches"]
    return 100.0 * ops / per_call / (peaks[0] * rec["chips"])
