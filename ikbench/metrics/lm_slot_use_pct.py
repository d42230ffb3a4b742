"""lm_slot_use_pct (%): the share of the warp slots the LM kernel executed
that held a lane's iteration: the program's counters ``lm.lane_iters``
(the pose groups' iterations times S) over ``lm.slots`` (32 per warp loop
trip), summed over the launches of the telemetry segment with the
profiler off."""

from ikbench import program_telemetry


def read(rec):
    c = program_telemetry.counters(rec)
    if not c or c["lm.slots"] <= 0:
        return None
    return 100.0 * c["lm.lane_iters"] / c["lm.slots"]
