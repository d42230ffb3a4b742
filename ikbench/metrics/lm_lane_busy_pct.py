"""lm_lane_busy_pct (%): the share of the warp slots the LM kernel held
in which a lane was inside one of its attempts: the program's counters
``lm.lane_busy_iters`` (the iterations each lane ran until its restarts
were spent, which the Quality build records per pose) over ``lm.slots``
plus ``lm.pair_wait_slots``, summed over the launches of the telemetry
segment with the profiler off.  Each lane runs a fixed share of the
pose's restarts, so one whose attempts end early idles until the pose's
slowest lane is through; padding, the pair's wait and the drain idle
too.  None where the program has no such counters."""

from ikbench import program_telemetry


def read(rec):
    c = program_telemetry.counters(rec)
    if not c or "lm.lane_busy_iters" not in c \
            or "lm.pair_wait_slots" not in c:
        return None
    held = c["lm.slots"] + c["lm.pair_wait_slots"]
    if held <= 0 or c["lm.lane_busy_iters"] <= 0:
        return None
    return 100.0 * c["lm.lane_busy_iters"] / held
