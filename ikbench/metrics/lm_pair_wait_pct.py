"""lm_pair_wait_pct (%): the share of the warp slots the LM kernel held
that an earlier warp of a pose's pair spent waiting at the pair's barrier
for the later one: the program's counters ``lm.pair_wait_slots`` (32 per
iteration between the two warps' runs on a pose) over ``lm.slots`` (32
per warp loop trip) plus ``lm.pair_wait_slots``, summed over the launches
of the telemetry segment with the profiler off.  None where the program
has no such counter."""

from ikbench import program_telemetry


def read(rec):
    c = program_telemetry.counters(rec)
    if not c or "lm.pair_wait_slots" not in c:
        return None
    held = c["lm.slots"] + c["lm.pair_wait_slots"]
    if held <= 0:
        return None
    return 100.0 * c["lm.pair_wait_slots"] / held
