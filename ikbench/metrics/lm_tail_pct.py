"""lm_tail_pct (%): the share of the LM kernel's time after its last draw
from the pose queue, when the card only drains: the program's counters
``lm.tail_ns`` (last warp exit less last draw) over ``lm.span_ns`` (last
warp exit less first warp start), summed over the launches of the
telemetry segment with the profiler off, as the kernel's own
``%globaltimer`` probe reads them."""

from ikbench import program_telemetry


def read(rec):
    c = program_telemetry.counters(rec)
    if not c or c["lm.span_ns"] <= 0:
        return None
    return 100.0 * c["lm.tail_ns"] / c["lm.span_ns"]
