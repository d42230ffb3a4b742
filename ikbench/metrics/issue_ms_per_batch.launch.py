"""issue_ms_per_batch.launch (ms): the host's self time per IK call in the
program's span ``optik.lm.launch``: the outputs' and the probe's
allocations, the kernel's C entry and the ``lane_iters`` reduction
(``ops/cuda/lm_kernel.launch_lanes``).  Read from the program's telemetry
in its segment with the profiler off (``ikbench/program_telemetry.py``)."""

from ikbench import program_telemetry


def read(rec):
    return program_telemetry.self_ms_per_call(rec, "optik.lm.launch")
