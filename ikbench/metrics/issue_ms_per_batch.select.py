"""issue_ms_per_batch.select (ms): the host's self time per IK call in the
program's span ``optik.ik.select``: each pose's winner
(``ops/cuda/lm_kernel.select``).  Read from the program's telemetry in its
segment with the profiler off (``ikbench/program_telemetry.py``)."""

from ikbench import program_telemetry


def read(rec):
    return program_telemetry.self_ms_per_call(rec, "optik.ik.select")
