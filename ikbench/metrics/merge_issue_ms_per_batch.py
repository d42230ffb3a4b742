"""merge_issue_ms_per_batch (ms): the host's self time per sharded call in
the program's spans ``optik.mesh.merge`` (the winner's all-reduces over
the seed group and the gather over the data group, ``Mesh.merge``) and
``optik.mesh.total`` (the work counter's all-reduce, ``Mesh.total``), in
the telemetry segment with the profiler off."""

from ikbench import program_telemetry


def read(rec):
    return program_telemetry.self_ms_per_call(rec, "optik.mesh.merge",
                                              "optik.mesh.total")
