"""host_ms_per_batch.ik (ms): the facade's host time per call, the mean
over the window's calls of the benchmark's span around
``Robot.ik_batch`` (or the sharded solve), from the call to its return,
with no sync (untraced window)."""


def read(rec):
    spans = rec.get("call_spans")
    if "batches" not in rec or not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
