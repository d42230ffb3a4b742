"""glue_device_ms_per_batch (ms): device time per IK call of every kernel,
copy and set other than the LM solve kernel and the collectives: the
seed layout, launch preparation and the per-pose selection (traced
segment)."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or "batches" not in rec or not tr["calls"]:
        return None
    glue = sum(us for name, us in tr["device_us"].items()
               if "lm_solve" not in name and "nccl" not in name.lower())
    return glue / tr["calls"] / 1e3
