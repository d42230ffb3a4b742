"""collective_ms_per_batch (ms): device time per call of the NCCL kernels
(the merge's all-reduces and all-gather, the work counter's sum) on the
card the record's trace is from (traced segment).  An NCCL kernel runs
from its launch until its peers arrive, so this includes the wait for the
slowest rank of the group."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or "batches" not in rec or not tr["calls"]:
        return None
    nccl = [us for name, us in tr["device_us"].items()
            if "nccl" in name.lower()]
    if not nccl:
        return None
    return sum(nccl) / tr["calls"] / 1e3
