"""merge_skew_ms_per_batch (ms): how long the first card to finish a call's
LM solve waits for the last before the merge can complete: the mean over
the calls of the telemetry segment (profiler off) of the latest less the
earliest last-warp exit of the call's LM kernel over the mesh's cards,
each card's ``%globaltimer`` put on the host clock all ranks share.  None
where a card's clock is known to worse than 0.05 ms."""

# The largest error of a card's clock (ns) the reading accepts.
MAX_CLOCK_ERROR_NS = 50_000


def read(rec):
    tel = rec.get("telemetry")
    ranks = tel.get("ranks") if tel else None
    if not ranks or len(ranks) < 2:
        return None
    if any(r["clock_error_ns"] is None
           or r["clock_error_ns"] > MAX_CLOCK_ERROR_NS for r in ranks):
        return None
    n = min(len(r["exit_ns"]) for r in ranks)
    if n == 0:
        return None
    skew = [max(r["exit_ns"][k] for r in ranks)
            - min(r["exit_ns"][k] for r in ranks) for k in range(n)]
    return sum(skew) / n / 1e6
