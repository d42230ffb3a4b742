"""call_ms_p95 (ms): the 95th percentile, over every call in the window, of
the host time from the call to its result fetched (closed-loop cells,
whose drivers fetch each call's result before the next)."""

import numpy as np


def read(rec):
    if "calls" not in rec or not rec["call_spans"]:
        return None
    return float(np.percentile(np.asarray(rec["call_spans"]) * 1e3, 95))
