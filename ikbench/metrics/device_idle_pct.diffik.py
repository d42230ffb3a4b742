"""device_idle_pct.diffik (%): the share of the traced segment of a
differential-IK cell in which no kernel, copy or set runs on the card."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or "calls" not in rec or tr["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])
