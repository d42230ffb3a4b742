"""device_idle_pct.ik (%): the share of the traced segment of an IK cell
in which no kernel, copy or set runs on the card."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or "batches" not in rec or tr["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])
