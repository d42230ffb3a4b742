"""steps_per_s (steps/s): the differential-IK lanes returned in the window
over the window's time."""


def read(rec):
    if "calls" not in rec:
        return None
    return rec["work"] / rec["window_s"]
