"""solves_per_s (solves/s): the poses of every IK call completed in the
window over the time from the window's start to its last fetch."""


def read(rec):
    if "batches" not in rec:
        return None
    return rec["work"] / rec["window_s"]
