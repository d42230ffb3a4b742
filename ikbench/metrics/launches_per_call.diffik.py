"""launches_per_call.diffik (launches): CUDA kernels per differential-IK
call, counted in the traced segment's profile."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or "calls" not in rec or not tr["calls"]:
        return None
    return tr["kernels"] / tr["calls"]
