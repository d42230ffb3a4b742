"""lm_solve_roofline (%): the least time the card could take for one
call's LM solve over the device time of the kernels named ``lm_solve``
per call (traced segment).

The least time is the larger of the FP32 operations over the FP32 peak
and the bytes over the memory rate (``yardstick.bound_ms``).  Operations:
the configuration's frozen FP32 operations per lane-iteration times the
cell's frozen lane-iterations per solve times the poses a card solves
per call; bytes: ``yardstick.ik_batch_bytes`` of those poses.  Neither is
read from the program."""

from ikbench import yardstick


def read(rec):
    tr = rec.get("trace")
    work = rec["frozen"].get("lane_iters_per_solve")
    if tr is None or work is None or not tr["calls"]:
        return None
    kern = sum(us for name, us in tr["device_us"].items()
               if "lm_solve" in name)
    if kern <= 0:
        return None
    poses = rec["batch"] / rec["chips"]
    solver = rec["config"]["solver"]
    bound = yardstick.bound_ms(
        rec["config"]["fp32_ops_per_lane_iter"] * work * poses,
        yardstick.ik_batch_bytes(int(poses), rec["config"]["dof"],
                                 solver["max_restarts"]),
        rec["device_name"])
    if bound is None:
        return None
    return 100.0 * bound[0] / (kern / tr["calls"] / 1e3)
