"""lm_pose_switch_pct (%): the share of the LM kernel's draws from its
restart queue whose pose differs from the drawing lane's previous
restart's: the program's counters ``lm.pose_switch_draws`` over
``lm.restart_draws``, summed over the launches of the telemetry segment
with the profiler off.  Uncapped Quality hands every lane (pose, restart)
items one at a time, in pose-major order, so the share says how far the
queue spreads a pose's restarts over the card's lanes; a lane's first draw
switches from nothing and is not counted.  None where the program has no
such counters or its queue handed out nothing (Speed and capped Quality
keep a pose on its thread group)."""

from ikbench import program_telemetry


def read(rec):
    c = program_telemetry.counters(rec)
    if not c or c.get("lm.restart_draws", 0) <= 0 \
            or "lm.pose_switch_draws" not in c:
        return None
    return 100.0 * c["lm.pose_switch_draws"] / c["lm.restart_draws"]
