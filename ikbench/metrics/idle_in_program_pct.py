"""idle_in_program_pct (%): the share of the card's idle time that falls
under a host span of the program (``optik.*``: the facade, layout, launch,
selection, merge), in the telemetry segment under the profiler; the rest
is idle while the host is outside the program (the benchmark's fetch, its
loop, the interpreter)."""


def read(rec):
    tel = rec.get("telemetry")
    if not tel or tel["traced"]["idle_us"] <= 0:
        return None
    tr = tel["traced"]
    return 100.0 * tr["idle_in_program_us"] / tr["idle_us"]
