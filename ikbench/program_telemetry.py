"""The program's own telemetry in a ``--trace 1`` run
(``optik_tpu_torch.telemetry``): two segments after the profiled one.

Both follow a warm-up segment recorded and forgotten.

* (a) telemetry on, the profiler off: the program's export (its spans' self
  times, the LM kernel's counters reduced from its own probe, each launch's
  last warp exit on the host clock) and the segment's seconds;
* (b) telemetry on under the profiler: :func:`program_idle` of its Chrome
  trace (the card's idle time that falls under a program span, ``optik.*``)
  and ``trace.summarize`` of it, for the on-cost beside the profiled
  segment's summary.

``ik_stream.run`` is to call :func:`segments` after ``trace.run_traced``
and keep the result as ``rec["telemetry"]``; ``ik_stream_mesh`` gathers
every rank's and keeps :func:`for_mesh` of them, the fields of the rank its
other per-layer metrics read.  The import of the program's module is guarded: a program
without it gives None, and every metric that reads the key reads None.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import trace

PREFIX = "optik."


def program():
    """The program's telemetry module, or None where it has none."""
    try:
        from optik_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry


def trace_events(fn: Callable[[], None]) -> List[dict]:
    """Run ``fn`` under the profiler, inside ``trace.SEGMENT``, and return
    its Chrome trace's events (``trace.run_traced``'s run, unsummarised)."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.SEGMENT):
            fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return events


def segments(segment: Callable[[], None], calls: int) -> Optional[dict]:
    """Segments (a) and (b), each ``segment()`` (``calls`` calls), after one
    ``segment()`` recorded and forgotten (the telemetry's own first use:
    its buffers, the reduction's kernels); None where the program has no
    telemetry."""
    tel = program()
    if tel is None:
        return None
    with tel.recording():
        segment()
    tel.reset()
    t0 = time.perf_counter()
    with tel.recording():
        segment()
    seconds = time.perf_counter() - t0
    plain = tel.export()
    tel.reset()
    with tel.recording():
        events = trace_events(segment)
    tel.reset()
    return {"calls": calls, "plain": plain, "plain_s": seconds,
            "traced": dict(program_idle(events),
                           summary=trace.summarize(events))}


def for_mesh(per_rank: List[Optional[dict]], chosen: int) -> Optional[dict]:
    """The mesh record's telemetry: rank ``chosen``'s segments, and every
    rank's LM-kernel exits on the host clock with its clock's error."""
    if any(r is None for r in per_rank):
        return None
    ranks = []
    for r in per_rank:
        cards = list(r["plain"]["devices"].values())
        ranks.append({"exit_ns": cards[0]["exit_ns"] if cards else [],
                      "clock_error_ns": cards[0]["clock_error_ns"]
                      if cards else None})
    return dict(per_rank[chosen], ranks=ranks)


def self_ms_per_call(rec: dict, *names: str) -> Optional[float]:
    """The summed self time of the spans ``names`` per call of segment
    (a), in ms; None without telemetry or without those spans."""
    tel = rec.get("telemetry")
    if not tel or not tel["calls"]:
        return None
    spans = tel["plain"]["spans"]
    if not any(n in spans for n in names):
        return None
    ns = sum(spans[n]["self_ns"] for n in names if n in spans)
    return ns / tel["calls"] / 1e6


def counters(rec: dict) -> Optional[Dict[str, int]]:
    """Segment (a)'s counters, or None."""
    tel = rec.get("telemetry")
    return tel["plain"]["counters"] if tel else None


def _union(intervals):
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def program_idle(events: List[dict]) -> dict:
    """The card's idle time in the segment, and the part of it under a
    host span of the program (a ``user_annotation`` named ``optik.*``).

    Idle is the segment less the union of the device's activity
    (``trace.DEVICE_CATS``).  ``idle_in_program_us`` is idle intersected
    with the union of the program's spans; ``idle_by_span_us`` gives each
    piece of it to the innermost (shortest) program span over it, so its
    values add up to ``idle_in_program_us``."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    seg = [e for e in spans if e.get("name") == trace.SEGMENT
           and e.get("cat", "").lower() == "user_annotation"]
    if not seg:
        raise RuntimeError("the trace has no ikbench.segment annotation")
    t0 = float(seg[0]["ts"])
    t1 = t0 + float(seg[0]["dur"])

    def clip(e):
        s = max(float(e["ts"]), t0)
        return s, min(float(e["ts"]) + float(e["dur"]), t1)

    busy = _union([clip(e) for e in spans
                   if e.get("cat", "").lower() in trace.DEVICE_CATS
                   and clip(e)[0] < clip(e)[1]])
    edges = [t0] + [v for iv in busy for v in iv] + [t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    prog = [(*clip(e), float(e["dur"]), e["name"]) for e in spans
            if e.get("cat", "").lower() == "user_annotation"
            and e.get("name", "").startswith(PREFIX)
            and clip(e)[0] < clip(e)[1]]
    # Sweep the cuts of the program's spans and the idle intervals: on
    # each piece between two cuts, the spans open over it.
    cuts = sorted({v for s, e, _, _ in prog for v in (s, e)}
                  | {v for iv in idle for v in iv})
    by_span: Dict[str, float] = {}
    j = 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        if j == len(idle) or idle[j][0] >= b:
            continue
        over = [p for p in prog if p[0] <= a and p[1] >= b]
        if over:
            name = min(over, key=lambda p: p[2])[3]
            by_span[name] = by_span.get(name, 0.0) + (b - a)
    return {"idle_us": sum(e - s for s, e in idle),
            "idle_in_program_us": sum(by_span.values()),
            "idle_by_span_us": by_span}


def _glue_ms(summary: dict) -> float:
    """Device time per call of every kernel, copy and set but the LM solve
    and NCCL (``glue_device_ms_per_batch``'s sum)."""
    us = sum(v for k, v in summary["device_us"].items()
             if "lm_solve" not in k and "nccl" not in k.lower())
    return us / max(summary["calls"], 1) / 1e3


def digest(tel: Optional[dict], win: dict,
           summary: Optional[dict] = None) -> dict:
    """A diagnostic line's fields: segment (a)'s time per call beside the
    window's, its self times per call, counters and clock errors, segment
    (b)'s idle shares and glue beside the profiled segment's (the
    instrumentation's cost when on)."""
    if not tel:
        return {"telemetry": None}
    plain, calls = tel["plain"], max(tel["calls"], 1)
    tr = tel["traced"]
    out = {
        "window_ms_per_call": 1e3 * win["window_s"] / win["batches"],
        "segment_a_ms_per_call": 1e3 * tel["plain_s"] / calls,
        "self_ms_per_call": {k: v["self_ns"] / calls / 1e6
                             for k, v in plain["spans"].items()},
        "total_ms_per_call": {k: v["total_ns"] / calls / 1e6
                              for k, v in plain["spans"].items()},
        "counters": plain["counters"],
        "clock_error_ns": {k: v["clock_error_ns"]
                           for k, v in plain["devices"].items()},
        "span_ns_per_launch": {k: v["span_ns"]
                               for k, v in plain["devices"].items()},
        "segment_b_idle_pct": 100 * tr["idle_us"]
        / max(tr["summary"]["window_us"], 1e-9),
        "segment_b_idle_in_program_us": tr["idle_in_program_us"],
        "segment_b_idle_by_span_us": tr["idle_by_span_us"],
        "segment_b_glue_ms_per_call": _glue_ms(tr["summary"]),
        "segment_b_ms_per_call": tr["summary"]["window_us"] / calls / 1e3,
    }
    if summary is not None:
        out["traced_idle_pct"] = 100 * (1 - summary["busy_us"]
                                        / max(summary["window_us"], 1e-9))
        out["traced_glue_ms_per_call"] = _glue_ms(summary)
    return out
