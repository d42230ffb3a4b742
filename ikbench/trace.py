"""The traced segment of a run: ``torch.profiler`` over a few batches or
calls, its Chrome trace read back into a summary the per-layer metrics
read.

The segment is wrapped in the annotation ``ikbench.segment``; each call
into the program in ``ikbench.call`` and each fetch in ``ikbench.fetch``.
Device activity is every event of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; ``busy_us`` is the length of their
union inside the segment, so overlapping streams count once.  An idle gap
is named by what the host was doing at its middle: the innermost host
event (an annotation, an operator or a runtime call) under it.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
SEGMENT = "ikbench.segment"


def run_traced(fn: Callable[[], None]) -> dict:
    """Run ``fn`` under the profiler and return :func:`summarize` of its
    Chrome trace (written to a temporary directory and removed)."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SEGMENT):
            fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return summarize(events)


def short(name: str, width: int = 160) -> str:
    """A device operation's name, cut to ``width`` characters (template
    arguments make some thousands long)."""
    return name if len(name) <= width else name[:width - 3] + "..."


def _union(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: List[dict]) -> dict:
    """Segment length, device-busy time, device time by name, kernels,
    the longest idle gaps and the calls in the segment."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    seg = [e for e in spans if e.get("name") == SEGMENT
           and e.get("cat", "").lower() == "user_annotation"]
    if not seg:
        raise RuntimeError("the trace has no ikbench.segment annotation")
    t0 = float(seg[0]["ts"])
    t1 = t0 + float(seg[0]["dur"])
    dev = [e for e in spans if e.get("cat", "").lower() in DEVICE_CATS]
    host = [e for e in spans if e.get("cat", "").lower() in HOST_CATS]
    by_name: Dict[str, float] = {}
    kernels = 0
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
        kernels += e.get("cat", "").lower() == "kernel"
    busy = _union([(max(float(e["ts"]), t0),
                    min(float(e["ts"]) + float(e["dur"]), t1))
                   for e in dev if float(e["ts"]) < t1
                   and float(e["ts"]) + float(e["dur"]) > t0])
    busy_us = sum(e - s for s, e in busy)
    edges = [t0] + [v for iv in busy for v in iv] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    named = []
    for length, start in gaps:
        mid = start + length / 2
        under = [e for e in host if float(e["ts"]) <= mid
                 <= float(e["ts"]) + float(e["dur"]) and e["name"] != SEGMENT]
        inner = min(under, key=lambda e: float(e["dur"]), default=None)
        named.append([inner["name"] if inner else "host idle",
                      length * 1e-6])
    return {
        "window_us": t1 - t0, "busy_us": busy_us,
        "device_us": by_name, "kernels": kernels,
        "calls": sum(1 for e in host if e["name"] == "ikbench.call"),
        "top_ops": sorted(([short(k), v * 1e-6]
                           for k, v in by_name.items()),
                          key=lambda kv: -kv[1])[:10],
        "idle_gaps": named,
    }
