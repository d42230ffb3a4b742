"""Spans and counters inside the port, off by default.

    from optik_tpu_torch import telemetry

    telemetry.reset()
    with telemetry.recording():
        robot.ik_batch(cfg, tgt_r, tgt_t, x0)
    out = telemetry.export()

**Spans** mark the IK path's layer boundaries.  Each records its name, its
start and end on ``time.perf_counter_ns()`` (CLOCK_MONOTONIC, which every
process of a host shares), its parent and its root (the call it belongs
to).  Per name the recorder keeps the count, the total and the self time
(the duration less the part its child spans cover), and a ring of the last
``RAW_SPANS`` raw spans with a count of those dropped.  While recording,
each span also enters ``torch.profiler.record_function(name)``: a running
profiler shows it as a ``user_annotation`` on the timeline of the kernels.

    =================  ==============================  ======================
    span               where                           covers
    =================  ==============================  ======================
    optik.ik_batch     ``Robot.ik_batch``              the facade call (root)
    optik.ik.layout    ``lm_kernel.solve_kernel`` /    seed table, start
                       ``solve_plain``, the plain      points, SoA layout,
                       loop's ``solve_batch``          packed targets
    optik.lm.launch    ``lm_kernel.launch_lanes``      allocations, the C
                                                       entry, ``lane_iters``
    optik.ik.select    ``lm_kernel.select``, the       each pose's winner
                       plain loop's ``solve_batch``
    optik.mesh.solve   ``build_seed_sharded_solver``   the sharded call (root)
    optik.mesh.merge   ``Mesh.merge``                  the winner's all-reduces
                                                       and the gather
    optik.mesh.total   ``Mesh.total``                  the counter's all-reduce
    =================  ==============================  ======================

**Counters.**  ``lm.launches`` counts the LM kernel's launches where
``lm_kernel.LAUNCHES`` is incremented.  The rest come from the kernel's own
schedule probe: each launch reduces it on the card into a row of a ring of
``LAUNCH_ROWS`` per card (``lm_kernel.probe_row``; a full ring is summed
on the card before it is overwritten), without a sync, until :func:`export`
reads them through ``lm_kernel.probe_counts`` and ``draw_counts``:
``lm.lane_iters`` (the pose groups' iterations times S; on the restart
queue of uncapped Quality, the iterations the restarts ran),
``lm.slots`` (the warp slots executed, 32 per warp loop trip),
``lm.span_ns`` (last warp exit less first warp start), ``lm.tail_ns``
(last warp exit less the last draw from the pose or restart queue),
``lm.pair_wait_slots`` (for poses on a pair of warps, 32 times the
iterations by which one warp's run on the pose was shorter than the
other's: the slots the earlier warp waited at the pair's barrier, from
the probe's per-pose iterations; 0 on the restart queue),
``lm.lane_busy_iters`` (the iterations the lanes spent inside an attempt,
which the Quality build records per pose while telemetry records; 0 from
Speed launches), ``lm.restart_draws`` (the restarts the restart queue
handed out, B * R a launch; 0 from the pose groups) and
``lm.pose_switch_draws`` (those draws whose pose differs from the lane's
previous restart's), summed over launches, and per launch its span, tail
and last warp exit.

**The card's clock.**  :func:`export` reads each card's ``%globaltimer``
against ``perf_counter_ns`` (a one-thread read, bracketed by the host clock
before the launch and after the sync; the tightest of
``CALIBRATION_ROUNDS`` brackets is kept) and gives every launch's exit on
the host clock, with the bracket's half-width as its error.

Off, :func:`span` returns one shared no-op context manager and
:func:`count` returns at once: no allocation, no device work, no
``record_function`` and no lock.  Nothing reads the environment.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.profiler import record_function

CLOCK = "time.perf_counter_ns (CLOCK_MONOTONIC)"
# Raw spans kept (the newest); per-name aggregates count every span.
RAW_SPANS = 4096
# Per-launch rows kept per card (the newest); the totals count every launch.
LAUNCH_ROWS = 4096
CALIBRATION_ROUNDS = 16
# The counters lm_kernel.probe_counts reads from a sum of probe rows, and
# the width of a row (lm_kernel.probe_row).
PROBE_SUMS = ("lm.lane_iters", "lm.slots", "lm.span_ns", "lm.tail_ns",
              "lm.pair_wait_slots", "lm.lane_busy_iters", "lm.restart_draws",
              "lm.pose_switch_draws")
PROBE_WIDTH = 9

_OFF = contextlib.nullcontext()
_on = False


class _Card:
    """One card's probe rows: a ring, and the sum of the rows it no longer
    holds."""

    def __init__(self, device: torch.device, lib):
        self.lib = lib
        self.launches = 0
        self.rows = torch.zeros((LAUNCH_ROWS, PROBE_WIDTH),
                                dtype=torch.int64, device=device)
        self.folded = torch.zeros(PROBE_WIDTH, dtype=torch.int64,
                                  device=device)
        self.n_folded = 0

    def next_row(self) -> torch.Tensor:
        """The slot of the next launch's row."""
        k = self.launches % LAUNCH_ROWS
        if k == 0 and self.launches:
            self.folded.add_(self.rows.sum(dim=0))
            self.n_folded = self.launches
        self.launches += 1
        return self.rows[k]

    def sums(self) -> torch.Tensor:
        """The sum of every launch's row."""
        held = self.launches - self.n_folded
        return self.folded + self.rows[:held].sum(dim=0)


class _Recorder:
    """What one :func:`reset` to the next records."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.aggs: Dict[str, list] = {}      # name -> [count, total, self]
        self.roots: Dict[str, int] = {}      # root name -> calls
        self.raw = collections.deque(maxlen=RAW_SPANS)
        self.dropped = 0
        self.counts: Dict[str, int] = {}
        self.cards: Dict[torch.device, _Card] = {}

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def close(self, sp: "_Span", end: int) -> None:
        dur = end - sp.start
        with self.lock:
            agg = self.aggs.setdefault(sp.name, [0, 0, 0])
            agg[0] += 1
            agg[1] += dur
            agg[2] += dur - sp.child_ns
            if sp.parent is None:
                self.roots[sp.name] = self.roots.get(sp.name, 0) + 1
            if len(self.raw) == self.raw.maxlen:
                self.dropped += 1
            self.raw.append((sp.name, sp.id, sp.parent, sp.root, sp.start,
                             end))


_rec = _Recorder()


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "root", "start", "child_ns",
                 "annotation")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> "_Span":
        stack = self.rec.stack()
        up = stack[-1] if stack else None
        self.id = next(self.rec.ids)
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.child_ns = 0
        self.annotation = record_function(self.name)
        self.annotation.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        stack = self.rec.stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += end - self.start
        self.rec.close(self, end)
        self.annotation.__exit__(*exc)


def enabled() -> bool:
    """Whether a :func:`recording` body is running."""
    return _on


def span(name: str):
    """A context manager that records ``name`` around its body while
    recording; the shared no-op one otherwise."""
    if not _on:
        return _OFF
    return _Span(_rec, name)


def count(name: str) -> None:
    """Add 1 to the host counter ``name`` while recording."""
    if not _on:
        return
    with _rec.lock:
        _rec.counts[name] = _rec.counts.get(name, 0) + 1


def launch_row(device: torch.device, lib) -> Optional[torch.Tensor]:
    """While recording, the (``PROBE_WIDTH``,) int64 slot on ``device`` for
    one LM launch's probe row, which ``lm_kernel.probe_row`` fills; None
    otherwise.  ``lib`` is the launch's library, whose
    ``optik_lm_globaltimer`` entry :func:`export` reads the card's clock
    with."""
    if not _on:
        return None
    with _rec.lock:
        card = _rec.cards.get(device)
        if card is None:
            card = _rec.cards[device] = _Card(device, lib)
        return card.next_row()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counters for the body (what was recorded before is
    kept until :func:`reset`)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def reset() -> None:
    """Forget everything recorded."""
    global _rec
    _rec = _Recorder()


def recorded(fn: Callable[..., Any], *args, **kwargs) -> Tuple[Any, dict]:
    """``fn(*args, **kwargs)`` recorded from a reset: ``(result,
    export())``.  Module-level, so a spawned rank can run it
    (``parallel.launch.spawn(telemetry.recorded, n, fn, ...)``)."""
    reset()
    with recording():
        out = fn(*args, **kwargs)
    return out, export()


def card_clock(lib, device: torch.device) -> Tuple[int, int]:
    """``(offset, error)`` in ns: a ``%globaltimer`` reading ``g`` of
    ``device`` was ``g + offset`` on ``perf_counter_ns``, within ``error``.

    Each round brackets a one-thread read of the card's clock
    (``optik_lm_globaltimer`` of ``lib``) by the host clock before the
    launch and after the sync; the tightest bracket is kept, its midpoint
    the estimate and its half-width the error."""
    out = torch.empty(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device)
    best = None
    torch.cuda.synchronize(device)
    for _ in range(CALIBRATION_ROUNDS):
        t0 = time.perf_counter_ns()
        rc = lib.optik_lm_globaltimer(out.data_ptr(), stream.cuda_stream)
        stream.synchronize()
        t1 = time.perf_counter_ns()
        if rc != 0:
            raise RuntimeError(f"optik_lm_globaltimer failed: "
                               f"{lib.optik_lm_error_string(rc).decode()}")
        g = int(out.item())
        if best is None or t1 - t0 < best[1] - best[0]:
            best = (t0, t1, g)
    t0, t1, g = best
    return (t0 + t1) // 2 - g, (t1 - t0 + 1) // 2


def export() -> dict:
    """Everything recorded since the last :func:`reset`, as plain Python
    values (it synchronises with each card that holds counters)."""
    # Imported here: lm_kernel imports this module.
    from .ops.cuda.lm_kernel import draw_counts, probe_counts

    rec = _rec
    with rec.lock:
        aggs = {k: list(v) for k, v in rec.aggs.items()}
        roots = dict(rec.roots)
        raw = list(rec.raw)
        dropped = rec.dropped
        counters = {"lm.launches": 0, **dict.fromkeys(PROBE_SUMS, 0),
                    **rec.counts}
        cards = dict(rec.cards)
    devices = {}
    for device, card in cards.items():
        sums = card.sums().tolist()
        for name, v in zip(PROBE_SUMS,
                           probe_counts(sums) + draw_counts(sums)):
            counters[name] += v
        n = min(card.launches, LAUNCH_ROWS)
        first = card.launches - n
        rows = card.rows.tolist()
        rows = [rows[k % LAUNCH_ROWS] for k in range(first, card.launches)]
        offset, error = card_clock(card.lib, device)
        devices[str(device)] = {
            "launches": card.launches, "rows_dropped": first,
            "clock_offset_ns": offset, "clock_error_ns": error,
            "span_ns": [probe_counts(r)[2] for r in rows],
            "tail_ns": [probe_counts(r)[3] for r in rows],
            "exit_ns": [r[4] + offset for r in rows]}
    return {
        "clock": CLOCK,
        "spans": {k: {"count": v[0], "total_ns": v[1], "self_ns": v[2]}
                  for k, v in aggs.items()},
        "calls": roots,
        "raw": [{"name": n, "id": i, "parent": p, "root": r,
                 "start_ns": s, "end_ns": e} for n, i, p, r, s, e in raw],
        "dropped": dropped,
        "counters": counters,
        "devices": devices,
    }
