"""The readers of the program's telemetry (``ikbench/program_telemetry.py``
and its metrics): None on a record without it, as a program without the
telemetry module leaves; the right value on a synthetic record; the idle
time under the program's spans on a hand-made Chrome trace."""

import pytest
import torch

from ikbench import harness, program_telemetry, trace
from ikbench.tests.test_ikbench_metrics import EVENTS, ev, record

NEW = ("issue_ms_per_batch.layout", "issue_ms_per_batch.launch",
       "issue_ms_per_batch.select", "lm_tail_pct", "lm_slot_use_pct",
       "idle_in_program_pct", "lm_tail_pct.mesh",
       "idle_in_program_pct.mesh", "merge_issue_ms_per_batch",
       "merge_skew_ms_per_batch")

# EVENTS' idle, [0, 100], [490, 550], [850, 860], [900, 980], under the
# program's spans: a call [5, 60] with its layout [20, 45]; a call
# [495, 545] with its launch [500, 520]; the select [855, 870].
PROGRAM = [
    ev("optik.ik_batch", "user_annotation", 5.0, 55.0),
    ev("optik.ik.layout", "user_annotation", 20.0, 25.0),
    ev("optik.ik_batch", "user_annotation", 495.0, 50.0),
    ev("optik.lm.launch", "user_annotation", 500.0, 20.0),
    ev("optik.ik.select", "user_annotation", 855.0, 15.0),
    ev("optik.ik_batch", "gpu_user_annotation", 0.0, 900.0),
]


def telemetry(**kw):
    tel = {
        "calls": 4, "plain_s": 0.01,
        "plain": {
            "spans": {
                "optik.ik_batch": {"count": 4, "total_ns": 4_000_000,
                                   "self_ns": 800_000},
                "optik.ik.layout": {"count": 4, "total_ns": 1_200_000,
                                    "self_ns": 1_200_000},
                "optik.lm.launch": {"count": 4, "total_ns": 1_000_000,
                                    "self_ns": 1_000_000},
                "optik.ik.select": {"count": 4, "total_ns": 1_000_000,
                                    "self_ns": 1_000_000},
                "optik.mesh.merge": {"count": 4, "total_ns": 600_000,
                                     "self_ns": 500_000},
                "optik.mesh.total": {"count": 4, "total_ns": 100_000,
                                     "self_ns": 100_000}},
            "calls": {"optik.ik_batch": 4},
            "counters": {"lm.launches": 4, "lm.lane_iters": 9_300,
                         "lm.slots": 10_000, "lm.span_ns": 8_000_000,
                         "lm.tail_ns": 2_000_000},
            "devices": {}},
        "traced": {"idle_us": 200.0, "idle_in_program_us": 150.0,
                   "idle_by_span_us": {}},
        "ranks": [{"exit_ns": [1_000_000, 3_000_000], "clock_error_ns": 9},
                  {"exit_ns": [1_400_000, 3_100_000], "clock_error_ns": 12},
                  {"exit_ns": [1_100_000, 3_600_000, 9], "clock_error_ns": 7}],
    }
    tel.update(kw)
    return tel


def read(name, rec):
    return harness.reader(name)(rec)


def test_new_metrics_read_none_without_the_programs_telemetry():
    for rec in (record(), record(telemetry=None)):
        for name in NEW:
            assert read(name, rec) is None, name


def test_new_metrics_on_a_synthetic_record():
    rec = record(telemetry=telemetry())
    assert read("issue_ms_per_batch.layout", rec) == pytest.approx(0.3)
    assert read("issue_ms_per_batch.launch", rec) == pytest.approx(0.25)
    assert read("issue_ms_per_batch.select", rec) == pytest.approx(0.25)
    assert read("lm_tail_pct", rec) == pytest.approx(25.0)
    assert read("lm_slot_use_pct", rec) == pytest.approx(93.0)
    assert read("idle_in_program_pct", rec) == pytest.approx(75.0)
    assert read("merge_issue_ms_per_batch", rec) == pytest.approx(0.15)
    # Per call the latest less the earliest exit over the cards: 0.4 and
    # 0.6 ms (the third card's extra launch has no peer).
    assert read("merge_skew_ms_per_batch", rec) == pytest.approx(0.5)
    for name in ("lm_tail_pct", "idle_in_program_pct"):
        assert read(f"{name}.mesh", rec) == read(name, rec)


def test_readers_refuse_what_they_cannot_read():
    rough = telemetry()
    rough["ranks"][1]["clock_error_ns"] = 60_000
    assert read("merge_skew_ms_per_batch", record(telemetry=rough)) is None
    one = telemetry(ranks=telemetry()["ranks"][:1])
    assert read("merge_skew_ms_per_batch", record(telemetry=one)) is None
    cpu = telemetry()
    cpu["plain"]["counters"] = dict(cpu["plain"]["counters"], **{
        "lm.slots": 0, "lm.span_ns": 0})
    cpu["plain"]["spans"].pop("optik.lm.launch")
    rec = record(telemetry=cpu)
    assert read("lm_tail_pct", rec) is None
    assert read("lm_slot_use_pct", rec) is None
    assert read("issue_ms_per_batch.launch", rec) is None
    assert read("issue_ms_per_batch.layout", rec) == pytest.approx(0.3)


def test_idle_under_the_programs_spans():
    out = program_telemetry.program_idle(EVENTS + PROGRAM)
    assert out["idle_us"] == pytest.approx(100 + 60 + 10 + 80)
    # [5, 60] covers idle [5, 60] of [0, 100]: 25 us innermost in the
    # layout, 30 in the call; [495, 545] covers 50 us of idle [490, 550],
    # 20 of them in the launch; [855, 860] of the select.
    assert out["idle_by_span_us"] == pytest.approx({
        "optik.ik.layout": 25.0, "optik.ik_batch": 30.0 + 30.0,
        "optik.lm.launch": 20.0, "optik.ik.select": 5.0})
    assert out["idle_in_program_us"] == pytest.approx(110.0)
    # The profiled segment's summary is the same with the spans in it.
    plain, spanned = trace.summarize(EVENTS), trace.summarize(EVENTS
                                                              + PROGRAM)
    for key in ("window_us", "busy_us", "device_us", "kernels", "calls",
                "top_ops"):
        assert plain[key] == spanned[key], key


def test_segments_on_the_programs_telemetry():
    tel = program_telemetry.program()
    assert tel is not None

    def segment():
        for _ in range(3):
            with tel.span("optik.ik_batch"):
                with tel.span("optik.ik.layout"):
                    torch.ones(64).sum()

    out = program_telemetry.segments(segment, 3)
    assert out["calls"] == 3 and out["plain_s"] > 0
    assert out["plain"]["calls"] == {"optik.ik_batch": 3}
    assert out["plain"]["spans"]["optik.ik.layout"]["count"] == 3
    traced = out["traced"]
    assert set(traced["idle_by_span_us"]) <= {"optik.ik_batch",
                                              "optik.ik.layout"}
    assert 0 < traced["idle_in_program_us"] <= traced["idle_us"]
    assert traced["summary"]["window_us"] > 0
    assert not tel.enabled() and not tel.export()["spans"]
    line = program_telemetry.digest(out, {"window_s": 1.0, "batches": 10},
                                    traced["summary"])
    assert line["window_ms_per_call"] == 100.0
    assert set(line["self_ms_per_call"]) == {"optik.ik_batch",
                                             "optik.ik.layout"}
    assert line["segment_b_idle_in_program_us"] == \
        traced["idle_in_program_us"]
    assert "traced_idle_pct" in line and "segment_b_idle_pct" in line
    mesh = program_telemetry.for_mesh([out, out], 1)
    assert mesh["plain"] == out["plain"]
    assert mesh["ranks"] == [{"exit_ns": [], "clock_error_ns": None}] * 2
    assert read("merge_skew_ms_per_batch", record(telemetry=mesh)) is None


def test_segments_without_the_programs_telemetry(monkeypatch):
    monkeypatch.setattr(program_telemetry, "program", lambda: None)
    ran = []
    assert program_telemetry.segments(lambda: ran.append(1), 1) is None
    assert not ran
    assert program_telemetry.for_mesh([None, None], 0) is None
    assert program_telemetry.digest(None, {}) == {"telemetry": None}
