"""Each metric's arithmetic on a small recorded trace and record, worked
out by hand."""

import pytest

from ikbench import harness, trace, yardstick


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# A 980 us segment of two calls on one card: the LM kernel 600 us, glue
# 100 us (a copy overlapping the kernel by 20 us counts once for busy),
# one NCCL kernel of 50 us, idle elsewhere.
EVENTS = [
    ev("ikbench.segment", "user_annotation", 0.0, 980.0),
    ev("ikbench.call", "user_annotation", 10.0, 30.0),
    ev("ikbench.call", "user_annotation", 500.0, 40.0),
    ev("ikbench.fetch", "user_annotation", 900.0, 90.0),
    ev("aten::cat", "cpu_op", 50.0, 40.0),
    ev("void lm_solve_kernel<RegisterLane>(float*)", "kernel", 100.0,
       300.0),
    ev("void lm_solve_kernel<RegisterLane>(float*)", "kernel", 550.0,
       300.0),
    ev("Memcpy DtoD", "gpu_memcpy", 380.0, 60.0),
    ev("void at::native::index_kernel", "kernel", 860.0, 40.0),
    ev("ncclDevKernel_AllReduce_Sum_f32", "kernel", 440.0, 50.0),
    ev("ikbench.segment", "gpu_user_annotation", 0.0, 1000.0),
]


def summary():
    return trace.summarize(EVENTS)


def test_summary():
    s = summary()
    assert s["window_us"] == 980.0
    # union: [100, 490] (kernel 100-400, copy 380-440, nccl 440-490),
    # [550, 850], [860, 900]
    assert s["busy_us"] == pytest.approx(390.0 + 300.0 + 40.0)
    assert s["calls"] == 2 and s["kernels"] == 4
    assert s["device_us"]["Memcpy DtoD"] == 60.0
    # the longest gap [0, 100] is named by the innermost host event at 50
    assert s["idle_gaps"][0][0] == "aten::cat"
    assert s["idle_gaps"][0][1] == pytest.approx(100e-6)
    assert s["top_ops"][0] == ["void lm_solve_kernel<RegisterLane>(float*)",
                               pytest.approx(600e-6)]


def record(**kw):
    rec = {"batches": 100, "window_s": 0.2, "work": 100 * 131072,
           "batch": 131072, "chips": 1, "setup_s": 9.5,
           "call_spans": [0.0004, 0.0006], "device_name":
           "NVIDIA H100 80GB HBM3", "trace": summary(),
           "config": {"fp32_ops_per_lane_iter": 2015, "dof": 7,
                      "solver": {"max_restarts": 64}},
           "frozen": {"lane_iters_per_solve": 90.0}}
    rec.update(kw)
    return rec


def read(name, rec):
    return harness.reader(name)(rec)


def test_end_to_end():
    rec = record()
    assert read("solves_per_s", rec) == pytest.approx(100 * 131072 / 0.2)
    assert read("setup_s", rec) == 9.5


def test_per_layer():
    rec = record()
    assert read("host_ms_per_batch.ik", rec) == pytest.approx(0.5)
    assert read("glue_device_ms_per_batch", rec) == pytest.approx(0.05)
    assert read("collective_ms_per_batch", rec) == pytest.approx(0.025)
    assert read("device_idle_pct.ik", rec) == pytest.approx(
        100 * 250 / 980)
    ops = 2015 * 90.0 * 131072
    nbytes = yardstick.ik_batch_bytes(131072, 7, 64)
    bound = max(ops / 66.9e12, nbytes / 3.35e12) * 1e3
    assert read("lm_solve_roofline", rec) == pytest.approx(
        100 * bound / 0.3)
    assert read("ik_mfu_pct", rec) == pytest.approx(
        100 * ops / 0.002 / 66.9e12)


def test_four_cards_share_the_work():
    rec = record(chips=4, batch=4 * 131072)
    ops = 2015 * 90.0 * 131072
    bound = ops / 66.9e12 * 1e3
    assert read("lm_solve_roofline", rec) == pytest.approx(
        100 * bound / 0.3)
    assert read("ik_mfu_pct", rec) == pytest.approx(
        100 * 4 * ops / 0.002 / (4 * 66.9e12))
    for name, base in [("mesh_solves_per_s", "solves_per_s"),
                       ("host_ms_per_batch.mesh", "host_ms_per_batch.ik"),
                       ("glue_device_ms_per_batch.mesh",
                        "glue_device_ms_per_batch"),
                       ("lm_solve_roofline.mesh", "lm_solve_roofline"),
                       ("ik_mfu_pct.mesh", "ik_mfu_pct"),
                       ("device_idle_pct.mesh", "device_idle_pct.ik")]:
        assert read(name, rec) == read(base, rec), name


def test_readers_return_nothing_without_a_source():
    rec = record(trace=None, device_name="cpu")
    for name in ("glue_device_ms_per_batch", "collective_ms_per_batch",
                 "device_idle_pct.ik", "lm_solve_roofline", "ik_mfu_pct"):
        assert read(name, rec) is None, name
    no_nccl = record()
    no_nccl["trace"] = dict(no_nccl["trace"], device_us={
        k: v for k, v in no_nccl["trace"]["device_us"].items()
        if "nccl" not in k})
    assert read("collective_ms_per_batch", no_nccl) is None
    diffik = {"calls": 4, "window_s": 0.1, "work": 4 * 4096,
              "call_spans": [0.02, 0.03, 0.025, 0.04], "trace": summary()}
    assert read("steps_per_s", diffik) == pytest.approx(163840.0)
    assert read("call_ms_p95", diffik) == pytest.approx(38.5)
    assert read("launches_per_call.diffik", diffik) == pytest.approx(2.0)
    assert read("solves_per_s", diffik) is None
