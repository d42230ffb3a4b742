"""The port's measuring scripts (``optik_tpu_torch/benchmarks/bench*.py``)
against the JAX package's (the root ``bench.py`` and
``benchmarks/bench_{workloads,latency,scaling,ops}.py``), on the CPU.

  * Inputs: what each port script draws from its seed is array-equal to the
    JAX script's draw sequence, restated here with numpy; targets from the
    port's FK agree with the JAX package's ``Robot.fk_batch`` at f64 within
    1e-12 (the same operations, summed in another order).
  * Results: ``run(device="cpu")`` of ``bench``, ``bench_workloads`` and
    ``bench_ops`` at tiny sizes (B <= 64, one timed pass) gives the JAX
    scripts' ``metric`` names, and success rates, ok rates and
    lane-iterations per solve equal to the JAX package's ``ik_batch`` /
    ``diff_ik_batch`` at f64 on the same inputs: exact, as the found masks
    are equal at f64 (tests/test_torch_lm.py).  bench_ops' SoA ops agree
    with ``optik_tpu.ops.soa`` within 1e-10.
  * Devices: without a card the default device raises ``RuntimeError`` and
    prints nothing; a CPU row says ``"device": "cpu"`` and has no roofline
    share.
  * The SoA functions the harness needs (``mat_to_quat``, ``quat_log``,
    ``mat_log``, ``so3_right_jacobian_from_w``, ``se3_log_from_w``,
    ``se3_log``, ``se3_right_jacobian_blocks``) against
    ``optik_tpu.ops.soa`` at f64, exact and in kernel math mode, on random
    rotations and on angles within 1e-6 of 0 and of pi: relative 1e-10
    (absolute 1e-12 on components near 0), as tests/test_torch_math.py holds
    ``math/so3``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optik_tpu import Robot as JaxRobot
from optik_tpu import SolverConfig as JaxConfig
from optik_tpu.models import asset_path as jax_asset_path
from optik_tpu.models.chain import ChainSpec as JaxChainSpec
from optik_tpu.ops import soa as jax_soa

from optik_tpu_torch import Robot, SolverConfig
from optik_tpu_torch.benchmarks import (bench, bench_latency, bench_ops,
                                        bench_scaling, bench_workloads)
from optik_tpu_torch.models import asset_path
from optik_tpu_torch.ops import kinematics as K
from optik_tpu_torch.ops import soa
from optik_tpu_torch.solver import ik as ik_mod

PANDA = ("panda.urdf", "panda_link0", "panda_hand_tcp")
UR3E = ("ur3e.urdf", "ur_base_link", "ur_ee_link")
WORKLOAD_SIZES = bench_workloads.Sizes(quality=(16,), caps=(8,), ur5=16,
                                       diff_ik=16, mp_chunk=16, mp_chunks=1)
OPS_SIZES = bench_ops.Sizes(lanes=64, diff_ik=16, ik=16)
FK_TOL = 1e-12


def _jax_robot(name, base, ee):
    return JaxRobot.from_urdf_file(jax_asset_path(name), base, ee,
                                   dtype=jnp.float64)


@pytest.fixture(scope="module")
def robots():
    return {"panda": (Robot.from_urdf_file(asset_path(PANDA[0]), *PANDA[1:],
                                           dtype=torch.float64, device="cpu"),
                      _jax_robot(*PANDA)),
            "ur3e": (Robot.from_urdf_file(asset_path(UR3E[0]), *UR3E[1:],
                                          dtype=torch.float64, device="cpu"),
                     _jax_robot(*UR3E))}


def _jax_ur5_tight():
    spec = _jax_robot("ur5.urdf", "base_link", "ee_link").spec
    tight = JaxChainSpec(
        joint_names=spec.joint_names, origin_r=spec.origin_r,
        origin_t=spec.origin_t, axis=spec.axis, prismatic=spec.prismatic,
        lower=np.full(6, -np.pi / 2), upper=np.full(6, np.pi / 2),
        tip_r=spec.tip_r, tip_t=spec.tip_t)
    return JaxRobot(tight, dtype=jnp.float64)


def _targets_agree(tr, tt, jrobot, q):
    jr, jt = jrobot.fk_batch(q)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                               atol=FK_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=FK_TOL)


def _equal_draws(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --- (a) the draws ------------------------------------------------------------


def test_bench_batches_are_the_jax_scripts(robots):
    """bench.py:76-99: default_rng(42); per batch (the warm-up's first) the
    targets' configurations, then the seeds."""
    robot, jrobot = robots["panda"]
    lo, hi = jrobot.joint_limits()
    want = np.random.default_rng(42)
    got = np.random.default_rng(42)
    for _ in range(3):
        q = want.uniform(lo, hi, size=(16, 7))
        x0 = want.uniform(lo, hi, size=(16, 7))
        tr, tt, x0_t = bench.make_batch(robot, got, 16)
        np.testing.assert_array_equal(x0_t.numpy(), x0)
        _targets_agree(tr, tt, jrobot, q)


def test_workload_draws_are_the_jax_scripts(robots):
    """benchmarks/bench_workloads.py:99-263: one default_rng(0) through the
    Quality batches, the UR5's, the diff-IK starts and the motion-planning
    warm-up and chunks."""
    robot, jrobot = robots["panda"]
    lo, hi = jrobot.joint_limits()
    sizes = bench_workloads.Sizes(quality=(8, 16), caps=(8, 2), ur5=8,
                                  diff_ik=8, mp_chunk=4, mp_chunks=2)
    rng = np.random.default_rng(0)
    want = []
    for b in sizes.quality:
        want += [rng.uniform(lo, hi, size=(b, 7)),
                 rng.uniform(lo, hi, size=(b, 7))]
    want += [rng.uniform(-np.pi / 2, np.pi / 2, size=(sizes.ur5, 6)),
             rng.uniform(-np.pi / 2, np.pi / 2, size=(sizes.ur5, 6))]
    want.append(rng.uniform(lo, hi, size=(sizes.diff_ik, 7)))
    for _ in range(1 + sizes.mp_chunks):
        want += [rng.uniform(lo, hi, size=(sizes.mp_chunk, 7)),
                 rng.uniform(lo, hi, size=(sizes.mp_chunk, 7))]
    d = bench_workloads.draws(np.random.default_rng(0), lo, hi, sizes)
    got = [a for pair in d["quality"] for a in pair] + list(d["ur5"]) \
        + [d["diff_ik"]] + [a for pair in d["mp"] for a in pair]
    _equal_draws(got, want)

    tr, tt, x0 = bench_workloads.problem(robot, *d["quality"][1])
    np.testing.assert_array_equal(x0.numpy(), d["quality"][1][1])
    _targets_agree(tr, tt, jrobot, d["quality"][1][0])
    spec = bench_workloads.tight_ur5(
        Robot.from_urdf_file(asset_path("ur5.urdf"), "base_link", "ee_link",
                             dtype=torch.float64, device="cpu").spec)
    ur5 = Robot(spec, dtype=torch.float64, device="cpu")
    jur5 = _jax_ur5_tight()
    for mine, theirs in zip(ur5.joint_limits(), jur5.joint_limits()):
        np.testing.assert_array_equal(mine, theirs)
    tr, tt, _ = bench_workloads.problem(ur5, *d["ur5"])
    _targets_agree(tr, tt, jur5, d["ur5"][0])
    x0, v_we, v_max = bench_workloads.diff_ik_inputs(robot, d["diff_ik"])
    np.testing.assert_array_equal(x0.numpy(), d["diff_ik"])
    np.testing.assert_array_equal(
        v_we.numpy(), np.tile(np.array([0, 0, 0.1, 0, 0, 0.0]), (8, 1)))
    np.testing.assert_array_equal(v_max.numpy(), np.full((8, 7), 0.75))


def test_latency_draws_are_the_jax_scripts(robots):
    """benchmarks/bench_latency.py:46-102: default_rng(7); n scalar
    targets' configurations, n scalar seeds, then per batch size and for
    the B = 8 split the targets' configurations and the seeds."""
    robot, jrobot = robots["panda"]
    lo, hi = jrobot.joint_limits()
    rng = np.random.default_rng(7)
    n = 4
    want = [rng.uniform(lo, hi) for _ in range(n)]
    want += [rng.uniform(lo, hi) for _ in range(n)]
    for b in (1, 64, 256, 8):
        want += [rng.uniform(lo, hi, size=(b, 7)),
                 rng.uniform(lo, hi, size=(b, 7))]
    d = bench_latency.draws(np.random.default_rng(7), lo, hi, n)
    got = d["scalar_q"] + d["scalar_x0"] \
        + [a for pair in d["batches"] for a in pair] + list(d["split"])
    _equal_draws(got, want)
    for q in d["scalar_q"]:
        np.testing.assert_allclose(robot.fk(q), np.asarray(jrobot.fk(q)),
                                   rtol=0, atol=FK_TOL)


def test_scaling_draws_are_the_jax_scripts(robots):
    """benchmarks/bench_scaling.py:202-272: default_rng(0); per device count
    the ik_sharded batch of 1,024 n, then per count the cascade batch of
    4,096 n."""
    _, jrobot = robots["panda"]
    lo, hi = jrobot.joint_limits()
    counts = [1, 2]
    rng = np.random.default_rng(0)
    want = []
    for per in (1024, 4096):
        for n in counts:
            want += [rng.uniform(lo, hi, size=(per * n, 7)),
                     rng.uniform(lo, hi, size=(per * n, 7))]
    d = bench_scaling.draws(np.random.default_rng(0), lo, hi, counts)
    _equal_draws([a for key in ("sharded", "cascade") for pair in d[key]
                  for a in pair], want)


def test_ops_draws_are_the_jax_scripts(robots):
    """benchmarks/bench_ops.py:353-403: default_rng(0); the configurations,
    the targets' configurations, the diff-IK starts and commands."""
    robot, jrobot = robots["ur3e"]
    lo, hi = jrobot.joint_limits()
    rng = np.random.default_rng(0)
    want = [rng.uniform(lo, hi, size=(64, 6)),
            rng.uniform(lo, hi, size=(64, 6)),
            rng.uniform(lo, hi, size=(16, 6)),
            rng.standard_normal((16, 6))]
    d = bench_ops.draws(np.random.default_rng(0), lo, hi, 6, OPS_SIZES)
    _equal_draws([d["q"], d["qt"], d["x0"], d["v_we"]], want)
    tr, tt = robot.fk_batch(d["qt"])
    _targets_agree(tr, tt, jrobot, d["qt"])


# --- (b) the rows on the CPU against the JAX package at f64 -------------------


def _jax_ik(jrobot, cfg, q, x0):
    tr, tt = jrobot.fk_batch(q)
    res = jrobot.ik_batch(cfg, tr, tt, x0, validate_seeds=False)
    b = q.shape[0]
    return (round(float(np.mean(np.asarray(res.found))), 4),
            round(float(res.lane_iters) / b, 1), res)


@pytest.fixture(scope="module")
def bench_row():
    return bench.run("cpu", b=16, sets=1, iters=1, reps=1)


def test_bench_row_matches_jax(robots, bench_row):
    _, jrobot = robots["panda"]
    lo, hi = jrobot.joint_limits()
    rng = np.random.default_rng(42)
    for _ in range(2):  # the warm-up batch, then the one timed batch
        q = rng.uniform(lo, hi, size=(16, 7))
        x0 = rng.uniform(lo, hi, size=(16, 7))
    success, li, _ = _jax_ik(jrobot, JaxConfig(**bench.CONFIG), q, x0)
    row = bench_row
    assert row["metric"] == "panda_ik_solves_per_s"
    assert row["success_rate"] == success
    assert row["lane_iters_per_solve"] == li
    # Every field of bench.py:264-301 that is not the TPU's.
    for key in ("value", "unit", "vs_baseline", "spread", "spread_alert",
                "synced_solves_per_s", "set_medians_ms", "set_pipelined_ms",
                "p50_pipelined_batch_ms", "p50_batch_latency_ms",
                "p90_batch_latency_ms", "p50_cold_ms", "p90_cold_ms",
                "lane_iters_spread", "iters_to_converge_hist", "batch",
                "seeds", "restarts", "max_iters", "solver", "chips",
                "device", "flops_per_lane_iter", "lane_iters_p50"):
        assert key in row, key
    assert row["solver"] == "ik_batch/plain"
    assert (row["batch"], row["seeds"], row["restarts"],
            row["max_iters"]) == (16, 8, 64, 32)
    assert sum(row["iters_to_converge_hist"].values()) \
        == round(16 * success)


def test_cpu_row_names_the_cpu_and_has_no_roofline_share(bench_row):
    assert bench_row["device"] == "cpu"
    for key in ("fp32_util", "fp32_peak_gflops", "model_gflops_per_s",
                "bound_ms", "bound_by", "card"):
        assert key not in bench_row


def test_workload_rows_match_jax(robots):
    robot, jrobot = robots["panda"]
    rows = bench_workloads.run("cpu", WORKLOAD_SIZES, depth=1, sets=1)
    assert [r["metric"] for r in rows] == [
        "panda_quality_256seed_solves_per_s",
        "panda_quality_256seed_cap_solves_per_s",
        "ur5_tight_limits_solves_per_s", "diff_ik_steps_per_s",
        "motion_planning_solves_per_s"]
    assert all(r["device"] == "cpu" for r in rows)
    lo, hi = jrobot.joint_limits()
    d = bench_workloads.draws(np.random.default_rng(0), lo, hi,
                              WORKLOAD_SIZES)
    cfg_q = JaxConfig.create("quality", **bench_workloads.QUALITY)
    success, li, full = _jax_ik(jrobot, cfg_q, *d["quality"][0])
    assert (rows[0]["success_rate"], rows[0]["lane_iters_per_solve"]) \
        == (success, li)
    success, _, _ = _jax_ik(jrobot, cfg_q.replace(quality_max_successes=8),
                            *d["quality"][0])
    assert rows[1]["cap"] == 8 and rows[1]["success_rate"] == success
    success, _, _ = _jax_ik(_jax_ur5_tight(),
                            JaxConfig(**bench_workloads.UR5_CONFIG),
                            *d["ur5"])
    assert rows[2]["success_rate"] == success
    x0 = d["diff_ik"]
    v_we = np.tile(np.array(bench_workloads.V_WE), (16, 1))
    v_max = np.full((16, 7), bench_workloads.V_MAX)
    ok = np.asarray(jrobot.diff_ik_batch(x0, v_we, v_max, rescue=False)[2])
    ok_rescued = np.asarray(jrobot.diff_ik_batch(x0, v_we, v_max)[2])
    assert rows[3]["ok_rate"] == round(float(ok.mean()), 4)
    assert rows[3]["ok_rate_rescued"] == round(float(ok_rescued.mean()), 4)
    success, _, _ = _jax_ik(jrobot, JaxConfig(**bench_workloads.MP_CONFIG),
                            *d["mp"][1])
    assert rows[4]["success_rate"] == success and rows[4]["poses"] == 16


def test_ops_rows_and_soa_ops_match_jax(robots):
    robot, jrobot = robots["ur3e"]
    rows = bench_ops.run("cpu", OPS_SIZES, n=1, n_solve=1)
    assert [r["metric"] for r in rows] == [
        f"{op}_ops_per_s" for op in ("fk", "objective", "gradient",
                                     "joint_jacobian", "diff_ik", "ik")]
    assert [r["batch"] for r in rows] == [64, 64, 64, 64, 16, 16]
    assert all(r["device"] == "cpu" for r in rows)
    # The timed SoA ops against the JAX script's, on its inputs.
    lo, hi = jrobot.joint_limits()
    d = bench_ops.draws(np.random.default_rng(0), lo, hi, 6, OPS_SIZES)
    q = d["q"]
    tr, tt = robot.fk_batch(d["qt"])
    jtr, jtt = jrobot.fk_batch(d["qt"])
    consts = jax_soa.chain_constants(jrobot.spec)
    jq = [jnp.asarray(q[:, j]) for j in range(6)]
    tm = [[jtr[:, i, j] for j in range(3)] for i in range(3)]
    tv = [jtt[:, i] for i in range(3)]
    _, r_ee, t_ee = jax_soa.fk_joints(consts, jq)
    xr = jax_soa.mat_mul(jax_soa.mat_t(tm), r_ee)
    xt = jax_soa.mat_tvec(tm, jax_soa.vec_sub(t_ee, tv))
    e = jax_soa.se3_log(xr, xt)
    e_g, jt = jax_soa.residual_and_jtask(consts, jq, tm, tv)
    want = {"fk": sum(t_ee), "objective": jax_soa.vec_dot(e, e),
            "gradient": [2.0 * sum(e_g[i] * jt[i][p] for i in range(6))
                         for p in range(6)]}
    ops = bench_ops.soa_ops(robot)
    qt = torch.tensor(q)
    got = {"fk": ops["fk"](qt), "objective": ops["objective"](qt, tr, tt),
           "gradient": ops["gradient"](qt, tr, tt)}
    for name in want:
        np.testing.assert_allclose(_flat(got[name]), _flat(want[name]),
                                   rtol=1e-10, atol=1e-12, err_msg=name)


# --- (c) devices ----------------------------------------------------------------


@pytest.mark.parametrize("script", [bench, bench_workloads, bench_latency,
                                    bench_ops, bench_scaling],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_default_device_raises_without_a_card(script, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        script.run()
    with pytest.raises(RuntimeError):
        script.main([])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("entry", ["ik.build_batch_solver",
                                   "ChainParams.from_spec"])
def test_plain_loop_constructors_need_a_device(entry):
    """The plain loop's solver and chain constants name no default device,
    so a harness that leaves it out fails instead of timing the host."""
    spec = Robot.from_urdf_file(asset_path(PANDA[0]), *PANDA[1:],
                                device="cpu").spec
    with pytest.raises(TypeError, match="device"):
        if entry == "ik.build_batch_solver":
            ik_mod.build_batch_solver(spec, SolverConfig(), torch.float64)
        else:
            K.ChainParams.from_spec(spec, torch.float64)


# --- (d) the SoA functions against optik_tpu.ops.soa -----------------------------


def _rotation_vectors(rng):
    """Rotation vectors: random angles in (0, pi), and angles 0, 1e-7,
    1e-6, pi - 1e-6, pi - 1e-7 and pi about random axes."""
    n_rand = 24
    special = np.array([0.0, 1e-7, 5e-7, 1e-6, np.pi - 1e-6, np.pi - 1e-7,
                        np.pi])
    angles = np.concatenate([rng.uniform(0.0, np.pi, n_rand), special])
    axes = rng.standard_normal((angles.size, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return axes * angles[:, None]


def _rotations(w):
    """Exact Rodrigues at f64: (N, 3, 3)."""
    theta = np.linalg.norm(w, axis=1)
    k = w / np.where(theta > 0, theta, 1.0)[:, None]
    kx = np.zeros((w.shape[0], 3, 3))
    kx[:, 0, 1], kx[:, 0, 2] = -k[:, 2], k[:, 1]
    kx[:, 1, 0], kx[:, 1, 2] = k[:, 2], -k[:, 0]
    kx[:, 2, 0], kx[:, 2, 1] = -k[:, 1], k[:, 0]
    s, c = np.sin(theta)[:, None, None], np.cos(theta)[:, None, None]
    return np.eye(3) + s * kx + (1 - c) * kx @ kx


def _quaternions(w, rng):
    """Unit quaternions (x, y, z, w) of the rotation vectors, on both
    covers (a random half negated)."""
    theta = np.linalg.norm(w, axis=1)
    k = w / np.where(theta > 0, theta, 1.0)[:, None]
    q = np.concatenate([k * np.sin(theta / 2)[:, None],
                        np.cos(theta / 2)[:, None]], axis=1)
    return q * np.where(rng.random(w.shape[0]) < 0.5, -1.0, 1.0)[:, None]


def _comps(a, lib):
    """(N, ...) array -> nested lists of (N,) components."""
    if a.ndim == 1:
        return lib(a)
    return [_comps(a[:, i], lib) for i in range(a.shape[1])]


def _flat(v):
    if isinstance(v, (list, tuple)):
        return np.concatenate([_flat(u) for u in v])
    return np.asarray(v, dtype=np.float64).reshape(1, -1)


SOA_FUNCTIONS = {
    "mat_to_quat": lambda m, r, w, t, q: m.mat_to_quat(r),
    "quat_log": lambda m, r, w, t, q: m.quat_log(q),
    "mat_log": lambda m, r, w, t, q: m.mat_log(r),
    "so3_right_jacobian_from_w":
        lambda m, r, w, t, q: m.so3_right_jacobian_from_w(w),
    "se3_log_from_w": lambda m, r, w, t, q: m.se3_log_from_w(w, t),
    "se3_log": lambda m, r, w, t, q: m.se3_log(r, t),
    "se3_right_jacobian_blocks":
        lambda m, r, w, t, q: m.se3_right_jacobian_blocks(w, t),
}
# mat_to_quat has no transcendental, so no kernel math mode.
SOA_CASES = [(name, approx) for name in SOA_FUNCTIONS
             for approx in (False, True)
             if not (approx and name == "mat_to_quat")]


class _PortSoa:
    """The port's functions with the kernel-math flag bound, under the JAX
    module's call signatures."""

    def __init__(self, approx):
        self.approx = approx

    def __getattr__(self, name):
        fn = getattr(soa, name)
        if name == "mat_to_quat":
            return fn
        return lambda *a: fn(*a, approx=self.approx)


@pytest.mark.parametrize("name,approx", SOA_CASES,
                         ids=[f"{n}-{'kernel' if a else 'exact'}"
                              for n, a in SOA_CASES])
def test_soa_function_matches_jax(name, approx):
    fn = SOA_FUNCTIONS[name]
    rng = np.random.default_rng(11)
    w = _rotation_vectors(rng)
    r, q = _rotations(w), _quaternions(w, rng)
    t = rng.standard_normal((w.shape[0], 3))
    args = (r, w, t, q)
    got = fn(_PortSoa(approx), *(_comps(a, torch.tensor) for a in args))
    if approx:
        with jax_soa.approx_atan2():
            want = fn(jax_soa, *(_comps(a, jnp.asarray) for a in args))
    else:
        want = fn(jax_soa, *(_comps(a, jnp.asarray) for a in args))
    got, want = _flat(got), _flat(want)
    assert got.shape == want.shape
    # Kernel math's sin(pi) is exactly 0, so at an angle of exactly pi the
    # inverse right Jacobian's coefficient is 0/0 on both sides; nowhere
    # else is a component not finite.
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isfinite(got).all() or (approx and "jacobian" in name)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_soa_functions_on_the_special_angles_are_right():
    """The Taylor branches (the identity) and the double cover (pi): the
    log of an exact rotation returns its rotation vector."""
    rng = np.random.default_rng(12)
    w = _rotation_vectors(rng)
    far = np.linalg.norm(w, axis=1) < np.pi - 1e-6  # log is unique there
    got = _flat(soa.mat_log(_comps(_rotations(w), torch.tensor))).T
    np.testing.assert_allclose(got[far], w[far], rtol=0, atol=1e-9)
    got_q = _flat(soa.quat_log(_comps(_quaternions(w, rng),
                                      torch.tensor))).T
    np.testing.assert_allclose(got_q[far], w[far], rtol=0, atol=1e-9)
    assert np.allclose(np.linalg.norm(got[~far], axis=1), np.pi, atol=1e-6)
