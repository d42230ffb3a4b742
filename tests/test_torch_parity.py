"""The port's success-parity harnesses against the JAX package's scripts.

``optik_tpu_torch/benchmarks/parity_hard.py`` must draw the JAX script's
pose sets (``benchmarks/parity_hard.py:pose_sets``, array-equal for the same
seed), its engine column must be the JAX engine's at f64 on the CPU (equal
found masks on 32 poses per cell, the 32-iteration control included), and
its SLSQP column, fed the engine's restart seeds (bitwise the JAX script's
``fold_in`` table), must find what the JAX script's SLSQP finds with the
same restarts on the same poses (N = 8).  ``parity_native.run`` is driven at
a small size on the CPU, and the ``timing`` helpers the harnesses share
(the solvers' dtype on a device, the host CPU's name) are checked there.
"""

import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optik_tpu import SolverConfig as JaxConfig
from optik_tpu.ops import objective as jax_objective
from optik_tpu.solver import ik as jax_ik

from optik_tpu_torch import Robot, SolverConfig
from optik_tpu_torch.benchmarks import parity_hard, parity_native, \
    parity_scipy, timing

REPO = pathlib.Path(__file__).resolve().parent.parent
N_ENGINE = 32
N_SLSQP = 8


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_hard", REPO / "benchmarks" / "parity_hard.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def both_sets(jax_script):
    return (jax_script.pose_sets(np.random.default_rng(42), N_ENGINE),
            parity_hard.pose_sets(np.random.default_rng(42), N_ENGINE))


def test_pose_sets_equal_jax_script(both_sets):
    ref, got = both_sets
    assert list(got) == list(ref)
    for name, (jrobot, q_ref, x0_ref) in ref.items():
        spec, q, x0 = got[name]
        np.testing.assert_array_equal(q, q_ref)
        np.testing.assert_array_equal(x0, x0_ref)
        for mine, theirs in zip(spec.joint_limits(), jrobot.joint_limits()):
            np.testing.assert_array_equal(mine, theirs)
        np.testing.assert_array_equal(spec.origin_t, jrobot.spec.origin_t)


def _jax_engine_found(jrobot, q, x0, r_total, iters):
    cfg = JaxConfig(max_restarts=r_total, seed_batch=8, max_iters=iters,
                    tol_f=1e-6)
    tr, tt = jrobot.fk_batch(q)
    solve = jax_ik.build_batch_solver(jrobot.spec, cfg, jnp.float64)
    return np.asarray(solve(tr, tt, jnp.asarray(x0)).found)


@pytest.mark.parametrize("budget", list(parity_hard.BUDGETS))
@pytest.mark.parametrize("set_name", ["panda_uniform", "panda_normal",
                                      "ur5_tight"])
def test_engine_column_matches_jax_engine(both_sets, set_name, budget):
    ref, got = both_sets
    jrobot, q, x0 = ref[set_name]
    spec = got[set_name][0]
    robot = Robot(spec, dtype=torch.float64, device="cpu")
    tgt_r, tgt_t = parity_scipy.targets_f64(spec, q)
    line, results = parity_hard.run_cell(
        robot, parity_hard.native_chain(set_name), set_name, budget, tgt_r,
        tgt_t, x0, scipy_column=False)
    bud = parity_hard.BUDGETS[budget]
    want = _jax_engine_found(jrobot, q, x0, bud["restarts"],
                             bud["engine_iters"])
    np.testing.assert_array_equal(results["engine"].found.numpy(), want)
    assert line["engine_success"] == float(want.mean())
    if budget == "weak":
        want32 = _jax_engine_found(jrobot, q, x0, bud["restarts"], 32)
        np.testing.assert_array_equal(
            results["engine_iters32"].found.numpy(), want32)
    assert line["engine_solver"] == "plain"
    assert 0.0 < line["native_success"] <= 1.0
    assert line["scipy_success"] is None
    n_eng = int(want.sum())
    assert (line["both_fail_engine_native"]
            + line["engine_only_fail_vs_native"]) == N_ENGINE - n_eng


def _jax_slsqp(jrobot, tgt_r, tgt_t, x0s, r_total, maxiter):
    """The JAX script's SLSQP column (benchmarks/parity_hard.py), found
    masks and restarts to success."""
    from scipy.optimize import minimize

    params = jrobot.params
    lo, hi = jrobot.joint_limits()
    a = jrobot.num_positions()
    key = jax.random.PRNGKey(42)
    table = np.asarray(jax.vmap(
        lambda i: jax.random.uniform(
            jax.random.fold_in(key, i), (a,), dtype=jnp.float64,
            minval=jnp.asarray(lo), maxval=jnp.asarray(hi)))(
        jnp.arange(r_total)))

    @jax.jit
    def f_and_g(q, tr, tt):
        r, j = jax_objective.residual_and_jacobian(params, q, tr, tt)
        return jnp.dot(r, r), 2.0 * r @ j

    found, used = np.zeros(x0s.shape[0], bool), []
    for i in range(x0s.shape[0]):
        def fun(q, tr=tgt_r[i], tt=tgt_t[i]):
            f, g = f_and_g(jnp.asarray(q), jnp.asarray(tr), jnp.asarray(tt))
            return float(f), np.asarray(g)

        for r_i in range(r_total):
            x = x0s[i] if r_i == 0 else table[r_i]
            res = minimize(fun, x, jac=True, method="SLSQP",
                           bounds=list(zip(lo, hi)),
                           options={"maxiter": maxiter, "ftol": 1e-12})
            if res.fun <= 1e-6:
                found[i] = True
                used.append(r_i + 1)
                break
    return table, found, used


@pytest.mark.parametrize("set_name", ["panda_uniform", "ur5_tight"])
def test_slsqp_column_matches_jax_script(both_sets, set_name):
    pytest.importorskip("scipy")
    ref, got = both_sets
    jrobot, q, x0 = ref[set_name]
    q, x0 = q[:N_SLSQP], x0[:N_SLSQP]
    spec = got[set_name][0]
    bud = parity_hard.BUDGETS["weak"]
    cfg = SolverConfig(max_restarts=bud["restarts"], seed_batch=8,
                       max_iters=bud["engine_iters"], tol_f=1e-6)
    tgt_r, tgt_t = parity_scipy.targets_f64(spec, q)
    jtr, jtt = (np.asarray(v) for v in jrobot.fk_batch(q))
    np.testing.assert_allclose(tgt_r, jtr, rtol=0, atol=1e-14)
    np.testing.assert_allclose(tgt_t, jtt, rtol=0, atol=1e-14)

    table = parity_scipy.restart_table(cfg, spec)
    jtable, jfound, jused = _jax_slsqp(jrobot, jtr, jtt, x0,
                                       bud["restarts"], bud["scipy_maxiter"])
    np.testing.assert_array_equal(table, jtable)
    found, used, nit, _ = parity_scipy.slsqp_column(
        spec, tgt_r, tgt_t, x0, table, bud["restarts"], bud["scipy_maxiter"],
        cfg.tol_f)
    np.testing.assert_array_equal(found, jfound)
    assert used == jused and nit > 0


def test_parity_native_run_on_cpu():
    from optik_tpu_torch.models import asset_path
    from optik_tpu_torch.native import HostChain

    robot = Robot.from_urdf_file(asset_path(parity_native.PANDA[0]),
                                 *parity_native.PANDA[1:],
                                 dtype=parity_native.engine_dtype("cpu"),
                                 device="cpu")
    chain = HostChain.from_urdf_file(asset_path(parity_native.PANDA[0]),
                                     *parity_native.PANDA[1:])
    summary, batches = parity_native.run(robot, chain, 48)
    assert len(batches) == 1 and summary["n_poses"] == 48
    assert summary["kernel_solver"] == "plain" and summary["device"] == "cpu"
    assert summary["kernel_success_rate"] >= 0.9
    assert summary["native_success_rate"] >= 0.9
    found = np.concatenate([b.res.found.numpy() for b in batches])
    assert summary["both_fail"] + summary["kernel_only_fail"] \
        == int((~found).sum())
    assert summary["budget"] == {"max_restarts": 64, "seed_batch": 8,
                                 "max_iters": 32, "tol_f": 1e-6}
    for b in batches:
        res = b.res
        assert bool((res.cost[res.found] <= 1e-6).all())
        r, t = robot.fk_batch(res.x[res.found])
        assert float((r - b.tgt_r[res.found]).abs().max()) <= 2e-3
        assert float((t - b.tgt_t[res.found]).abs().max()) <= 2e-3


def test_engine_dtype_is_the_kernels_on_a_card_and_f64_elsewhere():
    """The harnesses solve at float32 on a CUDA device (the kernel's) and
    at float64 anywhere else; a device name or a torch.device alike."""
    assert timing.engine_dtype("cpu") is torch.float64
    assert timing.engine_dtype(torch.device("cpu")) is torch.float64
    assert timing.engine_dtype("cuda") is torch.float32
    assert timing.engine_dtype(torch.device("cuda", 0)) is torch.float32


def test_host_cpu_names_the_model_and_the_cores():
    """What a native latency stands beside: one line, a non-empty model
    name, then the logical core count."""
    text = timing.host_cpu()
    model, sep, cores = text.rpartition(", ")
    assert sep and cores == f"{os.cpu_count()} logical cores"
    assert model.strip() and "\n" not in text
