"""The plain versions of the port's three probe kernels against the same
bodies evaluated with JAX on the CPU.

The JAX originals are closures inside ``main()`` of
``benchmarks/bench_vpu_peak.py``, ``benchmarks/exp_mosaic_probe.py`` and
``benchmarks/exp_bisect.py``, so this file restates their bodies and runs
them with ``jax.numpy`` (and ``optik_tpu.solver.lm_soa.solve_soa`` for the
LM variants).  Inputs come from numpy seeds and cross as numpy arrays.

Tolerances: the FP32 bodies run in float32 on both sides; XLA:CPU may
contract a multiply-add where torch rounds twice, one ulp per operation, so
3 trips of at most 16 chained operations stay within a relative 1e-5 (the
independent chains within 1e-6).  The probe outputs are integers: exact.
The LM variants run at float64 in kernel math mode on both sides, as the
batch-solver parity of tests/test_torch_lm.py does: x and f within 1e-8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optik_tpu import Robot as JaxRobot
from optik_tpu import SolverConfig as JaxConfig
from optik_tpu.models import asset_path
from optik_tpu.ops import soa as jax_soa
from optik_tpu.solver import ik as jax_ik
from optik_tpu.solver import lm_soa as jax_lm_soa

from optik_tpu_torch.benchmarks import (bench_fp32_peak, exp_bisect,
                                        exp_warp_probe)
from optik_tpu_torch.models import ChainSpec

C = bench_fp32_peak.C


def _jax_body(name, xs):
    """The bodies of benchmarks/bench_vpu_peak.py:105-133."""
    if name == "ilp8":
        return [x * 1.000001 + 1e-7 for x in xs]
    if name == "serial":
        y = xs[0]
        for _ in range(16):
            y = y * 1.000001 + 1e-7
        return [y] + list(xs[1:])
    out = []
    for i, x in enumerate(xs):
        y = x * 1.000001 + 1e-7
        y = y + xs[(i + 1) % C] * 1e-9
        if i % 4 == 0:
            y = jnp.where(y > x, y, x)
        out.append(y)
    out[0] = out[0] / (out[1] + 2.0)
    return out


@pytest.mark.parametrize("name,rtol", [("ilp8", 1e-6), ("serial", 1e-5),
                                       ("mix", 1e-6)])
def test_fp32_peak_plain_bodies_match_jax(name, rtol):
    x = bench_fp32_peak.make_input(64, "cpu")
    got = bench_fp32_peak.run_body(name, x, 3)
    xs = [jnp.asarray(x[c].numpy(), jnp.float32) for c in range(C)]
    for _ in range(3):
        xs = _jax_body(name, xs)
    assert got.dtype == torch.float32 and got.shape == (C, 64)
    np.testing.assert_allclose(got.numpy(), np.stack(xs), rtol=rtol, atol=0)
    assert bench_fp32_peak.OPS_PER_TRIP == {"ilp8": 16, "serial": 32,
                                            "mix": 38}
    # A CPU tensor never reaches the kernel launcher.
    with pytest.raises(ValueError, match="float32 CUDA"):
        bench_fp32_peak.run_kernel(name, x, 3)


def _jax_probe(name):
    """The kernel bodies of benchmarks/exp_mosaic_probe.py:38-75."""
    s, p = exp_warp_probe.S, exp_warp_probe.P
    if name == "iota_dim0":
        return jax.lax.broadcasted_iota(jnp.int32, (s, p), 0)
    if name == "iota_dim1":
        return jax.lax.broadcasted_iota(jnp.int32, (s, p), 1)
    if name == "iota_s1_broadcast":
        return jnp.broadcast_to(
            jax.lax.broadcasted_iota(jnp.int32, (s, 1), 0), (s, p))
    if name == "zeros_i32":
        return jnp.zeros((s, p), jnp.int32)
    if name == "int8_store":
        return (jnp.zeros((s, p), jnp.float32) > 1).astype(jnp.int8)
    if name == "while_i32_carry":
        x, _ = jax.lax.while_loop(
            lambda c: c[1] < 4, lambda c: (c[0] + 1, c[1] + 1),
            (jnp.zeros((s, p), jnp.int32), jnp.zeros((), jnp.int32)))
        return x

    def body(c):
        x, m, it = c
        m2 = m | (x > 2.0)
        return jnp.where(m2 > 0, x, x + 1.0), m2.astype(jnp.int32), it + 1

    _, m, _ = jax.lax.while_loop(
        lambda c: (c[2] < 8) & ~jnp.all(c[1] > 0), body,
        (jnp.zeros((s, p), jnp.float32), jnp.zeros((s, p), jnp.int32),
         jnp.zeros((), jnp.int32)))
    return m


@pytest.mark.parametrize("name", exp_warp_probe.CASES)
def test_warp_probe_plain_cases_match_jax(name):
    got = exp_warp_probe.run_case(name, "cpu")
    want = np.asarray(_jax_probe(name))
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_warp_probe_run_all_and_library_cases_on_cpu():
    rows = exp_warp_probe.run_all("cpu")
    assert list(rows) == list(exp_warp_probe.CASES)
    assert all(r["exact"] and r["max_abs_err"] == 0.0 for r in rows.values())
    for name in exp_warp_probe.LIBRARY_CASES:
        assert torch.equal(exp_warp_probe.library_case(name),
                           exp_warp_probe.plain_case(name))
    with pytest.raises(ValueError, match="no single call"):
        exp_warp_probe.library_case("while_i32_carry")


def test_warp_probe_prepared_library_calls_equal_the_single_calls():
    names = exp_warp_probe.LIBRARY_CASES
    got = exp_warp_probe.prepare_library(names, "cpu")()
    assert len(got) == len(names)
    for name, out in zip(names, got):
        assert torch.equal(out, exp_warp_probe.library_case(name, "cpu"))
    with pytest.raises(ValueError, match="no single call"):
        exp_warp_probe.prepare_library(("int8_store",), "cpu")


def test_warp_probe_rejects_unknown_case_and_cpu_launch():
    with pytest.raises(ValueError, match="no probe case"):
        exp_warp_probe.plain_case("iota_dim2")
    with pytest.raises(ValueError, match="CUDA device"):
        exp_warp_probe.run_kernel("iota_dim0", "cpu")


@pytest.mark.parametrize("name,max_iters,group_stop", exp_bisect.VARIANTS)
def test_bisect_plain_variants_match_jax(name, max_iters, group_stop):
    jr = JaxRobot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float64)
    spec = ChainSpec.from_arrays(dataclasses.asdict(jr.spec))
    s, p, a = exp_bisect.S, 8, 7
    rng = np.random.default_rng(0)
    lo, hi = jr.joint_limits()
    tr, tt = jr.fk_batch(rng.uniform(lo, hi, size=(p, a)))
    tr, tt = np.asarray(tr), np.asarray(tt)
    seeds = rng.uniform(lo, hi, size=(s, p, a))

    prob = exp_bisect.Problem(
        spec, torch.tensor(tr), torch.tensor(tt), torch.tensor(seeds),
        torch.tensor(seeds[0]))
    x, f = exp_bisect.run_variant(prob, max_iters, group_stop)
    assert x.shape == (a, s, p) and f.shape == (s, p)

    # benchmarks/exp_bisect.py:50-62: lm_loop without reseeding, R = S = 8,
    # kernel math mode; here on the (P, S) lane grid of solve_soa.
    opts = jax_ik.options_from_config(
        JaxConfig(max_restarts=s, seed_batch=s, max_iters=max_iters))
    with jax_soa.approx_atan2():
        ref = jax_lm_soa.solve_soa(
            jax_soa.chain_constants(jr.spec),
            [float(v) for v in jr.spec.lower],
            [float(v) for v in jr.spec.upper], opts,
            jnp.asarray(seeds.transpose(1, 0, 2)), jnp.asarray(tr)[:, None],
            jnp.asarray(tt)[:, None], total_restarts=s,
            success_stops_group=group_stop)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref.x).transpose(2, 1, 0),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(f.numpy(), np.asarray(ref.f).T, rtol=0,
                               atol=1e-8)
    # The group stop freezes a pose at its first success, so it changes
    # which lanes converge.
    done = np.asarray(ref.success)
    assert done.any(axis=1).sum() >= (p - 2 if max_iters == 32 else 0)
    if not group_stop:
        assert done.sum() > done.any(axis=1).sum()


def test_bisect_reseed_case_runs_through_the_solver():
    spec = exp_bisect.panda_spec()
    from optik_tpu_torch import Robot

    robot = Robot(spec, device="cpu")
    prob = exp_bisect.make_problem(robot.fk_batch, spec, "cpu")
    assert prob.seeds.shape == (exp_bisect.S, exp_bisect.P, 7)
    assert prob.seeds.dtype == torch.float32
    small = prob._replace(tgt_r=prob.tgt_r[:16], tgt_t=prob.tgt_t[:16],
                          x0=prob.x0[:16])
    res = exp_bisect.reseed_2round(small)
    assert res.found.shape == (16,) and int(res.found.sum()) >= 14
