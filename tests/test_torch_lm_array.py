"""The port's array-path LM (``solver/lm.solve``) and its restart helpers
(``solver/ik``: ``sample_bounds``, ``restart_seeds``, ``ik_one``,
``ik_batch``) against the JAX package's, at f64 on shared numpy inputs.

Limits: restart seeds and sampling bounds bitwise (the same threefry
stream); found masks and iteration counts equal; x within 1e-8 and costs
within 1e-12 (torch and XLA round a few operations differently and ~30
accepted LM steps amplify that, as in tests/test_torch_lm.py).  Within the
port, the SoA loop against this oracle with the limits of
tests/test_soa.py (the two evaluate the cost by different formulas, so a
borderline lane may part): success on >= 90% of lanes alike, x within 1e-5
where both converged; the facade's Quality solve equals ``ik_one``'s
within 1e-5.
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
from optik_tpu.solver import ik as jax_ik
from optik_tpu.solver import lm as jax_lm

from optik_tpu_torch import Robot, SolverConfig
from optik_tpu_torch.models import ChainSpec
from optik_tpu_torch.ops import kinematics as K
from optik_tpu_torch.ops import soa
from optik_tpu_torch.solver import ik, lm, lm_soa

B = 4


@pytest.fixture(scope="module")
def panda():
    jr = JaxRobot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float64)
    spec = ChainSpec.from_arrays(dataclasses.asdict(jr.spec))
    return jr, spec, K.ChainParams.from_spec(spec, torch.float64, device="cpu")


def _targets(jr, seed, b=B):
    rng = np.random.default_rng(seed)
    lo, hi = jr.joint_limits()
    tr, tt = jr.fk_batch(rng.uniform(lo, hi, size=(b, 7)))
    return np.asarray(tr), np.asarray(tt), rng.uniform(lo, hi, size=(b, 7))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_restart_seeds_and_bounds_are_jax_bitwise(panda, dtype):
    jr, spec, _ = panda
    params = K.ChainParams.from_spec(spec, getattr(torch, dtype),
                                     device="cpu")
    jparams = jr.params
    x0 = np.linspace(-0.5, 0.5, 7).astype(dtype)
    got = ik.restart_seeds(params, torch.tensor(x0), 42, 12)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = jax_ik.restart_seeds(
            jax.tree.map(lambda v: jnp.asarray(v, dtype), jparams),
            jnp.asarray(x0), jax.random.PRNGKey(42), 12)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for g, r in zip(ik.sample_bounds(params),
                    jax_ik.sample_bounds(jax.tree.map(
                        lambda v: jnp.asarray(v, dtype), jparams))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("targets", ["per_lane", "broadcast"])
def test_lm_solve_matches_jax(panda, targets):
    jr, _, params = panda
    tr, tt, x0 = _targets(jr, 1, b=8)
    if targets == "broadcast":
        tr, tt = tr[0], tt[0]
    opts = ik.options_from_config(SolverConfig(max_iters=48))
    got = lm.solve(params, torch.tensor(x0), torch.tensor(tr),
                   torch.tensor(tt), opts)
    ref = jax_lm.solve(jr.params, jnp.asarray(x0), jnp.asarray(tr),
                       jnp.asarray(tt), jax_ik.options_from_config(
                           JaxConfig(max_iters=48)))
    success = np.asarray(ref.success)
    assert success.sum() >= 2  # the comparison exercises real solves
    np.testing.assert_array_equal(got.success.numpy(), success)
    assert got.iters == int(ref.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.f.numpy(), np.asarray(ref.f), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("mode", ["speed", "quality"])
def test_ik_one_and_ik_batch_match_jax(panda, mode):
    jr, _, params = panda
    tr, tt, x0 = _targets(jr, 2)
    kw = dict(max_restarts=8, max_iters=32)
    cfg, jcfg = SolverConfig.create(mode, **kw), JaxConfig.create(mode, **kw)
    got = ik.ik_batch(params, cfg, torch.tensor(tr), torch.tensor(tt),
                      torch.tensor(x0))
    ref = jax_ik.ik_batch(jr.params, jcfg, jnp.asarray(tr), jnp.asarray(tt),
                          jnp.asarray(x0))
    found = np.asarray(ref.found)
    assert found.sum() >= B - 1
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_allclose(got.x.numpy()[found], np.asarray(ref.x)[found],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy()[found],
                               np.asarray(ref.cost)[found], rtol=0,
                               atol=1e-12)
    one = ik.ik_one(params, cfg, torch.tensor(tr[0]), torch.tensor(tt[0]),
                    torch.tensor(x0[0]))
    ref1 = jax_ik.ik_one(jr.params, jcfg, jnp.asarray(tr[0]),
                         jnp.asarray(tt[0]), jnp.asarray(x0[0]))
    assert one.x.shape == (7,) and bool(one.found) == bool(ref1.found)
    np.testing.assert_allclose(one.x.numpy(), np.asarray(ref1.x), rtol=0,
                               atol=1e-8)
    # ik_one is ik_batch at B = 1.
    assert bool(one.found) == bool(got.found[0])
    torch.testing.assert_close(one.x, got.x[0], rtol=0, atol=1e-12)


def test_soa_loop_matches_the_array_oracle(panda):
    """tests/test_soa.py's contract on the port: one restart per lane
    through the SoA loop and through lm.solve."""
    jr, spec, params = panda
    tr, tt, _ = _targets(jr, 3, b=8)
    lo, hi = jr.joint_limits()
    x0 = torch.tensor(np.clip(np.zeros((8, 7)), lo, hi))
    opts = ik.options_from_config(SolverConfig(max_restarts=1))
    ref = lm.solve(params, x0, torch.tensor(tr), torch.tensor(tt), opts)
    got = lm_soa.solve_soa(soa.chain_constants(spec),
                           [float(v) for v in lo], [float(v) for v in hi],
                           opts, x0, torch.tensor(tr), torch.tensor(tt))
    assert float((got.success == ref.success).float().mean()) >= 0.9
    both = got.success & ref.success
    assert bool(both.any())
    torch.testing.assert_close(got.x[both], ref.x[both], rtol=0, atol=1e-5)


def test_robot_quality_ik_matches_ik_one(panda):
    jr, spec, params = panda
    robot = Robot(spec, dtype=torch.float64, device="cpu")
    tr, tt, _ = _targets(jr, 4)
    lo, hi = jr.joint_limits()
    x0 = np.clip(np.zeros(7), lo, hi)
    cfg = SolverConfig.create("quality", max_restarts=8)
    for i in range(B):
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = tr[i], tt[i]
        sol = robot.ik(cfg, m, x0)
        ref = ik.ik_one(params, cfg, torch.tensor(tr[i]), torch.tensor(tt[i]),
                        torch.tensor(x0))
        assert (sol is not None) == bool(ref.found)
        if sol is not None:
            assert sol[1] <= cfg.tol_f * (1 + 1e-6)
            np.testing.assert_allclose(sol[0], ref.x.numpy(), atol=1e-5)
