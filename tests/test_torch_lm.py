"""The port's LM solvers against the JAX package's, on shared inputs.

  * ``solver.ik.build_batch_solver`` (the plain torch loop) against the JAX
    XLA path at f64: equal found masks, equal winners (Speed: the winning
    restart index; Quality: the winning seed distance, within 1e-8), equal
    iterations-to-converge of each winner, x within 1e-8.  Torch and XLA
    order and fuse the float operations differently (last-bit
    differences), and ~30 accepted LM steps amplify that; 1e-8 is far below
    any solution-changing error.  The XLA path does not return its winner
    key, so the test wraps its ``_select`` to report it (``sel_key``, as the
    JAX kernel path does); nothing in the JAX package changes.
  * ``ops.cuda.lm_kernel.solve_plain`` (the kernel's plain version, CPU)
    against the Pallas kernel in interpret mode, both in kernel math mode at
    f32.  XLA:CPU contracts multiply-adds into FMAs and torch eager does
    not, so f32 trajectories part at the rounding level, and an attempt
    stops anywhere inside tol_f = 1e-6 (a residual of ~1e-3).  So: found
    masks differ on at most 1 of 16 poses, x agrees within 1e-3 where both
    chose the same winning restart, and every found cost is <= tol_f.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optik_tpu import Robot as JaxRobot
from optik_tpu import SolutionMode as JaxMode
from optik_tpu import SolverConfig as JaxConfig
from optik_tpu.models import asset_path
from optik_tpu.ops.pallas import lm_kernel as jax_kernel
from optik_tpu.solver import ik as jax_ik

from optik_tpu_torch import SolverConfig
from optik_tpu_torch.models import ChainSpec
from optik_tpu_torch.ops.cuda import lm_kernel
from optik_tpu_torch.solver import ik

B = 16


@pytest.fixture(scope="module")
def panda():
    jr = JaxRobot.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                 "panda_hand_tcp", dtype=jnp.float64)
    return jr, ChainSpec.from_arrays(dataclasses.asdict(jr.spec))


def _problem(jr, seed, dtype):
    rng = np.random.default_rng(seed)
    lo, hi = jr.joint_limits()
    tr, tt = jr.fk_batch(rng.uniform(lo, hi, size=(B, 7)))
    x0 = rng.uniform(lo, hi, size=(B, 7))
    return (np.asarray(tr, dtype), np.asarray(tt, dtype),
            np.asarray(x0, dtype))


@pytest.fixture
def jax_sel_key(monkeypatch):
    """The JAX XLA path with its per-pose winner key in ``sel_key``."""
    orig = jax_ik._select

    def select_with_key(mode, xs, fs, success, x0, restart_idx=None,
                        succ_iters=None):
        out = orig(mode, xs, fs, success, x0, restart_idx, succ_iters)
        if mode == JaxMode.SPEED:
            order = restart_idx if restart_idx is not None else \
                jnp.arange(xs.shape[0])
            key = jnp.min(jnp.where(success, order, ik.INT32_MAX))
        else:
            key = jnp.min(jnp.where(
                success, jnp.linalg.norm(xs - x0[None, :], axis=-1), jnp.inf))
        return out._replace(sel_key=key)

    monkeypatch.setattr(jax_ik, "_select", select_with_key)


@pytest.mark.parametrize("mode", ["speed", "quality"])
def test_batch_solver_matches_jax_f64(panda, jax_sel_key, mode):
    jr, spec = panda
    kw = dict(max_restarts=24, seed_batch=8, max_iters=32)
    tr, tt, x0 = _problem(jr, 0, np.float64)
    ref = jax_ik.build_batch_solver(
        jr.spec, JaxConfig.create(mode, **kw), jnp.float64)(tr, tt, x0)
    got = ik.build_batch_solver(
        spec, SolverConfig.create(mode, **kw), torch.float64)(tr, tt, x0)

    found = np.asarray(ref.found)
    assert found.sum() >= B - 2  # the comparison exercises real solves
    np.testing.assert_array_equal(got.found.numpy(), found)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.x.numpy()[found], np.asarray(ref.x)[found],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy()[found],
                               np.asarray(ref.cost)[found], rtol=0, atol=1e-12)
    assert int(got.lane_iters) == int(ref.lane_iters)
    if mode == "speed":
        np.testing.assert_array_equal(got.sel_key.numpy(),
                                      np.asarray(ref.sel_key))
    else:
        np.testing.assert_allclose(got.sel_key.numpy()[found],
                                   np.asarray(ref.sel_key)[found], rtol=0,
                                   atol=1e-8)


def test_kernel_plain_version_matches_pallas_interpret(panda):
    jr, spec = panda
    kw = dict(max_restarts=24, seed_batch=8, max_iters=32)
    tr, tt, x0 = _problem(jr, 1, np.float32)
    cfg = SolverConfig.create("speed", **kw)
    ref = jax_kernel.build_kernel_solver(
        jr.spec, JaxConfig.create("speed", **kw), p_blk=8,
        interpret=True)(tr, tt, x0)

    plan = lm_kernel.KernelPlan(spec, cfg)
    x0_t = torch.tensor(x0)
    lanes = lm_kernel.solve_lanes(plan, torch.tensor(tr), torch.tensor(tt),
                                  x0_t)
    got = lm_kernel.select(plan, lanes, x0_t)

    f_ref, f_got = np.asarray(ref.found), got.found.numpy()
    assert f_ref.sum() >= B - 2
    assert (f_ref != f_got).sum() <= 1
    assert np.all(np.asarray(ref.cost)[f_ref] <= cfg.tol_f)
    assert np.all(got.cost.numpy()[f_got] <= cfg.tol_f)
    same = f_ref & f_got & (got.sel_key.numpy() == np.asarray(ref.sel_key))
    assert same.sum() >= B - 2
    np.testing.assert_allclose(got.x.numpy()[same], np.asarray(ref.x)[same],
                               rtol=0, atol=1e-3)
    # Lane outputs are on the (B, S) grid; winners are lowest successful
    # restart indices.
    assert lanes.x.shape == (B, 8, 7) and lanes.restart_index.dtype == \
        torch.int32
    assert int(lanes.lane_iters) > 0


def test_kernel_wrapper_dispatch_and_checks(panda):
    _, spec = panda
    cfg = SolverConfig(max_restarts=16, seed_batch=8, max_iters=8)
    plan = lm_kernel.KernelPlan(spec, cfg)
    tr = torch.eye(3).expand(2, 3, 3)
    tt = torch.zeros(2, 3)
    x0 = torch.zeros(2, 7)
    # CPU tensors never reach the kernel launcher.
    with pytest.raises(ValueError, match="CUDA"):
        lm_kernel.solve_kernel(plan, tr, tt, x0)
    with pytest.raises(ValueError, match="device"):
        lm_kernel.solve_lanes(plan, tr.to("meta"), tt.to("meta"),
                              x0.to("meta"))
    with pytest.raises(ValueError, match="expected"):
        lm_kernel.solve_lanes(plan, tr, tt, x0[:, :6])
    for bad, exc in ((cfg.replace(solution_mode="quality"),
                      NotImplementedError),
                     (cfg.replace(linear_weight=(0.0, 1.0, 1.0)),
                      NotImplementedError),
                     (cfg.replace(seed_batch=6), NotImplementedError)):
        with pytest.raises(exc, match="ROADMAP"):
            lm_kernel.KernelPlan(spec, bad)


def test_pack_chain_layout(panda):
    _, spec = panda
    from optik_tpu_torch.ops import soa

    consts = soa.chain_constants(spec)
    lower, upper = ik.chain_bounds(spec)
    chain = lm_kernel.pack_chain(consts, lower, upper)
    assert chain.dtype == np.float32 and chain.size == 7 * 54 + 13
    # Rodrigues coefficient form reproduces soa.rodrigues for every joint.
    q = torch.tensor([0.3, -1.2, 2.5], dtype=torch.float64)
    s, c = torch.sin(q), torch.cos(q)
    for j, axis in enumerate(consts[2]):
        c0, cc, cs, c1 = lm_kernel._rodrigues_coeffs(axis)
        rod = soa.rodrigues(axis, q)
        for a in range(3):
            for b in range(3):
                want = torch.broadcast_to(torch.as_tensor(rod[a][b],
                                                          dtype=q.dtype), (3,))
                got = c0[a, b] + c * cc[a, b] + s * cs[a, b] + \
                    (1 - c) * c1[a, b]
                torch.testing.assert_close(got, want, rtol=0, atol=1e-15)
