"""The port's differential IK (solver/diffik.py, solver/qp.py and the Robot
entry points) against the JAX package's.

Float64 on the CPU on both sides, inputs from a numpy seed, both Robots
built from one URDF.  Exact path: ``ok`` masks equal, ``alpha`` within 1e-9,
``v`` within 1e-7 (see tests/test_torch_gauge.py).  ADMM path: ``ok`` masks
equal and ``x`` within 1e-6 (measured: ~1e-10 in ``v`` and ~1e-12 in
``alpha`` on these inputs; 800 iterations and three LU polishes amplify the
last-bit differences of the two libraries' factorisations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optik_tpu
from optik_tpu.solver import diffik as jdiffik
from optik_tpu.solver import qp as jqp

import optik_tpu_torch
from optik_tpu_torch.solver import diffik, qp

from test_torch_port_models import EE_OFFSET, DtypeLog, chain_urdf, robots

B = 24


def T(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def problem(jr, seed, b=B, edge_lanes=True):
    """Random in-limit configurations, commands and limits; with
    ``edge_lanes`` the first lanes hold the degenerate corners: a zero
    command, a zero ``v_max`` entry, all-zero ``v_max`` and the fully
    extended (singular) configuration."""
    rng = np.random.default_rng(seed)
    n = jr.num_positions()
    x0 = np.stack([jr.random_configuration(rng) for _ in range(b)])
    v_we = rng.standard_normal((b, 6))
    v_max = rng.uniform(0.3, 1.2, size=(b, n))
    if edge_lanes:
        v_we[0] = 0.0
        v_max[1, 2] = 0.0
        v_max[2] = 0.0
        lo, hi = jr.joint_limits()
        x0[3] = np.clip(np.zeros(n), lo, hi)
        v_we[3] = [0.0, 0.0, 0.3, 0.0, 0.2, 0.0]
    return x0, v_we, v_max


def world_jacobian(tr, x0):
    r, _ = tr.fk_batch(x0)
    j = tr.jacobian_batch(x0)
    return torch.cat([r @ j[:, :3], r @ j[:, 3:]], dim=1).numpy()


@pytest.mark.parametrize("model,ee", [
    ("ur3e", None), ("ur3e", EE_OFFSET), ("panda", None),
    ("prismatic6", None), ("chain5", None), ("chain8", None)],
    ids=["ur3e", "ur3e_ee_offset", "panda", "prismatic6", "chain5", "chain8"])
def test_exact_path_matches_jax(model, ee):
    jr, tr = robots(model)
    x0, v_we, v_max = problem(jr, seed=len(model))
    ja, jv, jok = map(np.asarray, jr.diff_ik_batch(x0, v_we, v_max,
                                                   ee_offset=ee, rescue=False))
    alpha, v, ok = tr.diff_ik_batch(x0, v_we, v_max, ee_offset=ee,
                                    rescue=False)
    assert alpha.dtype == v.dtype == torch.float64 and ok.dtype == torch.bool
    assert alpha.shape == (B,) and v.shape == x0.shape and ok.shape == (B,)
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_allclose(alpha.numpy(), ja, rtol=0, atol=1e-9)
    np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=1e-7)
    # The contracts, on the port's own result.
    a, vv = alpha.numpy(), v.numpy()
    assert np.all((a >= 0.0) & (a <= 1.0 + 1e-6))
    assert np.all(np.abs(vv) <= v_max + 1e-6)
    assert a[0] == 1.0 and np.all(vv[0] == 0.0) and ok[0]      # zero command
    assert abs(vv[1, 2]) <= 1e-9                               # v_max entry 0
    assert np.all(vv[2] == 0.0) and (not ok[2] or a[2] <= 1e-6)
    if model != "chain5":          # 5 joints cannot follow a generic command
        assert ok.numpy()[4:].all()
    jw = world_jacobian(tr, T(x0)) if ee is None else None
    if jw is not None:
        res = np.abs(np.einsum("bij,bj->bi", jw, vv) - a[:, None] * v_we)
        lim = 1e-5 * (1.0 + np.abs(v_we).max(axis=1))
        assert np.all(res.max(axis=1)[ok.numpy()] < lim[ok.numpy()])


@pytest.mark.parametrize("rescue", [False, True], ids=["plain", "rescue"])
def test_constant_twist_matches_jax(rescue):
    """The Panda under one command for every lane, [0, 0, 0.1, 0, 0, 0] with
    v_max 0.75 on every joint (the JAX package's diff-IK benchmark
    workload), from uniform start configurations, with and without the
    rescue: every lane ok on both sides, alpha and v within the exact
    path's limits."""
    jr, tr = robots("panda")
    rng = np.random.default_rng(4)
    x0 = rng.uniform(*jr.joint_limits(), size=(16, 7))
    v_we = np.tile([0.0, 0.0, 0.1, 0.0, 0.0, 0.0], (16, 1))
    v_max = np.full((16, 7), 0.75)
    ja, jv, jok = map(np.asarray, jr.diff_ik_batch(x0, v_we, v_max,
                                                   rescue=rescue))
    alpha, v, ok = tr.diff_ik_batch(x0, v_we, v_max, rescue=rescue)
    assert bool(ok.all())
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_allclose(alpha.numpy(), ja, rtol=0, atol=1e-9)
    np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=1e-7)


def test_all_cuts_invalid_lanes_stay_nan_free():
    """The planar chain's Jacobian has rank 3: every cut of an in-range
    command is invalid, t = +inf, and the lane comes out ok=False, alpha=0,
    v=0, without a NaN anywhere."""
    jr, tr = robots("planar6")
    x0, _, v_max = problem(jr, seed=0, b=8, edge_lanes=False)
    rng = np.random.default_rng(1)
    v_we = np.einsum("bij,bj->bi", world_jacobian(tr, T(x0)),
                     rng.uniform(-0.2, 0.2, size=(8, 6)))
    alpha, v, ok = tr.diff_ik_batch(x0, v_we, v_max, rescue=False)
    _, _, jok = jr.diff_ik_batch(x0, v_we, v_max, rescue=False)
    assert not bool(ok.any()) and not np.asarray(jok).any()
    assert bool(torch.isfinite(alpha).all()) and bool(torch.isfinite(v).all())
    assert bool((alpha == 0).all()) and bool((v == 0).all())


def _qp_inputs(jr, tr, seed):
    x0, v_we, v_max = problem(jr, seed, b=8, edge_lanes=False)
    mats = diffik._build_qp(tr.params, T(x0), T(v_we), T(v_max), None, None)
    import jax
    jmats = jax.vmap(lambda a, b, c: jdiffik._build_qp(
        jr.params, a, b, c, None, None))(
        jnp.asarray(x0), jnp.asarray(v_we), jnp.asarray(v_max))
    return mats, jmats


@pytest.mark.parametrize("model", ["ur3e", "chain4"])
def test_qp_build_and_solve_match_jax(model):
    jr, tr = robots(model)
    mats, jmats = _qp_inputs(jr, tr, seed=3)
    for got, want in zip(mats, jmats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)
    sol = qp.solve(*mats)
    ref = jqp.solve(*jmats)
    n = jr.num_positions()
    assert sol.x.shape == (8, n + 1) and sol.y.shape == (8, n + 7)
    assert sol.primal_res.shape == sol.dual_res.shape == (8,)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sol.primal_res.numpy(),
                               np.asarray(ref.primal_res), rtol=0, atol=1e-8)
    np.testing.assert_allclose(sol.dual_res.numpy(),
                               np.asarray(ref.dual_res), rtol=0, atol=1e-6)
    # One problem without a batch dimension gives that lane.
    one = qp.solve(*[m[0] for m in mats])
    np.testing.assert_allclose(one.x.numpy(), sol.x[0].numpy(), rtol=0,
                               atol=1e-9)


def test_qp_factorisations_never_raise():
    """A matrix that is not positive definite, or a singular KKT system,
    makes ``torch.linalg.cholesky`` / ``solve`` raise; the solver gates on
    ``isfinite`` as the JAX version does, lane by lane."""
    _, tr = robots("ur3e")
    jr = robots("ur3e")[0]
    p, q, a, l, u = _qp_inputs(jr, tr, seed=4)[0]
    p = p.clone()
    p[0] = -5.0 * torch.eye(7, dtype=torch.float64)   # indefinite lane
    sol = qp.solve(p, q, a, l, u, iters=200)
    clean = qp.solve(*_qp_inputs(jr, tr, seed=4)[0], iters=200)
    assert bool(torch.isfinite(sol.x[1:]).all())
    assert torch.equal(sol.x[1:], clean.x[1:])         # lanes do not mix
    # All-zero problem: K = sigma I factors, every KKT system is singular
    # up to polish_reg; nothing raises and x stays finite.
    z = qp.solve(torch.zeros(2, 3, 3), torch.zeros(2, 3),
                 torch.zeros(2, 4, 3), torch.zeros(2, 4), torch.zeros(2, 4),
                 iters=100, polish_reg=0.0)
    assert z.x.dtype == torch.float32 and bool((z.x == 0).all())


@pytest.mark.parametrize("model", ["ur3e", "panda", "chain4", "scara"])
def test_admm_path_matches_jax(model):
    jr, tr = robots(model)
    x0, v_we, v_max = problem(jr, seed=9, b=8, edge_lanes=False)
    if model in ("chain4", "scara"):   # reachable commands for short chains
        rng = np.random.default_rng(10)
        v_we = np.einsum("bij,bj->bi", world_jacobian(tr, T(x0)),
                         rng.uniform(-0.2, 0.2, size=x0.shape))
    ja, jv, jok = map(np.asarray, jdiffik.diff_ik_admm_batch(
        jr.params, jnp.asarray(x0), jnp.asarray(v_we), jnp.asarray(v_max)))
    alpha, v, ok = diffik.diff_ik_admm_batch(tr.params, T(x0), T(v_we),
                                             T(v_max))
    assert jok.sum() >= 7
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_allclose(alpha.numpy(), ja, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=1e-6)
    assert np.all(np.abs(v.numpy()) <= v_max + 1e-6)
    a1, v1, ok1 = diffik.diff_ik_one(tr.params, T(x0[0]), T(v_we[0]),
                                     T(v_max[0]))
    assert a1.shape == () and v1.shape == (jr.num_positions(),)
    assert bool(ok1) == bool(ok[0])
    np.testing.assert_allclose(v1.numpy(), v[0].numpy(), rtol=0, atol=1e-9)
    if model in ("chain4", "scara"):
        # Outside the exact range the facade routes here.
        fa, fv, fok = tr.diff_ik_batch(x0, v_we, v_max)
        assert torch.equal(fa, alpha) and torch.equal(fv, v)
        assert torch.equal(fok, ok)


def test_gauge_agrees_with_admm_oracle():
    _, tr = robots("panda")
    x0, v_we, v_max = problem(robots("panda")[0], seed=9, b=8,
                              edge_lanes=False)
    a_g, _, ok_g = tr.diff_ik_batch(x0, v_we, v_max, rescue=False)
    a_a, _, ok_a = diffik.diff_ik_admm_batch(tr.params, T(x0), T(v_we),
                                             T(v_max))
    both = ok_g & ok_a
    assert int(both.sum()) >= 7
    np.testing.assert_allclose(a_g[both].numpy(), a_a[both].numpy(), atol=5e-4)


def test_routing_by_joint_count():
    assert (diffik._TRACK_TOL, diffik._STAT_TOL, diffik._REG,
            diffik._ALPHA_REWARD) == (jdiffik._TRACK_TOL, jdiffik._STAT_TOL,
                                      jdiffik._REG, jdiffik._ALPHA_REWARD)
    for n, exact in ((4, False), (5, True), (8, True), (10, True),
                     (11, False)):
        bot = optik_tpu_torch.Robot.from_urdf_str(
            chain_urdf(n), "l0", f"l{n}", dtype=torch.float64, device="cpu")
        fn = diffik.build_batch_solver(bot.spec, bot.dtype)
        assert (fn is not None) == exact
        assert (bot._diffik_solver() is not None) == exact


def test_rescue_recovers_rank_deficient_lanes():
    """tests/test_diffik_rescue.py's case, in f32 as there, through both
    packages: the gauge rejects the planar chain's lanes, the ADMM re-solve
    accepts all of them."""
    jr, tr = robots("planar6", f32=True)
    _, tr64 = robots("planar6")
    rng = np.random.default_rng(0)
    b, n = 8, 6
    x0 = np.stack([jr.random_configuration(rng) for _ in range(b)])
    v_max = np.ones((b, n))
    jw = world_jacobian(tr64, T(x0))
    v_we = np.einsum("bij,bj->bi", jw, rng.uniform(-0.2, 0.2, size=(b, n)))

    _, _, ok0 = tr.diff_ik_batch(x0, v_we, v_max, rescue=False)
    a1, v1, ok1 = tr.diff_ik_batch(x0, v_we, v_max)
    _, _, jok0 = jr.diff_ik_batch(x0, v_we, v_max, rescue=False)
    _, _, jok1 = jr.diff_ik_batch(x0, v_we, v_max)
    np.testing.assert_array_equal(ok0.numpy(), np.asarray(jok0))
    np.testing.assert_array_equal(ok1.numpy(), np.asarray(jok1))
    assert not bool(ok0.all()) and bool(ok1.all())
    assert a1.dtype == v1.dtype == torch.float32
    assert bool((a1 >= 1.0 - 1e-3).all()) and bool((v1.abs() <= 1 + 1e-6).all())
    res = np.einsum("bij,bj->bi", jw, v1.double().numpy()) \
        - a1.double().numpy()[:, None] * v_we
    assert np.abs(res).max() < 5e-4
    # A command outside the rank-deficient range stays refused by both
    # solvers (or holds alpha ~ 0).
    z = np.array([[0.0, 0.0, 1.0, 0.0, 0.0, 0.0]])
    a, _, ok = tr.diff_ik_batch(x0[:1], z, np.ones((1, n)))
    assert not bool(ok[0]) or float(a[0]) <= 1e-4


def test_rescue_is_a_noop_on_ok_lanes_and_merges_on_device():
    _, tr = robots("panda", f32=True)
    x0, v_we, v_max = problem(robots("panda")[0], seed=3, b=16)
    a0, v0, ok0 = tr.diff_ik_batch(x0, v_we, v_max, rescue=False)
    a1, v1, ok1 = tr.diff_ik_batch(x0, v_we, v_max)
    assert 0 < int(ok0.sum()) < 16      # lane 2 (all-zero v_max) may fail
    assert bool(ok1[ok0].all())
    assert torch.equal(a1[ok0], a0[ok0]) and torch.equal(v1[ok0], v0[ok0])
    assert int(ok1.sum()) >= int(ok0.sum())
    # A clean batch comes back bit for bit.
    c = problem(robots("panda")[0], seed=5, b=16, edge_lanes=False)
    plain = tr.diff_ik_batch(*c, rescue=False)
    assert bool(plain[2].all())
    for got, want in zip(tr.diff_ik_batch(*c), plain):
        assert torch.equal(got, want)


@pytest.mark.parametrize("model", ["ur3e", "panda"])
def test_batch_invariance_is_bitwise(model):
    for f32 in (False, True):
        jr, tr = robots(model, f32=f32)
        x0, v_we, v_max = problem(jr, seed=5, b=6)
        full = tr.diff_ik_batch(x0, v_we, v_max, rescue=False)
        again = tr.diff_ik_batch(x0, v_we, v_max, rescue=False)
        for i in range(6):
            one = tr.diff_ik_batch(x0[i:i + 1], v_we[i:i + 1],
                                   v_max[i:i + 1], rescue=False)
            for got, want, rep in zip(one, full, again):
                assert torch.equal(got[0], want[i])
                assert torch.equal(rep[i], want[i])


def test_scalar_diff_ik_is_lane_zero_of_the_batch():
    jr, tr = robots("panda")
    x0, v_we, v_max = problem(jr, seed=6, b=4, edge_lanes=False)
    alpha, v, ok = tr.diff_ik_batch(x0, v_we, v_max)
    for i in range(4):
        sol = tr.diff_ik(x0[i], v_we[i], v_max[i])
        ref = jr.diff_ik(x0[i], v_we[i], v_max[i])
        assert bool(ok[i]) and sol is not None and ref is not None
        assert isinstance(sol[0], float) and isinstance(sol[1], list)
        assert sol[0] == float(alpha[i]) and sol[1] == v[i].tolist()
        assert sol[0] == pytest.approx(ref[0], abs=1e-9)
        np.testing.assert_allclose(sol[1], ref[1], rtol=0, atol=1e-7)
    # A command a planar chain cannot follow: refused (None), or followed
    # honestly with alpha ~ 0, never a fabricated motion.
    _, planar = robots("planar6")
    sol = planar.diff_ik(np.zeros(6) + 0.3, [0, 0, 1.0, 0, 0, 0], np.ones(6))
    assert sol is None or sol[0] <= 1e-4


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_error_strings_match_jax():
    jr, tr = robots("panda")
    x0, v, vm = np.zeros(7), np.zeros(6), np.ones(7)
    cases = [
        (lambda r: r.diff_ik(x0[:3], v, vm), "len(x0) != num_positions"),
        (lambda r: r.diff_ik(x0, v[:5], vm), "len(V_WE) != 6"),
        (lambda r: r.diff_ik(x0, v, vm[:6]), "len(v_max) != num_positions"),
        (lambda r: r.joint_jacobian(x0[:3]), "len(x) != num_positions"),
        (lambda r: r.diff_ik(x0, v, vm, ee_offset=np.eye(4) * 2.0),
         "invalid target transform specified"),
    ]
    for fn, msg in cases:
        assert _error(lambda: fn(jr)) == msg
        assert _error(lambda: fn(tr)) == msg


@pytest.mark.parametrize("model", ["panda", "chain4", "planar6"])
def test_f32_in_f32_out_without_f64_intermediate(model):
    """An f32 Robot's diff-IK (exact path, ADMM path, rescue) returns f32
    and no operation on the way returns a float64 tensor, even with the
    process-wide default dtype set to float64."""
    jr, tr = robots(model, f32=True)
    x0, v_we, v_max = problem(jr, seed=8, b=4, edge_lanes=False)
    if model == "planar6":
        v_we[:, 2:5] = 0.0          # planar commands: the rescue path runs
    args = [T(a, torch.float32) for a in (x0, v_we, v_max)]
    tr.params                       # constants are built outside the log
    tr.diff_ik_batch(*args)
    torch.set_default_dtype(torch.float64)
    try:
        with DtypeLog() as log:
            alpha, v, ok = tr.diff_ik_batch(*args)
            jac = tr.jacobian_batch(args[0])
    finally:
        torch.set_default_dtype(torch.float32)
    assert alpha.dtype == v.dtype == jac.dtype == torch.float32
    assert ok.dtype == torch.bool
    assert torch.float64 not in log.seen, log.seen[torch.float64]
    # The solver refuses inputs of another dtype instead of promoting.
    fn = tr._diffik_solver()
    if fn is not None:
        with pytest.raises(TypeError, match="float64"):
            fn(args[0].double(), args[1], args[2])
