"""The port's exact zonotope-gauge solve (solver/gauge.py) against the JAX
package's on raw generators, and the properties the port must keep on its
own: dtype discipline, NaN-free degenerate lanes, first-minimum ties and
bitwise batch invariance.

Float64 on the CPU on both sides, inputs from a numpy seed.  ``t`` agrees
within 1e-9 relative and ``u`` within 1e-7 (``rsqrt`` differs in the last bit
between the two libraries and the recovery solves a 1e-7-regularised
system); lanes with t = +inf are the same lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optik_tpu.solver import gauge as jgauge

from optik_tpu_torch.solver import gauge

from test_torch_port_models import DtypeLog

LANES = 48


def raw_problem(n, seed, lanes=LANES):
    """Generators (n, 6, lanes) and directions (6, lanes): random, with a
    zero direction (every cut invalid: t = +inf), a zero generator (a zero
    v_max entry) and a lane of tiny generators."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, 6, lanes)) * rng.uniform(
        0.2, 2.0, size=(n, 1, lanes))
    v = rng.standard_normal((6, lanes))
    v[:, 0] = 0.0
    g[2, :, 1] = 0.0
    g[:, :, 2] *= 1e-3
    return g, v


def lane_lists(g, v, dtype=torch.float64):
    return ([[torch.tensor(g[i, k], dtype=dtype) for k in range(6)]
             for i in range(g.shape[0])],
            [torch.tensor(v[k], dtype=dtype) for k in range(6)])


def solve_torch(g, v, dtype=torch.float64):
    t, u = gauge.gauge_solve(*lane_lists(g, v, dtype))
    return t, torch.stack(u)


def solve_jax(g, v):
    gens = [[jnp.asarray(g[i, k]) for k in range(6)]
            for i in range(g.shape[0])]
    t, u = jgauge.gauge_solve(gens, [jnp.asarray(v[k]) for k in range(6)])
    return np.asarray(t), np.stack([np.asarray(c) for c in u])


@pytest.mark.parametrize("n", [5, 7, 8])
def test_gauge_solve_matches_jax(n):
    g, v = raw_problem(n, seed=n)
    t, u = solve_torch(g, v)
    jt, ju = solve_jax(g, v)
    assert t.dtype == u.dtype == torch.float64
    inf = np.isinf(jt)
    assert inf[0] and not inf.all()
    np.testing.assert_array_equal(np.isinf(t.numpy()), inf)
    # Five generators span a flat zonotope: a generic direction leaves it
    # at t ~ 1e-15, pure rounding, which only the absolute term can hold.
    np.testing.assert_allclose(t.numpy()[~inf], jt[~inf], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(u.numpy(), ju, rtol=0, atol=1e-7)
    # NaN-free on the degenerate lanes too, and inside the unit box.
    assert bool(torch.isfinite(u).all()) and float(u.abs().max()) <= 1.0
    # The boundary point: sum_i u_i g_i = t v wherever the winning subset
    # is a true facet (n = 5 has one subset, always the facet).
    point = np.einsum("il,ikl->kl", u.numpy()[:, ~inf], g[:, :, ~inf]) \
        - t.numpy()[~inf] * v[:, ~inf]
    assert np.median(np.abs(point).max(axis=0)) < 1e-9


def test_constants_and_too_few_generators():
    assert (gauge.MIN_EXACT_N, gauge.MAX_EXACT_N, gauge._TINY) == \
        (jgauge.MIN_EXACT_N, jgauge.MAX_EXACT_N, jgauge._TINY)
    g, v = raw_problem(4, seed=0, lanes=3)
    with pytest.raises(ValueError, match="gauge_solve needs >= 5 generators"):
        solve_torch(g, v)


def test_static_components_fold_like_lanes():
    """A generator component given as a Python float (a prismatic column's
    static 0.0) gives the bits of the same value given as a lane tensor."""
    g, v = raw_problem(6, seed=11, lanes=8)
    g[3, 3:] = 0.0
    g[4, 0] = 0.25
    t_ref, u_ref = solve_torch(g, v)
    gens = [[torch.tensor(g[i, k]) for k in range(6)] for i in range(6)]
    gens[3][3:] = [0.0, 0.0, 0.0]
    gens[4][0] = 0.25
    t, u = gauge.gauge_solve(gens, [torch.tensor(v[k]) for k in range(6)])
    assert torch.equal(t, t_ref) and torch.equal(torch.stack(u), u_ref)


def test_batch_invariance_is_bitwise():
    g, v = raw_problem(7, seed=21)
    for dtype in (torch.float64, torch.float32):
        t, u = solve_torch(g, v, dtype)
        for sl in (slice(0, 1), slice(5, 6), slice(3, 20)):
            t1, u1 = solve_torch(g[:, :, sl], v[:, sl], dtype)
            assert torch.equal(t1, t[sl]) and torch.equal(u1, u[:, sl])


def test_argmin_tie_takes_the_first_minimal_facet():
    """Two identical generators give pairs of subsets with the same normal
    and the same cut: an exact tie.  The first minimal row wins, as in JAX,
    and t does not depend on it.  A subset holding both copies is
    degenerate (its direction is rounding noise: a valid cut, no facet), so
    ``u`` is compared on the lanes whose boundary point is consistent in
    both libraries."""
    tie = torch.tensor([[3.0, 1.0, 1.0, 2.0], [1.0, 1.0, 1.0, 2.0],
                        [1.0, 5.0, 1.0, 2.0]])
    assert torch.argmin(tie, dim=0).tolist() == [1, 0, 0, 0]
    assert np.asarray(jnp.argmin(jnp.asarray(tie.numpy()), axis=0)).tolist() \
        == [1, 0, 0, 0]

    rng = np.random.default_rng(2)
    g = rng.standard_normal((7, 6, 256))
    g[1] = g[0]
    v = rng.standard_normal((6, 256))
    t, u = solve_torch(g, v)
    jt, ju = solve_jax(g, v)

    def consistent(tt, uu):
        return np.abs(np.einsum("il,ikl->kl", uu, g) - tt * v).max(0) < 1e-6

    good = consistent(t.numpy(), u.numpy()) & consistent(jt, ju)
    assert good.sum() >= 64
    np.testing.assert_allclose(t.numpy()[good], jt[good], rtol=1e-9)
    np.testing.assert_allclose(u.numpy()[:, good], ju[:, good], atol=1e-7)
    # In half of those lanes the winning facet holds one of the two copies:
    # the tie.  The first subset (the one with generator 0) must have won:
    # generator 1 then sits at a bound.
    tied = good & (np.abs(u.numpy()[0]) < 1.0 - 1e-9)
    assert tied.sum() >= 16
    assert np.all(np.abs(u.numpy()[1, tied]) >= 1.0 - 1e-12)


def test_f32_in_f32_out_without_f64_intermediate():
    """No operation of an f32 solve returns a float64 tensor, even when the
    process-wide default dtype is float64 (which a pair of Python scalars
    in ``torch.where``, or a numpy float64 table, would pick up)."""
    g, v = raw_problem(7, seed=31, lanes=8)
    gens, vv = lane_lists(g, v, torch.float32)
    gauge._subset_tables.cache_clear()
    torch.set_default_dtype(torch.float64)
    try:
        with DtypeLog() as log:
            t, u = gauge.gauge_solve(gens, vv)
            u = torch.stack(u)
    finally:
        torch.set_default_dtype(torch.float32)
    assert t.dtype == torch.float32 and u.dtype == torch.float32
    assert torch.float64 not in log.seen, log.seen[torch.float64]
    assert torch.float32 in log.seen and torch.int64 in log.seen
    t64, u64 = solve_torch(g, v)
    fin = torch.isfinite(t64)
    np.testing.assert_allclose(t.numpy()[fin], t64.numpy()[fin], rtol=2e-4)
