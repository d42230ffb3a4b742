"""The port's restart seed table is bitwise equal to the JAX package's.

The JAX table is built as the solvers build it
(``optik_tpu/solver/ik.py:190-204``): a vmap over restart indices of
``uniform(fold_in(PRNGKey(rng_seed), i + off), (A,), dtype, lo, hi)``.
Equality is bitwise (compared as integers): found masks are functions of
this stream, so any last-bit difference would show up as different solves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from optik_tpu.models import ChainSpec, asset_path
from optik_tpu_torch import random as rnd

ROWS = 256
SEEDS = (0, 42, 2**31 - 1)
OFFSETS = (0, 64, 1000)


def _bounds(unbounded: bool):
    spec = ChainSpec.from_urdf_file(asset_path("panda.urdf"), "panda_link0",
                                    "panda_hand_tcp")
    lo, hi = spec.lower.copy(), spec.upper.copy()
    if unbounded:
        lo[2], hi[2] = -np.inf, np.inf  # samples in [-pi, pi]
    return lo, hi


def _jax_tables(lo, hi, dtype, rows=ROWS):
    ls = np.where(np.isfinite(lo), lo, -np.pi)
    hs = np.where(np.isfinite(hi), hi, np.pi)

    @jax.jit
    def table(seed, off):
        key = jax.random.PRNGKey(seed)

        def draw(i):
            k = jax.random.fold_in(key, i + off)
            return jax.random.uniform(k, (lo.shape[0],), dtype=dtype,
                                      minval=jnp.asarray(ls, dtype),
                                      maxval=jnp.asarray(hs, dtype))

        return jax.vmap(draw)(jnp.arange(rows))

    return {(s, o): np.asarray(table(s, o)) for s in SEEDS for o in OFFSETS}


@pytest.mark.parametrize("unbounded", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_seed_table_bitwise_equal_to_jax(dtype, unbounded):
    lo, hi = _bounds(unbounded)
    ref = _jax_tables(lo, hi, jnp.dtype(dtype))
    ints = np.int32 if dtype == np.float32 else np.int64
    for (seed, off), want in ref.items():
        got = rnd.seed_table(seed, ROWS, lo, hi, dtype, off=off)
        assert got.dtype == dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(ints), want.view(ints),
                                      err_msg=f"seed={seed} off={off}")


@pytest.mark.parametrize("a,rows", [(11, ROWS), (12, ROWS), (16, ROWS),
                                    (11, 255)],
                         ids=["a11", "a12", "a16", "a11_odd_rows"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wide_chain_seed_table_bitwise_equal_to_jax(dtype, a, rows):
    """Chains of 11 and more joints (the mobile Panda, 12- and 16-joint
    arms): every row is one draw of ``a`` elements, so the element counters
    run past the Panda's 7; ``a = 11`` is an odd draw length, and 255 rows
    make the table's ``rows * a`` odd as well."""
    rng = np.random.default_rng(a + rows)
    lo = -rng.uniform(0.5, 3.0, size=a)
    hi = rng.uniform(0.0, 3.0, size=a)
    lo[a // 2], hi[a // 2] = -np.inf, np.inf  # samples in [-pi, pi]
    ref = _jax_tables(lo, hi, jnp.dtype(dtype), rows)
    ints = np.int32 if dtype == np.float32 else np.int64
    for (seed, off), want in ref.items():
        got = rnd.seed_table(seed, rows, lo, hi, dtype, off=off)
        assert got.shape == (rows, a) and want.shape == (rows, a)
        np.testing.assert_array_equal(got.view(ints), want.view(ints),
                                      err_msg=f"seed={seed} off={off}")


def test_fold_in_and_key_match_jax():
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        assert tuple(int(v) for v in rnd.prng_key(seed)) == \
            tuple(int(v) for v in np.asarray(key))
        for d in (0, 1, 63, 1000, 2**32 - 1):
            want = np.asarray(jax.random.fold_in(key, d))
            k0, k1 = rnd.fold_in(rnd.prng_key(seed), [d])
            assert (int(k0[0]), int(k1[0])) == tuple(int(v) for v in want)


def test_seed_table_is_cached_and_read_only():
    lo, hi = _bounds(False)
    a = rnd.seed_table(42, 64, lo, hi, np.float32)
    assert rnd.seed_table(42, 64, lo, hi, np.float32) is a
    assert not a.flags.writeable
    with pytest.raises(TypeError):
        rnd.seed_table(42, 64, lo, hi, np.float16)
