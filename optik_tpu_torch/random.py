"""The restart seed table, bit-exact with the JAX package's ``jax.random``.

Restart ``i`` of every pose starts from
``uniform(fold_in(PRNGKey(rng_seed), i + off), (A,), dtype, lo, hi)``
(optik_tpu/solver/ik.py:190-204, optik_tpu/ops/pallas/lm_kernel.py:236-253).
Found masks are functions of this stream (docs/DESIGN.md, "Restarts"), so
the port reproduces it bit for bit, in numpy ``uint32`` arithmetic on the
host, from the recipe of jax's threefry PRNG with
``jax_threefry_partitionable=True`` (as jax 0.9.0 runs it):

  * ``PRNGKey(s)`` is the pair ``(s >> 32, s & 0xFFFFFFFF)``;
  * ``fold_in(k, d)`` is ``threefry2x32(k, x0=0, x1=d)``;
  * element ``j`` of a draw takes ``threefry2x32(k, j >> 32, j & 0xFFFFFFFF)``;
    f32 uses ``b0 ^ b1``, f64 ``(b0 << 32) | b1``;
  * the mantissa bits are OR'd into 1.0, 1 is subtracted, and the result is
    scaled as ``u * (hi - lo) + lo`` and floored at ``lo``.

XLA fuses that last multiply-add into one FMA with a single rounding, so the
scaling here rounds once too: in f64 for an f32 table (the product of two
f32 values is exact in f64), and through exact rational arithmetic for an
f64 table.  The table is R x A entries, so none of this is on a hot path;
it is uploaded once per solver build and the CUDA kernel and its plain
version read the same uploaded copy.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k0, k1, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds; all arguments broadcast as uint32."""
    k0, k1, x0, x1 = np.broadcast_arrays(
        *(np.atleast_1d(np.asarray(v, np.uint32)) for v in (k0, k1, x0, x1)))
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Tuple[np.uint32, np.uint32]:
    """``jax.random.PRNGKey(seed)`` as its two uint32 words."""
    s = int(seed)
    return np.uint32((s >> 32) & 0xFFFFFFFF), np.uint32(s & 0xFFFFFFFF)


def fold_in(key, data) -> Tuple[np.ndarray, np.ndarray]:
    """``jax.random.fold_in`` for an array of uint32 ``data`` at once."""
    d = np.asarray(data, np.int64) & 0xFFFFFFFF
    return threefry2x32(key[0], key[1], np.zeros(d.shape, np.uint32),
                        d.astype(np.uint32))


def _uniform_rows(k0, k1, lo: np.ndarray, hi: np.ndarray,
                  dtype) -> np.ndarray:
    """One ``uniform(k, (A,), dtype, lo, hi)`` draw per key row: (N, A)."""
    a = lo.shape[0]
    j = np.arange(a, dtype=np.uint32)[None, :]
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], np.zeros_like(j), j)
    if dtype == np.float32:
        bits = (((b0 ^ b1) >> np.uint32(32 - 23))
                | np.float32(1.0).view(np.uint32))
        u = bits.view(np.float32) - np.float32(1.0)
        lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
        d = hi32 - lo32
        # One rounding: the f32 x f32 product is exact in f64.
        val = (u.astype(np.float64) * d.astype(np.float64)
               + lo32.astype(np.float64)).astype(np.float32)
        return np.maximum(lo32, val)
    if dtype == np.float64:
        b64 = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
        bits = (b64 >> np.uint64(64 - 52)) | np.float64(1.0).view(np.uint64)
        u = bits.view(np.float64) - 1.0
        d = hi - lo
        # Exact fused multiply-add, rounded once (Fraction -> float rounds
        # correctly).
        val = np.array(
            [[float(Fraction(float(u[n, p])) * Fraction(float(d[p]))
                    + Fraction(float(lo[p]))) for p in range(a)]
             for n in range(u.shape[0])], np.float64).reshape(u.shape)
        return np.maximum(lo, val)
    raise TypeError(f"seed table dtype must be float32 or float64, "
                    f"got {dtype}")


def sample_bounds(lower, upper) -> Tuple[np.ndarray, np.ndarray]:
    """Finite sampling box: unbounded joints sample in [-pi, pi]."""
    lower = np.asarray(lower, np.float64)
    upper = np.asarray(upper, np.float64)
    return (np.where(np.isfinite(lower), lower, -np.pi),
            np.where(np.isfinite(upper), upper, np.pi))


@functools.lru_cache(maxsize=64)
def _table_cached(rng_seed: int, off: int, rows: int, lo: tuple, hi: tuple,
                  dtype_name: str) -> np.ndarray:
    key = prng_key(rng_seed)
    k0, k1 = fold_in(key, np.arange(rows, dtype=np.int64) + off)
    out = _uniform_rows(k0, k1, np.asarray(lo, np.float64),
                        np.asarray(hi, np.float64), np.dtype(dtype_name).type)
    out.setflags(write=False)
    return out


def seed_table(rng_seed: int, rows: int, lower, upper, dtype=np.float32,
               off: int = 0) -> np.ndarray:
    """(rows, A) restart seeds: row i = the draw for restart index i + off.

    ``lower``/``upper`` are the joint limits (infinite entries sample in
    [-pi, pi], as ``optik_tpu.solver.ik.sample_bounds``).  The result is
    cached and read-only.
    """
    lo, hi = sample_bounds(lower, upper)
    return _table_cached(int(rng_seed), int(off), int(rows),
                         tuple(lo.tolist()), tuple(hi.tolist()),
                         np.dtype(dtype).name)
