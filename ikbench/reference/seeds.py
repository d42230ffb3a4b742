"""The restart seed stream, worked out again from its definition.

Restart ``i`` of a pose starts from ``uniform(fold_in(PRNGKey(rng_seed),
i), (A,), float32, lo, hi)`` in JAX's threefry-2x32 scheme (partitionable
counters): ``PRNGKey(s) = (s >> 32, s & 0xffffffff)``; ``fold_in(k, d) =
threefry(k, (0, d))``; element ``j`` of a draw is ``threefry(k, (0, j))``
with the two output words xor-ed; its top 23 bits are the mantissa of a
float in [1, 2), minus 1; the value ``u * (hi - lo) + lo`` is rounded once
to float32 and floored at ``lo``.  Restart 0 is the caller's own seed.
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 arrays (broadcast)."""
    k0, k1 = (np.asarray(v, np.uint32) for v in key)
    x0, x1 = np.broadcast_arrays(np.asarray(x0, np.uint32),
                                 np.asarray(x1, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for block in range(5):
        for rot in _ROT[block % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(rot)) | (x1 >> np.uint32(32 - rot))
            x1 = x1 ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0, x1


def restart_table(rng_seed: int, rows: int, lo: np.ndarray,
                  hi: np.ndarray) -> np.ndarray:
    """(rows, A) float32: row i is restart i's draw over the box
    [lo, hi] (finite float64 limits)."""
    s = int(rng_seed)
    key = (np.uint32((s >> 32) & 0xFFFFFFFF), np.uint32(s & 0xFFFFFFFF))
    with np.errstate(over="ignore"):
        d = np.arange(rows, dtype=np.uint32)
        k0, k1 = threefry2x32(key, np.zeros_like(d), d)
        j = np.arange(lo.shape[0], dtype=np.uint32)[None, :]
        b0, b1 = threefry2x32((k0[:, None], k1[:, None]),
                              np.zeros_like(j), j)
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    u = bits.view(np.float32) - np.float32(1.0)
    lo32, hi32 = lo.astype(np.float32), hi.astype(np.float32)
    # The float32 product is exact in float64: one rounding in all.
    val = (u.astype(np.float64) * (hi32 - lo32).astype(np.float64)
           + lo32.astype(np.float64)).astype(np.float32)
    return np.maximum(lo32, val)
