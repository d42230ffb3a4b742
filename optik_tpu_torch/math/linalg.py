"""Unrolled small-matrix linear algebra for batched lanes.

A port of ``optik_tpu/math/linalg.py``.  The LM step solves one 6x6 SPD
system per lane; the factorisation and both substitutions are unrolled into
element-wise operations on ``(...,)`` slices, with no data-dependent control
flow and no library call whose algorithm could change with the batch size.
"""

from __future__ import annotations

import torch


def cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` for SPD ``a``: (..., n, n), (..., n) -> (..., n).

    Fully unrolled Cholesky (n is static and small, e.g. 6).  No pivoting;
    the caller guarantees SPD (LM adds a positive damping term).
    """
    n = a.shape[-1]
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        # Round-off may push a pivot below zero; the caller's damping keeps
        # true pivots well away from it.  The diagonal holds 1/L_jj.
        inv_d = 1.0 / torch.sqrt(s.clamp_min(1e-30))
        l[j][j] = inv_d
        for i in range(j + 1, n):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d

    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s * l[i][i]

    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s * l[i][i]
    return torch.stack(x, dim=-1)
