"""Exact zonotope-gauge solver for the differential-IK LP (SoA, batched).

A port of ``optik_tpu/solver/gauge.py``.  The reference solves diff-IK as a
conic LP per call (kylc/optik crates/optik/src/lib.rs:101-239):

    max_{v, alpha} alpha
      s.t.  J_W(q) v = alpha * V,   |v_i| <= vmax_i,   0 <= alpha <= 1.

The image of the velocity box under J_W is a **zonotope**
Z = { sum_i u_i * g_i : |u_i| <= 1 } with generators g_i = vmax_i * J_i.
The optimal alpha is min(1, t*) where t* = max { t : t V in Z } is the exit
parameter of the ray {t V} through Z, the reciprocal gauge of V.  For any
direction w with w.V != 0, convexity gives the *cut*

    t_w = h_Z(w) / |w.V|  >=  t*,      h_Z(w) = sum_i |w.g_i|,

with equality when w supports the exit facet.  Every facet of a
full-dimensional zonotope in R^6 is spanned by 5 generators, so enumerating
the C(n, 5) five-subsets' normals and taking the minimum cut yields t*
exactly (generic position) and a feasible upper bound always: the method
can never overshoot the LP optimum.  The boundary point recovers in closed
form: out-of-facet coordinates sit at their bounds (u_i = sign(w.g_i)), the
5 in-facet coordinates solve a tiny consistent least-squares system, and
scaling by alpha / t* maps the facet point to the solution (the box is
symmetric and star-shaped, so the scaled point stays feasible).

Layout: the subset axis is a tensor dimension: all per-facet math runs on
``(C, *lane)`` tensors.  Small vector components (the 6 spatial dims, the 5
subset positions) stay Python lists in the SoA style of ops/soa.py;
everything is element-wise over ``(C, *lane)`` or ``(*lane,)``, with one
gather selecting the winning facet.  Zero iterations, zero data-dependent
control flow, exact answers, and each lane's result is bitwise independent
of the batch it is solved in.

Every constant enters in the lanes' dtype and on their device: the static
subset tables are built once per (n, dtype, device) and no Python-scalar
pair goes through ``torch.where`` (which would yield the default dtype), so
a float32 call computes in float32 throughout.

Degenerate cases (rank-deficient J, V orthogonal to the reachable space,
ties) can make the minimum cut conservative (t < t*) but never infeasible;
the caller's tracking-residual gate stays the honest success contract.
"""

from __future__ import annotations

import functools
import itertools
from typing import List, Sequence, Tuple

import torch

from ..ops import soa

# Largest joint count served by the exact facet enumeration.  The facet
# axis costs C(n, 5) x batch memory per live tensor (n=7 -> 21 rows, n=10
# -> 252), so very redundant arms go to the iterative ADMM path
# (solver/diffik.py routes); callers with 8-10 joints and huge batches
# should chunk the batch.
MAX_EXACT_N = 10
MIN_EXACT_N = 5

_TINY = 1e-30


@functools.lru_cache(maxsize=None)
def _subset_tables(n: int, dtype: torch.dtype, device: torch.device):
    """Static tables of the C(n, 5) subsets on ``device``: ``idx[m]`` (C,)
    int64, the generator at subset position m, and ``memb`` (C, n) in
    ``dtype``, 1 where generator i spans subset c."""
    subsets = list(itertools.combinations(range(n), 5))
    idx = torch.tensor(subsets, dtype=torch.int64)          # (C, 5)
    memb = torch.zeros((len(subsets), n), dtype=dtype)
    memb.scatter_(1, idx, 1.0)
    return ([idx[:, m].contiguous().to(device) for m in range(5)],
            memb.to(device))


def _facet_normals(sub) -> soa.Vec:
    """Unit normal of every subset's facet: ``sub[m][k]`` is (C, *lane),
    component k of the generator at subset position m.

    Gram-Schmidt over the 5 generators, then the best-conditioned column of
    the complement projector.  A degenerate subset yields *some* unit
    direction, which still produces a valid (upper-bound) cut.
    """
    qvecs = []
    for m in range(5):
        c_vec = list(sub[m])
        for qv in qvecs:
            d = soa.vec_dot(qv, c_vec)
            c_vec = [c_vec[k] - d * qv[k] for k in range(6)]
        inv = torch.rsqrt(soa.vec_dot(c_vec, c_vec).clamp_min(_TINY))
        qvecs.append([c_vec[k] * inv for k in range(6)])

    # ||(I - QQ^T) e_k||^2 = 1 - sum_m Q[k,m]^2 (orthonormal columns);
    # take the best-conditioned complement column as the normal.
    nk = [1.0 - soa.ssum([qv[k] * qv[k] for qv in qvecs]) for k in range(6)]
    best = nk[0]
    coef = [qv[0] for qv in qvecs]
    one, zero = torch.ones_like(best), torch.zeros_like(best)
    ek = [one] + [zero] * 5
    for k in range(1, 6):
        better = nk[k] > best
        best = torch.where(better, nk[k], best)
        coef = [torch.where(better, qv[k], cm) for qv, cm in zip(qvecs, coef)]
        ek = [torch.where(better, one if j == k else zero, ek[j])
              for j in range(6)]
    inv = torch.rsqrt(best.clamp_min(_TINY))
    return [(ek[j] - soa.ssum([cm * qv[j] for cm, qv in zip(coef, qvecs)]))
            * inv for j in range(6)]


def gauge_solve(gens: Sequence[soa.Vec], v: soa.Vec
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Exit parameter and boundary coordinates of the ray {t v} through
    the zonotope spanned by ``gens``.

    ``gens`` is a length-n list of 6-component generator vectors (lane
    tensors, or Python floats for static components); ``v`` a 6-component
    direction of lane tensors.  Returns ``(t, u)``: ``t`` (lane-shaped; +inf
    when every cut degenerates) such that ``t * v`` is on the zonotope
    boundary, and unit-box coordinates ``u`` (length n) with
    ``sum_i u_i gens[i] ~= t * v`` and ``|u_i| <= 1`` (up to roundoff) at
    any finite ``t``.
    """
    n = len(gens)
    if n < MIN_EXACT_N:
        raise ValueError(f"gauge_solve needs >= {MIN_EXACT_N} generators")

    lane = torch.broadcast_shapes(*[c.shape for c in v])
    dtype, device = v[0].dtype, v[0].device

    def to_lane(c):
        if not isinstance(c, torch.Tensor):
            return torch.full(lane, float(c), dtype=dtype, device=device)
        return c.to(dtype).expand(lane)

    gens = [[to_lane(gk) for gk in gi] for gi in gens]
    v = [to_lane(c) for c in v]
    idx, memb = _subset_tables(n, dtype, device)

    # Subset-position stacks: sub[m][k] is (C, *lane), row c holding the
    # k-th component of the generator at position m of subset c.
    comp = [torch.stack([gens[i][k] for i in range(n)], dim=0)
            for k in range(6)]
    sub = [[comp[k].index_select(0, idx[m]) for k in range(6)]
           for m in range(5)]
    del comp
    w = _facet_normals(sub)                          # (C, *lane) x 6
    del sub

    # --- cuts ------------------------------------------------------------
    # Cut-validity floor: |w.v| must clear the f32 noise floor of the dot
    # products, RELATIVE to |v|.  At rank-deficient J (exactly singular
    # configurations), every spanning subset's normal is orthogonal to
    # range(J); if v lies in the range, both w.v and h are pure roundoff
    # and their ratio is garbage: those cuts must be excluded, leaving
    # t = +inf, which the caller reports as ok=False (the facet
    # enumeration cannot certify flat zonotopes; measure-zero configs).
    # A *genuine* near-parallel facet whose cut this floor excludes has
    # t = h/|d| >= h / floor, huge, so exclusion never tightens alpha
    # below min(1, t*); any overshoot is caught by the caller's tracking
    # gate.
    vinf = v[0].abs()
    for k in range(1, 6):
        vinf = torch.maximum(vinf, v[k].abs())
    d_floor = 1e-5 * vinf                            # (*lane,)

    d = soa.vec_dot(w, v)                            # (C, *lane)
    dabs = d.abs()
    h = soa.ssum([soa.vec_dot(w, gens[i]).abs() for i in range(n)])
    t_c = torch.where(dabs > d_floor, h / dabs.clamp_min(_TINY), torch.inf)
    del h, dabs

    best_t = torch.amin(t_c, dim=0)                  # (*lane,)
    # The first minimal row wins a tie; t does not depend on the choice.
    cidx = torch.argmin(t_c, dim=0, keepdim=True)    # (1, *lane) int64
    del t_c
    # The winner's normal, oriented along v.
    flip = torch.gather(d, 0, cidx)[0] < 0
    best_w = []
    for j in range(6):
        wj = torch.gather(w[j], 0, cidx)[0]
        best_w.append(torch.where(flip, -wj, wj))
    del w, d

    # --- boundary-point recovery on the winning facet --------------------
    # Membership mask mu_i = 1 when generator i spans the winning facet.
    mu_all = memb[cidx[0]]                           # (*lane, n)
    mu = [mu_all[..., i] for i in range(n)]

    one = torch.ones(lane, dtype=dtype, device=device)
    a_dots = [soa.vec_dot(best_w, gens[i]) for i in range(n)]
    u_out = [torch.where(a >= 0, one, -one) for a in a_dots]

    # Finite stand-in for t on degenerate (all-cuts-invalid) lanes so the
    # recovery math stays NaN-free; the caller masks those lanes out.
    t_f = torch.where(torch.isfinite(best_t), best_t, 0.0)

    # Residual target: r = t v - sum_{i not in facet} u_out_i g_i.
    out_u = [(1.0 - mu[i]) * u_out[i] for i in range(n)]
    r = [t_f * v[k] - soa.ssum([out_u[i] * gens[i][k] for i in range(n)])
         for k in range(6)]

    # Masked normal equations over all n coordinates: facet rows solve the
    # least-squares system, non-facet rows are pinned to u_out (identity).
    # Both matrices are symmetric: the upper triangle is computed and
    # mirrored.
    gram = [[None] * n for _ in range(n)]
    kkt = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            gram[i][j] = gram[j][i] = soa.vec_dot(gens[i], gens[j])
            kkt[i][j] = kkt[j][i] = mu[i] * mu[j] * gram[i][j]
    tr = soa.ssum([mu[i] * gram[i][i] for i in range(n)]) + _TINY
    reg = 1e-7 * tr
    for i in range(n):
        kkt[i][i] = kkt[i][i] + (1.0 - mu[i])        # mu is exactly 0 or 1
    rhs = [mu[i] * soa.vec_dot(gens[i], r) + out_u[i] for i in range(n)]
    kkt_reg = [[kkt[i][j] + reg if i == j else kkt[i][j] for j in range(n)]
               for i in range(n)]
    factor = soa.cholesky_factor(kkt_reg)
    u = soa.cholesky_apply(factor, rhs)
    # Two iterative-refinement steps against the UNregularized system kill
    # both the Tikhonov bias (~reg / sigma_min^2 relative, ~1e-4 on
    # short-link arms) and f32 factorization roundoff.
    for _ in range(2):
        resid = [rhs[i] - soa.ssum([kkt[i][j] * u[j] for j in range(n)])
                 for i in range(n)]
        du = soa.cholesky_apply(factor, resid)
        u = [u[i] + du[i] for i in range(n)]
    return best_t, [ui.clamp(-1.0, 1.0) for ui in u]
