"""Differential IK: velocity-limited Cartesian tracking, solved exactly.

A port of ``optik_tpu/solver/diffik.py``.  Parity target: kylc/optik
``Robot::diff_ik`` (lib.rs:101-239), which solves

    max_{v, alpha} alpha
      s.t.  0 <= alpha <= 1                (move as far as possible ...)
            -v_max <= v <= v_max           (... within joint velocity limits)
            J_W(q) v = alpha * V_WE        (... along the commanded direction)

as a conic LP.  The primary path is the **exact zonotope gauge solver**
(solver/gauge.py): the LP's optimum is the exit point of the ray
{alpha * V} through the zonotope J_W([-v_max, v_max]), computed in closed
form by enumerating C(n, 5) facet-normal cuts, a fixed, element-wise SoA
computation with no iterations.  FK, the world Jacobian and the solve run on
the SoA layout (ops/soa.py) as plain eager tensor operations; the ADMM
formulation (solver/qp.py) is the path for joint counts outside the exact
path's range, the rescue of lanes the enumeration cannot certify, and an
independent test oracle.

The local-frame Jacobian is rotated into the world frame exactly as
lib.rs:184-189 does (for the SoA path this folds to computing the
world-frame geometric columns directly: R_WE @ (R_WE^T lin_w) = lin_w).

Returns (alpha, v, ok).  v is feasible BY CONSTRUCTION: boundary-facet
coordinates are clipped to the unit box and scaled by alpha / t <= 1, so
the reference's bound contracts (alpha in [0,1] +- 1e-6, |v_i| <= v_max +
1e-6, test_ik.rs:200-205) hold exactly.  ``ok`` mirrors the LP solver's
Solved status via the Cartesian tracking residual |J_W v - alpha V|, the
honest gate that catches every degenerate-geometry corner the closed form
can round through (rank-deficient J, V outside the reachable cone).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import kinematics as K
from ..ops import soa
from ..utils.precision import use_full_f32_matmuls
from . import gauge, qp

# Success gate: the behavioral contract asserts J_W v == alpha V at 1e-5
# (reference example + tests).  The residual is judged relative to the
# command magnitude (an absolute gate would spuriously fail large-|V|
# commands in f32).
_TRACK_TOL = 1e-5

# ADMM constants (a reward of -100 breaks f32 dual scaling, hence -1).
_STAT_TOL = 1e-3
_REG = 1e-9
_ALPHA_REWARD = -1.0


def _jacobian_cols_world(consts, frames, t_ee):
    """World-frame geometric Jacobian columns (6-lists: linear, angular).

    Reference contract: J_W = blockdiag(R_WE) @ J_local (lib.rs:184-189);
    since J_local = blockdiag(R_WE^T) @ J_world (kinematics.rs:179-180)
    this is just the world-frame geometric Jacobian, computed directly.
    A prismatic column's angular part is the static 0.0, which the SoA
    arithmetic folds away.
    """
    axes, pris = consts[2], consts[3]
    cols = []
    for j, (rj, pj) in enumerate(frames):
        dir_w = soa.mat_vec(rj, axes[j])
        if pris[j]:
            cols.append(list(dir_w) + [0.0, 0.0, 0.0])
        else:
            lin_w = soa.vec_cross(dir_w, soa.vec_sub(t_ee, pj))
            cols.append(list(lin_w) + list(dir_w))
    return cols


def _abs_max(comps) -> torch.Tensor:
    out = comps[0].abs()
    for c in comps[1:]:
        out = torch.maximum(out, c.abs())
    return out


def build_batch_solver(spec, dtype: torch.dtype):
    """The batched diff-IK step of one robot on the exact path.

    Returns ``fn(x0 (B,A), v_we (B,6), v_max (B,A), ee_r, ee_t) ->
    (alpha (B,), v (B,A), ok (B,))`` on tensors of ``dtype`` on any one
    device, or ``None`` outside 5 <= n <= 10 joints, where the caller takes
    the ADMM path.  The C(n,5) facet cuts run as a tensor axis: memory
    scales as C(n,5) x B (see gauge.MAX_EXACT_N), and eager execution keeps
    a few dozen such tensors alive at the peak, so 8-10-joint arms with
    huge batches should be chunked.  Each lane's result is bitwise
    independent of B.
    """
    n = spec.num_positions
    if not (gauge.MIN_EXACT_N <= n <= gauge.MAX_EXACT_N):
        return None  # caller takes the ADMM path

    consts = soa.chain_constants(spec)

    def solve(x0, v_we, v_max, ee_r=None, ee_t=None):
        for name, t in (("x0", x0), ("v_we", v_we), ("v_max", v_max)):
            if t.dtype != dtype:
                raise TypeError(f"{name} is {t.dtype}, the solver was built "
                                f"for {dtype}")
        use_full_f32_matmuls()
        # One transposed copy each, so that every lane tensor is contiguous.
        qs = list(x0.t().contiguous().unbind(0))
        v = list(v_we.t().contiguous().unbind(0))
        vm = list(v_max.t().contiguous().unbind(0))
        eem = eev = None
        if ee_r is not None:
            eem = [[ee_r[i, j] for j in range(3)] for i in range(3)]
            eev = [ee_t[i] for i in range(3)]
        frames, _r_ee, t_ee = soa.fk_with_ee(consts, qs, eem, eev)
        cols = _jacobian_cols_world(consts, frames, t_ee)
        del frames

        gens = [[soa.smul(vm[j], cols[j][k]) for k in range(6)]
                for j in range(n)]
        t, u = gauge.gauge_solve(gens, v)
        del gens

        finite = torch.isfinite(t)
        t_f = torch.where(finite, t, 1.0)
        alpha = torch.where(finite, t_f.clamp_max(1.0), 0.0)
        # Scale the boundary point back to alpha: star-shaped + symmetric
        # box => (alpha/t) * u stays in the box and tracks alpha * V.
        scale = torch.where(finite, alpha / t_f.clamp_min(gauge._TINY), 0.0)
        vel = [vm[j] * u[j] * scale for j in range(n)]

        # V ~ 0: any alpha works with v = 0; the reference LP returns its
        # maximum, alpha = 1 (the equality rows vanish).
        vmag = soa.ssum([c.abs() for c in v])
        null_v = vmag < 1e-30
        alpha = torch.where(null_v, 1.0, alpha)
        vel = [torch.where(null_v, 0.0, vj) for vj in vel]

        # Honest success gate: Cartesian tracking of the *returned* v.
        track = [soa.ssum([soa.smul(vel[j], cols[j][k]) for j in range(n)])
                 - alpha * v[k] for k in range(6)]
        tmax = _abs_max(track)
        vinf = _abs_max(v)
        # No reliable facet cut with a nonzero command => the enumeration
        # cannot certify the geometry (rank-deficient J with V in its
        # range, see gauge.py d_floor); report failure, as the LP solver's
        # non-Solved statuses do (lib.rs:230-238).
        ok = (tmax < _TRACK_TOL * (1.0 + vinf)) & torch.isfinite(alpha) \
            & (finite | null_v)
        for vj in vel:
            ok = ok & torch.isfinite(vj)

        return alpha, torch.stack(vel, dim=-1), ok

    return solve


# --- ADMM path (fallback, rescue and test oracle) ---------------------------


def _build_qp(params: K.ChainParams, x0, v_we, v_max, ee_r, ee_t):
    """The LP as a QP per lane: x0 (B,A), v_we (B,6), v_max (B,A)."""
    n = params.num_positions
    b = x0.shape[0]
    kw = dict(dtype=x0.dtype, device=x0.device)

    ee_rot, _ee_pos, j_local = K.fk_and_jacobian(params, x0, ee_r, ee_t)
    # Rotate the local (EE-frame) Jacobian into the world frame: both the
    # linear and angular row blocks are premultiplied by R_WE (lib.rs:184-189).
    j_w = torch.cat([ee_rot @ j_local[:, :3], ee_rot @ j_local[:, 3:]],
                    dim=1)

    p = (_REG * torch.eye(n + 1, **kw)).expand(b, n + 1, n + 1)
    qv = torch.cat([torch.zeros(n, **kw),
                    torch.full((1,), _ALPHA_REWARD, **kw)]).expand(b, n + 1)

    # Rows: [J_W | -V] (equality), [I | 0] (velocity box), [0 | 1] (alpha box)
    a_eq = torch.cat([j_w, -v_we[:, :, None]], dim=2)            # (B, 6, n+1)
    a_box = torch.eye(n + 1, **kw).expand(b, n + 1, n + 1)
    a = torch.cat([a_eq, a_box], dim=1)

    zero6 = torch.zeros((b, 6), **kw)
    l = torch.cat([zero6, -v_max, torch.zeros((b, 1), **kw)], dim=1)
    u = torch.cat([zero6, v_max, torch.ones((b, 1), **kw)], dim=1)
    return p, qv, a, l, u


def _finalize(a, v_max, sol: qp.QPSolution, n: int):
    """Project onto the box, then judge success, per lane."""
    v = torch.minimum(torch.maximum(sol.x[:, :n], -v_max), v_max)
    alpha = sol.x[:, n].clamp(0.0, 1.0)
    xc = torch.cat([v, alpha[:, None]], dim=1)
    track = torch.amax((a[:, :6] @ xc[:, :, None])[:, :, 0].abs(), dim=1)
    ok = ((track < _TRACK_TOL) & (sol.dual_res < _STAT_TOL)
          & torch.isfinite(xc).all(dim=1))
    return alpha, v, ok


def diff_ik_admm_batch(params: K.ChainParams, x0, v_we, v_max, ee_r=None,
                       ee_t=None):
    """Batched ADMM diff-IK (fallback path / oracle): (B,A),(B,6),(B,A) ->
    (alpha (B,), v (B,A), ok (B,)), on the device of ``params``."""
    use_full_f32_matmuls()
    p, qv, a, l, u = _build_qp(params, x0, v_we, v_max, ee_r, ee_t)
    sol = qp.solve(p, qv, a, l, u)
    return _finalize(a, v_max, sol, params.num_positions)


def diff_ik_one(params: K.ChainParams, x0, v_we, v_max,
                ee_r: Optional[torch.Tensor] = None,
                ee_t: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single diff-IK step on the ADMM path: returns (alpha, v (A,), ok).

    Kept as the routing-independent oracle; the Robot facade routes
    scalar calls through the batched gauge solver at B=1 instead (bitwise
    identical to the batch path's lane: the gauge computation is
    element-wise over lanes).
    """
    alpha, v, ok = diff_ik_admm_batch(params, x0[None], v_we[None],
                                      v_max[None], ee_r, ee_t)
    return alpha[0], v[0], ok[0]
