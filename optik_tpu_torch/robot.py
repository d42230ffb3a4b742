"""Robot facade: the user-facing API of ``optik_tpu.Robot``, for the slice of
it the port runs so far.

  * ``Robot.from_urdf_file(path, base_link, ee_link)`` (and ``_str``)
  * ``num_positions()``, ``joint_limits()``, ``set_parallelism(n)``
  * ``random_configuration()``
  * ``fk(x, ee_offset=None) -> 4x4`` and ``fk_batch``
  * ``joint_jacobian(x, ee_offset=None) -> 6xN`` and ``jacobian_batch``
  * ``ik(config, target, x0, ee_offset=None) -> (list, cost) | None`` and
    ``ik_batch``
  * ``diff_ik(x0, V_WE, v_max, ee_offset=None) -> (alpha, v) | None`` and
    ``diff_ik_batch(..., rescue=True)``

A ``Robot`` lives on one explicit ``device`` (default ``"cuda"``; on a
machine without a card that default raises rather than switching to the
CPU).  ``ik_batch`` on CUDA runs the hand-written LM kernel
(``ops/cuda/lm_kernel.py``) in Speed and Quality mode, with per-axis
weights, any ``seed_batch`` up to 64 lanes per pose and unlimited restart
rounds (``max_restarts=0``); on the CPU it runs the plain torch loop
(``solver/ik.build_batch_solver``).  A config with more than 64 seed lanes
per pose (``min(seed_batch, total_restarts)``), which the kernel cannot
hold, runs that plain loop on the card, as the JAX facade leaves its kernel
for its XLA path there; the route is decided by config before anything is
built, and no failure of the kernel turns into the plain loop.
The Jacobians and differential IK are plain eager tensor operations on the
Robot's device (no kernel of the JAX package lies on that path): the exact
zonotope-gauge solve for 5 to 10 joints (``solver/gauge.py``), the ADMM
solve (``solver/qp.py``) otherwise and as the rescue of lanes the gauge
cannot certify.  ``ik_batch`` keeps the JAX signature's ``rescue_overflow``:
the port runs the single-shot schedule only (it has no cascade, by decision:
``solver/ik.py``), which has no capacity to overflow, so nothing is ever
re-solved and ``overflow_count`` is 0.  Sharding over several devices is
``optik_tpu_torch.parallel``.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .config import DEFAULT_RESTARTS, SolverConfig
from .models.chain import ChainSpec
from .ops import kinematics as K
from .ops import soa
from .ops.cuda import lm_kernel
from .solver import diffik
from .solver import ik as ik_mod
from .utils.precision import use_full_f32_matmuls

ArrayLike = Union[np.ndarray, torch.Tensor, "list", "tuple"]


def _parse_pose(pose) -> Tuple[np.ndarray, np.ndarray]:
    """4x4 row-major -> (R, t) float64; validates rigidity (optik-py
    ``parse_pose``: a non-rigid input raises "invalid target transform
    specified")."""
    m = np.asarray(pose, dtype=np.float64)
    if m.shape != (4, 4):
        raise ValueError("invalid target transform specified")
    r = m[:3, :3]
    if (not np.allclose(r @ r.T, np.eye(3), atol=1e-6)
            or not np.isclose(np.linalg.det(r), 1.0, atol=1e-6)
            or not np.allclose(m[3], [0.0, 0.0, 0.0, 1.0], atol=1e-6)):
        raise ValueError("invalid target transform specified")
    return r.copy(), m[:3, 3].copy()


class Robot:
    """A serial-chain robot bound to one torch device and dtype."""

    def __init__(self, spec: ChainSpec, dtype: Optional[torch.dtype] = None,
                 device: "str | torch.device" = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Robot(device='cuda') but torch.cuda.is_available() is "
                "False; pass device='cpu' for the plain torch solver")
        use_full_f32_matmuls()
        self.spec = spec
        self.dtype = dtype or torch.float32
        self._consts = soa.chain_constants(spec)
        self._rng = np.random.default_rng()
        self._solvers = {}
        self._params = None
        self._diffik_cache = None
        self._parallelism_noted = False

    # --- constructors -----------------------------------------------------

    @staticmethod
    def from_urdf_file(path: "str | os.PathLike[str]", base_link: str,
                       ee_link: str, dtype: Optional[torch.dtype] = None,
                       device: "str | torch.device" = "cuda") -> "Robot":
        return Robot(ChainSpec.from_urdf_file(path, base_link, ee_link),
                     dtype=dtype, device=device)

    @staticmethod
    def from_urdf_str(urdf: str, base_link: str, ee_link: str,
                      dtype: Optional[torch.dtype] = None,
                      device: "str | torch.device" = "cuda") -> "Robot":
        return Robot(ChainSpec.from_urdf_str(urdf, base_link, ee_link),
                     dtype=dtype, device=device)

    # --- introspection ----------------------------------------------------

    def num_positions(self) -> int:
        return self.spec.num_positions

    def joint_limits(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.spec.joint_limits()

    def set_parallelism(self, n: int) -> None:
        """Reference-API compatibility no-op (lib.rs:66-72): occupancy is
        set by batch shapes and results are deterministic at any size."""
        if not self._parallelism_noted:
            logging.getLogger(__name__).info(
                "optik_tpu_torch: set_parallelism(%d) is a no-op", n)
            self._parallelism_noted = True

    def random_configuration(self, rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
        """Uniform sample within the joint limits (unbounded: [-pi, pi])."""
        rng = rng or self._rng
        lo, hi = self.joint_limits()
        lo = np.where(np.isfinite(lo), lo, -np.pi)
        hi = np.where(np.isfinite(hi), hi, np.pi)
        return rng.uniform(lo, hi)

    # --- kinematics -------------------------------------------------------

    def _tensor(self, v) -> torch.Tensor:
        return ik_mod.as_tensor(v, self.dtype, self.device)

    def _ee_offset(self, ee_offset):
        """(R, t) tensors of the offset, or (None, None)."""
        if ee_offset is None:
            return None, None
        r, t = _parse_pose(ee_offset)
        return self._tensor(r), self._tensor(t)

    @property
    def params(self) -> K.ChainParams:
        """The chain's constants as tensors on this Robot's device (the
        array path: ``ops/kinematics.py``, the ADMM diff-IK solve)."""
        if self._params is None:
            self._params = K.ChainParams.from_spec(self.spec, self.dtype,
                                                   device=self.device)
        return self._params

    def _fk_soa(self, x: torch.Tensor, ee_offset):
        """SoA FK of ``x`` (..., A): (frames, r_ee, t_ee, full), ``full``
        spreading a component (lane tensor or static float) over the
        lanes."""
        ee_r, ee_t = self._ee_offset(ee_offset)
        eem = eev = None
        if ee_r is not None:
            eem = [[ee_r[i, j] for j in range(3)] for i in range(3)]
            eev = [ee_t[i] for i in range(3)]
        comps = [x[..., j] for j in range(self.num_positions())]
        frames, r_ee, t_ee = soa.fk_with_ee(self._consts, comps, eem, eev)
        lane = x.shape[:-1]

        def full(v):
            return torch.broadcast_to(torch.as_tensor(
                v, dtype=self.dtype, device=self.device), lane)

        return frames, r_ee, t_ee, full

    def fk_batch(self, x: ArrayLike, ee_offset: Optional[ArrayLike] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched EE poses: (..., A) -> ((..., 3, 3), (..., 3)) tensors."""
        _, r_ee, t_ee, full = self._fk_soa(self._tensor(x), ee_offset)
        r = torch.stack([torch.stack([full(r_ee[i][j]) for j in range(3)],
                                     dim=-1) for i in range(3)], dim=-2)
        t = torch.stack([full(t_ee[i]) for i in range(3)], dim=-1)
        return r, t

    def fk(self, x: ArrayLike,
           ee_offset: Optional[ArrayLike] = None) -> np.ndarray:
        """EE pose as a 4x4 row-major matrix (optik-py/src/lib.rs:103-115)."""
        x = self._check_q(x, "x")
        r, t = self.fk_batch(x[None], ee_offset)
        m = np.eye(4)
        m[:3, :3] = r[0].double().cpu().numpy()
        m[:3, 3] = t[0].double().cpu().numpy()
        return m

    def joint_jacobian(self, x: ArrayLike,
                       ee_offset: Optional[ArrayLike] = None) -> np.ndarray:
        """Local-frame geometric Jacobian (6, N) (optik-py/src/lib.rs:91-101),
        on the array path (``ops/kinematics.py``)."""
        x = self._check_q(x, "x")
        ee_r, ee_t = self._ee_offset(ee_offset)
        return K.joint_jacobian(self.params, self._tensor(x), ee_r,
                                ee_t).cpu().numpy()

    def jacobian_batch(self, x: ArrayLike,
                       ee_offset: Optional[ArrayLike] = None) -> torch.Tensor:
        """Batched local-frame Jacobians on the SoA path: (..., A) ->
        (..., 6, A)."""
        frames, r_ee, t_ee, full = self._fk_soa(self._tensor(x), ee_offset)
        cols = soa.jacobian_cols(self._consts, frames, r_ee, t_ee)
        return torch.stack([torch.stack([full(col[i]) for col in cols],
                                        dim=-1) for i in range(6)], dim=-2)

    # --- inverse kinematics -----------------------------------------------

    def _check_q(self, x, name) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if x.shape != (self.num_positions(),):
            raise ValueError(f"len({name}) != num_positions")
        return x

    def _check_seeds(self, x0) -> None:
        """Raise if any seed lies outside the joint limits (lib.rs:251-254).

        Tensor seeds are checked where they lie, fetching one boolean."""
        lo, hi = self.joint_limits()
        if isinstance(x0, torch.Tensor):
            lo_t = torch.as_tensor(lo, dtype=x0.dtype, device=x0.device)
            hi_t = torch.as_tensor(hi, dtype=x0.dtype, device=x0.device)
            bad = bool(((x0 < lo_t) | (x0 > hi_t)).any())
        else:
            x0 = np.asarray(x0, dtype=np.float64)
            bad = bool(np.any(x0 < lo) or np.any(x0 > hi))
        if bad:
            raise ValueError("seed joint position outside of joint limits")

    def ik(self, config: SolverConfig, target: ArrayLike, x0: ArrayLike,
           ee_offset: Optional[ArrayLike] = None
           ) -> Optional[Tuple[List[float], float]]:
        """Single-pose IK; returns (solution, cost) or None (lib.rs:241-415).

        Runs ``ik_batch`` at B = 1.  On CUDA the kernel evaluates atan2 and
        sin/cos as f32 polynomials (~1e-7 abs error), so found-ness of
        marginal poses (cost within ~1e-7 of tol_f) can differ from the
        exact-libm plain path on the CPU.
        """
        x0 = self._check_q(x0, "x0")
        self._check_seeds(x0)
        tgt_r, tgt_t = _parse_pose(target)
        res = self.ik_batch(config, tgt_r[None], tgt_t[None], x0[None],
                            ee_offset=ee_offset, validate_seeds=False)
        if not bool(res.found[0]):
            return None
        return (res.x[0].double().cpu().tolist(), float(res.cost[0]))

    def _batch_solver(self, config: SolverConfig, ee_offset):
        """The cached solver for (config, ee_offset) on this device:
        ``(on_kernel, fn)``.

        On CUDA the LM kernel, unless the config asks for more seed lanes
        per pose than it holds (``lm_kernel.MAX_SEED_LANES``): then the
        plain loop on the card, with exact libm sin/cos/atan2 as on the CPU
        (``optik_tpu/robot.py:127-133`` routes such configs to XLA alike).
        The kernel folds ``ee_offset`` in when it is built; the plain loop
        takes it per call."""
        ee_key = None if ee_offset is None else tuple(
            np.asarray(v, np.float64).tobytes() for v in ee_offset)
        key = (config, ee_key)
        entry = self._solvers.get(key)
        if entry is None:
            lanes = min(config.seed_batch, config.total_restarts)
            if (self.device.type == "cuda"
                    and lanes <= lm_kernel.MAX_SEED_LANES):
                entry = (True, lm_kernel.build_kernel_solver(
                    self.spec, config, ee_offset=ee_offset))
            else:
                entry = (False, ik_mod.build_batch_solver(
                    self.spec, config, self.dtype, device=self.device))
            self._solvers[key] = entry
        return entry

    def _ik_batch_unlimited(self, config: SolverConfig, tgt_r, tgt_t, x0,
                            ee_offset, validate_seeds) -> ik_mod.IKResult:
        """Unlimited restarts (``max_restarts=0``) as deterministic rounds.

        Rounds of ``DEFAULT_RESTARTS`` seeds: round r re-solves only the
        poses no earlier round found, with the next slice of the restart
        stream (restart indices ``r*R .. r*R + R - 1``), until every pose is
        found or ``config.unlimited_rounds_cap`` rounds have run
        (``optik_tpu/robot.py:419-507``).  A pose's outcome depends only on
        its own restart stream, so results do not depend on the batch or on
        where round boundaries fall; a pose found in an earlier round keeps
        that round's result bit for bit.

        ``iters`` of a pose found in round r > 0 is that round's
        iterations-to-converge, not a sum over rounds.  The JAX version pads
        each round's hard set to a power-of-two bucket to bound its
        recompiles and scales the pad rows' share out of ``lane_iters`` as
        an estimate; nothing here compiles per shape, so rounds run at
        their true size and ``lane_iters`` is the exact sum over rounds.  On
        CUDA a round's ``lane_iters`` is the sum over its poses of the
        iterations the pose's thread group ran (until its last lane
        stopped) times the S lanes; on the CPU it is the lockstep loop's
        count times B * S.

        The rounds are driven from the host but stay on the device: per
        round the host reads the indices of the unfound poses (one fetch);
        targets, solutions and costs never leave the device.
        """
        base = config.replace(max_restarts=DEFAULT_RESTARTS)
        tgt_r, tgt_t, x0 = self._tensor(tgt_r), self._tensor(tgt_t), \
            self._tensor(x0)
        res = self.ik_batch(base, tgt_r, tgt_t, x0, ee_offset=ee_offset,
                            validate_seeds=validate_seeds)
        found, x, cost, iters = res.found, res.x, res.cost, res.iters
        lane_iters = res.lane_iters
        for r in range(1, max(1, config.unlimited_rounds_cap)):
            bad = torch.nonzero(~found).squeeze(1)  # the round's one fetch
            if bad.numel() == 0:
                break
            sub = self.ik_batch(base, tgt_r[bad], tgt_t[bad], x0[bad],
                                ee_offset=ee_offset, validate_seeds=False,
                                _restart_offset=r * DEFAULT_RESTARTS)
            ok = sub.found
            x[bad] = torch.where(ok[:, None], sub.x, x[bad])
            cost[bad] = torch.where(ok, sub.cost, cost[bad])
            iters[bad] = torch.where(ok, sub.iters, iters[bad])
            found[bad] = ok
            lane_iters = lane_iters + sub.lane_iters
        return ik_mod.IKResult(found=found, x=x, cost=cost, iters=iters,
                               lane_iters=lane_iters,
                               found_count=found.sum(),
                               overflow_count=res.overflow_count)

    def ik_batch(self, config: SolverConfig, tgt_r: ArrayLike,
                 tgt_t: ArrayLike, x0: ArrayLike,
                 ee_offset: Optional[ArrayLike] = None,
                 validate_seeds: bool = True,
                 rescue_overflow: bool = True,
                 _restart_offset: Optional[int] = None) -> ik_mod.IKResult:
        """Batched IK over B poses: (B,3,3), (B,3), (B,A) -> IKResult.

        Seeds outside the joint limits raise, as in the scalar path;
        ``validate_seeds=False`` skips that check (for seeds in the limits
        by construction).  On CUDA this runs the LM kernel and raises
        ``TypeError`` unless the Robot's dtype is float32; a config with
        more than 64 seed lanes per pose runs the plain loop on the card
        (see :meth:`_batch_solver`).
        ``config.max_restarts == 0`` runs unlimited-restart rounds (see
        :meth:`_ik_batch_unlimited`), whose continuation rounds pass
        ``_restart_offset``.  The winner-selection key (``sel_key``) is
        internal and not part of the result, as in the JAX package.

        ``rescue_overflow`` is the JAX package's (``optik_tpu/robot.py``):
        there it re-solves the poses the cascade's capacities denied their
        full budget.  Every path here is the single-shot schedule the
        rescue restores, so the flag changes nothing, no pose is re-solved
        and ``overflow_count`` is 0.
        """
        if config.max_restarts == 0 and _restart_offset is None:
            return self._ik_batch_unlimited(config, tgt_r, tgt_t, x0,
                                            ee_offset, validate_seeds)
        if validate_seeds:
            self._check_seeds(x0)
        tgt_r, tgt_t, x0 = self._tensor(tgt_r), self._tensor(tgt_t), \
            self._tensor(x0)
        ee_pair = None if ee_offset is None else _parse_pose(ee_offset)
        on_kernel, fn = self._batch_solver(config, ee_pair)
        off = int(_restart_offset or 0)
        if on_kernel:
            res = fn(tgt_r, tgt_t, x0, restart_offset=off)
        else:
            ee_r = ee_t = None
            if ee_pair is not None:
                ee_r = self._tensor(ee_pair[0])
                ee_t = self._tensor(ee_pair[1])
            res = fn(tgt_r, tgt_t, x0, ee_r, ee_t, restart_offset=off)
        return res._replace(sel_key=None, overflow_count=torch.zeros(
            (), dtype=torch.int32, device=self.device))

    # --- differential IK --------------------------------------------------

    def _diffik_solver(self):
        """Cached batched diff-IK step on the exact gauge path, or None
        where the joint count routes to the ADMM path."""
        if self._diffik_cache is None:
            self._diffik_cache = (
                diffik.build_batch_solver(self.spec, self.dtype),)
        return self._diffik_cache[0]

    def diff_ik(self, x0: ArrayLike, V_WE: ArrayLike, v_max: ArrayLike,
                ee_offset: Optional[ArrayLike] = None
                ) -> Optional[Tuple[float, List[float]]]:
        """Velocity-limited diff-IK step (lib.rs:101-239).

        Maximizes the scaling alpha in [0, 1] such that J_W(q) v = alpha*V_WE
        with |v_i| <= v_max_i; returns (alpha, v) or None on solver failure.
        Routes through the batched solver at B=1 (the gauge computation is
        element-wise over lanes, so scalar and batch results are identical).
        """
        x0 = self._check_q(x0, "x0")
        v_we = np.asarray(V_WE, dtype=np.float64)
        if v_we.shape != (6,):
            raise ValueError("len(V_WE) != 6")
        v_max = np.asarray(v_max, dtype=np.float64)
        if v_max.shape != (self.num_positions(),):
            raise ValueError("len(v_max) != num_positions")
        alpha, v, ok = self.diff_ik_batch(x0[None], v_we[None], v_max[None],
                                          ee_offset=ee_offset)
        if not bool(ok[0]):
            return None
        return float(alpha[0]), v[0].double().cpu().tolist()

    def _diffik_rescue(self, alpha, v, ok, x0, v_we, v_max, ee_r, ee_t):
        """Re-solve ok=False lanes with the iterative ADMM path and merge.

        The exact gauge enumeration reports ok=False on a small share of
        random instances: degenerate geometry (rank-deficient J with V in
        its range) its facet cuts cannot certify.  The reference's
        interior-point LP solves most of these (lib.rs:216-228); the ADMM
        formulation (``solver/diffik.diff_ik_admm_batch``) is the
        same-capability iterative solve, so re-solving just the failed
        lanes recovers that ok rate.  Lanes the ADMM also rejects stay
        ok=False (honest gate).

        The failed lanes are solved at their true count and merged on the
        device: the host fetches their indices (the call's one blocking
        round trip) and nothing else.  Lanes that were ok keep their values
        bit for bit.
        """
        bad = torch.nonzero(~ok).squeeze(1)  # the one fetch
        if bad.numel() == 0:
            return alpha, v, ok
        sa, sv, sk = diffik.diff_ik_admm_batch(
            self.params, x0[bad], v_we[bad], v_max[bad], ee_r, ee_t)
        idx = bad[sk]
        alpha[idx] = sa[sk]
        v[idx] = sv[sk]
        ok[idx] = True
        return alpha, v, ok

    def diff_ik_batch(self, x0: ArrayLike, V_WE: ArrayLike,
                      v_max: ArrayLike,
                      ee_offset: Optional[ArrayLike] = None,
                      rescue: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Batched diff-IK: (B,A), (B,6), (B,A) -> (alpha (B,), v (B,A),
        ok (B,)), tensors on this Robot's device.

        ``rescue`` (default True): re-solve any ok=False lanes of the
        exact gauge path with the iterative ADMM solver and merge (see
        :meth:`_diffik_rescue`).  The check fetches the failed lanes'
        indices (one blocking device round trip per call); pipelined
        throughput callers pass ``False`` and handle ok lanes themselves.

        The exact path holds a few dozen live (C(n,5), B) tensors at its
        peak (n=7: 21 rows, n=10: 252): chunk huge batches of 8-10-joint
        arms.
        """
        ee_r, ee_t = self._ee_offset(ee_offset)
        x0 = self._tensor(x0)
        v_we = self._tensor(V_WE)
        v_max = self._tensor(v_max)
        fn = self._diffik_solver()
        if fn is None:
            return diffik.diff_ik_admm_batch(self.params, x0, v_we, v_max,
                                             ee_r, ee_t)
        alpha, v, ok = fn(x0, v_we, v_max, ee_r, ee_t)
        if rescue:
            alpha, v, ok = self._diffik_rescue(alpha, v, ok, x0, v_we, v_max,
                                               ee_r, ee_t)
        return alpha, v, ok
