"""Restart scheduling and per-pose solution selection for the batched solver.

A port of ``optik_tpu/solver/ik.py`` (the single-program path that the JAX
package runs off a TPU):

  * restart 0 starts from the caller's seed ``x0``; restart i > 0 starts
    from row i of the deterministic seed table (:mod:`optik_tpu_torch.random`,
    bit-equal to ``fold_in(key(rng_seed), i)``), independent of the pose;
  * Speed mode's winner is the lowest restart index among successes;
  * Quality mode's winner is the success nearest to the caller's seed.

Both selections are batched reductions over the (B, S) lane grid; with a
mesh (``optik_tpu_torch/parallel/mesh.py``) the lane grid is partitioned
over ranks and the reductions meet in collectives.

The JAX package's cascade (``optik_tpu/solver/cascade.py``) is not ported,
by decision: it schedules a lockstep machine, where a block iterates until
its slowest pose stops, and its found mask equals the single-shot one
(``cascade.py:22-35``).  The port's kernel draws poses from a work queue
(97.1 executed warp slots per solve for the 91.1 needed), so every path here
is the single-shot schedule, which has no capacity to overflow.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SolutionMode, SolverConfig
from ..ops import kinematics as K
from ..ops import soa
from .. import random as rnd
from .. import telemetry
from . import lm, lm_soa

INT32_MAX = 2**31 - 1


class IKResult(NamedTuple):
    """Per-query result; ``found`` gates validity of ``x``/``cost``."""

    found: torch.Tensor  # (B,) bool
    x: torch.Tensor      # (B, A)
    cost: torch.Tensor   # (B,)
    # Winning lane's LM iterations-to-converge (0 when not found).
    iters: Optional[torch.Tensor] = None
    # Total LM lane-iterations this solve executed (0-d int64 tensor; its
    # definition depends on the path: see build_batch_solver and
    # ops/cuda/lm_kernel.solve_kernel).
    lane_iters: Optional[torch.Tensor] = None
    # Count of found poses (a 0-d tensor on the solve's device).
    found_count: Optional[torch.Tensor] = None
    # Per-pose winner-selection key: Speed mode = the winning restart index
    # (int32; INT32_MAX when not found), Quality mode = the winning seed
    # distance (+inf when not found).
    sel_key: Optional[torch.Tensor] = None
    # Count of poses whose post-screen failures overflowed the JAX cascade's
    # final-phase capacity and so did not receive the full restart budget
    # (0-d int32).  0 on the single-shot paths, which are the port's only
    # schedule (no capacity to overflow); None when not tracked.
    overflow_count: Optional[torch.Tensor] = None


def options_from_config(cfg: SolverConfig) -> lm.LMOptions:
    """Map the reference-compatible config onto LM options (see lm.py)."""
    return lm.LMOptions(
        max_iters=cfg.max_iters,
        tol_f=cfg.tol_f,
        tol_df=cfg.effective_tol_df,
        tol_dx=cfg.tol_dx,
        f_is_success=cfg.tol_f >= 0.0,
        df_is_success=cfg.tol_df >= 0.0,
        dx_is_success=cfg.tol_dx >= 0.0,
    )


def sample_bounds(params: K.ChainParams):
    """Finite sampling box for random restarts (tensors like
    ``params.lower``): unbounded joints sample in [-pi, pi]."""
    pi = torch.full_like(params.lower, math.pi)
    lo = torch.where(torch.isfinite(params.lower), params.lower, -pi)
    hi = torch.where(torch.isfinite(params.upper), params.upper, pi)
    return lo, hi


def restart_seeds(params: K.ChainParams, x0: torch.Tensor, rng_seed: int,
                  num_restarts: int) -> torch.Tensor:
    """(S, A) seed matrix: lane 0 = x0, lane i > 0 = the restart stream's
    draw i (``uniform(fold_in(PRNGKey(rng_seed), i))`` over
    :func:`sample_bounds`, bit-equal to the JAX package's; the port names
    the stream by its integer seed)."""
    if num_restarts <= 1:
        return x0[None]
    np_dtype = np.float64 if x0.dtype == torch.float64 else np.float32
    table = rnd.seed_table(rng_seed, num_restarts,
                           params.lower.cpu().numpy(),
                           params.upper.cpu().numpy(), np_dtype)
    rand = torch.tensor(table[1:], dtype=x0.dtype, device=x0.device)
    return torch.cat([x0[None], rand], dim=0)


def seed_distance(xs: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """|x - x0| per lane, (B, S, A) and (B, A) -> (B, S): the square root
    of the squared differences summed in joint order, the formula of the
    lockstep loop's and the CUDA kernel's per-lane best tracking, so the
    pick among lanes orders attempts exactly as each lane did."""
    e = xs - x0[:, None, :]
    return torch.sqrt(sum(e[..., p] ** 2 for p in range(xs.shape[-1])))


def select(mode: SolutionMode, xs, fs, success, x0, restart_idx=None,
           succ_iters=None) -> IKResult:
    """Pick each pose's winning lane: (B, S, A), (B, S), (B, S), (B, A).

    ``restart_idx`` (continuous-reseed path) carries the restart index each
    lane's final attempt used; Speed mode minimizes it so "first success"
    stays invariant to the lane layout.  Without it the lane's own seed
    index is the order.  Ties resolve to the lowest lane, as ``argmin``
    does in both frameworks.
    """
    b, s = fs.shape
    if mode == SolutionMode.SPEED:
        order = restart_idx if restart_idx is not None else \
            torch.arange(s, device=fs.device, dtype=torch.int32).expand(b, s)
        key = torch.where(success, order.to(torch.int32), INT32_MAX)
    else:
        key = torch.where(success, seed_distance(xs, x0), float("inf"))
    idx = torch.argmin(key, dim=1)
    rows = torch.arange(b, device=fs.device)
    found = success.any(dim=1)
    return IKResult(found=found, x=xs[rows, idx], cost=fs[rows, idx],
                    iters=None if succ_iters is None else
                    succ_iters[rows, idx],
                    found_count=found.sum(), sel_key=key[rows, idx])


def as_tensor(v, dtype, device) -> torch.Tensor:
    """``v`` (tensor, ndarray or nested lists) as a tensor of dtype/device;
    arrays are copied, so read-only inputs are safe."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


def chain_bounds(spec):
    """Box-projection bounds as Python floats (may be +-inf)."""
    return ([float(v) for v in spec.lower], [float(v) for v in spec.upper])


def build_batch_solver(spec, cfg: SolverConfig, dtype=torch.float64, *,
                       device, mesh=None):
    """A batched IK solver for one robot+config on the plain torch loop.

    Returns ``fn(tgt_r (B,3,3), tgt_t (B,3), x0 (B,A) [, ee_r, ee_t,
    restart_offset]) -> IKResult``.  Every pose runs
    S = min(seed_batch, total_restarts) lanes in one lockstep loop; the rest
    of the restart budget is consumed by continuous reseeding.
    ``restart_offset`` shifts the restart stream (row i of the seed table is
    the draw for index ``i + restart_offset``; one table per offset is kept).
    ``lane_iters`` is the loop's iteration count times B*S (every lane runs
    until the slowest lane stops).

    With ``mesh`` (a ``parallel.mesh.Mesh`` holding this rank) the (B, S)
    lanes are partitioned as ``P("data", "seed")``: this rank runs poses
    ``mesh.shard(B)`` and lanes ``[d*S/n, (d+1)*S/n)`` of each (d its seed
    index, n the seed axis).  The lanes of a pose meet through the mesh's
    :class:`~optik_tpu_torch.solver.lm_soa.LaneReduce` (the Speed freeze and
    the Quality cap over the seed group, the stop test over the whole mesh,
    so the loop runs the unsharded iteration count), and each pose's winner
    is merged over the seed group with the unsharded tie rules (the first
    minimal key in lane order).  Every rank returns the full (B, ...)
    result, equal to the unsharded solve's.

    ``device`` has no default: the caller names where the loop runs, so a
    harness that leaves it out fails instead of timing the host.
    """
    device = torch.device(device)
    consts = soa.chain_constants(spec)
    a = spec.num_positions
    lower, upper = chain_bounds(spec)
    opts = options_from_config(cfg)
    r_total = cfg.total_restarts
    s = min(cfg.seed_batch, r_total)
    use_reseed = r_total > s
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    tables = {}
    lanes = slice(0, s)
    if mesh is not None:
        n_seed = mesh.shape["seed"]
        if s % n_seed:
            raise ValueError(f"seed lanes {s} not divisible by mesh 'seed' "
                             f"axis {n_seed}")
        d = mesh.index("seed")
        lanes = slice(d * s // n_seed, (d + 1) * s // n_seed)

    def table_for(off: int) -> torch.Tensor:
        t = tables.get(off)
        if t is None:
            if r_total > 1:
                table_np = rnd.seed_table(cfg.rng_seed, r_total, spec.lower,
                                          spec.upper, np_dtype, off=off)
            else:
                table_np = np.zeros((1, a), np_dtype)
            t = tables[off] = torch.tensor(table_np, dtype=dtype,
                                           device=device)
        return t

    quality = cfg.solution_mode == SolutionMode.QUALITY

    def solve_batch(tgt_r, tgt_t, x0, ee_r=None, ee_t=None,
                    restart_offset: int = 0) -> IKResult:
        tgt_r = as_tensor(tgt_r, dtype, device)
        tgt_t = as_tensor(tgt_t, dtype, device)
        x0 = as_tensor(x0, dtype, device)
        if mesh is not None:
            rows = mesh.shard(tgt_r.shape[0])
            tgt_r, tgt_t, x0 = tgt_r[rows], tgt_t[rows], x0[rows]
        b = tgt_r.shape[0]
        with telemetry.span("optik.ik.layout"):
            table = table_for(int(restart_offset))
            seeds = torch.cat([x0[:, None, :],
                               table[1:s].expand(b, s - 1, a)],
                              dim=1)[:, lanes]
            lane_index = torch.arange(s, dtype=torch.int32,
                                      device=device)[lanes]
        if ee_r is not None:
            ee_r = as_tensor(ee_r, dtype, device)
            ee_t = as_tensor(ee_t, dtype, device)
        res = lm_soa.solve_soa(
            consts, lower, upper, opts, seeds,
            tgt_r[:, None], tgt_t[:, None], ee_r=ee_r, ee_t=ee_t,
            wl=cfg.linear_weight, wa=cfg.angular_weight,
            seed_table=table if use_reseed else None,
            lane_index=lane_index if use_reseed else None,
            total_restarts=r_total,
            success_stops_group=not quality,
            explore_full_budget=quality,
            quality_x0=x0[:, None],
            group_success_cap=(cfg.quality_max_successes or None)
            if quality else None,
            s_lanes=s, reduce=None if mesh is None else mesh.lane_reduce())
        # Speed orders lanes by restart index: the lane's own index (global
        # under a mesh) when each lane runs one restart.
        with telemetry.span("optik.ik.select"):
            order = res.restart_index
            if order is None:
                order = lane_index.expand(b, lane_index.shape[0])
            out = select(cfg.solution_mode, res.x, res.f, res.success, x0,
                         order, res.succ_iters)
        lane_iters = torch.tensor(res.iters * b * seeds.shape[1],
                                  dtype=torch.int64, device=device)
        if mesh is None:
            return out._replace(lane_iters=lane_iters)
        found, x, cost, iters = mesh.merge(out, out.sel_key)
        return IKResult(found=found, x=x, cost=cost, iters=iters,
                        lane_iters=mesh.total(lane_iters),
                        found_count=found.sum())

    return solve_batch


def ik_one(params: K.ChainParams, cfg: SolverConfig, tgt_r: torch.Tensor,
           tgt_t: torch.Tensor, x0: torch.Tensor,
           ee_r: Optional[torch.Tensor] = None,
           ee_t: Optional[torch.Tensor] = None) -> IKResult:
    """Solve one pose with cfg.total_restarts lockstep restarts on the array
    path (``lm.solve``); the result's fields are 0-d (x: (A,))."""
    seeds = restart_seeds(params, x0, cfg.rng_seed, cfg.total_restarts)
    res = lm.solve(params, seeds, tgt_r, tgt_t, options_from_config(cfg),
                   ee_r=ee_r, ee_t=ee_t, wl=cfg.linear_weight,
                   wa=cfg.angular_weight)
    out = select(cfg.solution_mode, res.x[None], res.f[None],
                 res.success[None], x0[None])
    return IKResult(found=out.found[0], x=out.x[0], cost=out.cost[0])


def ik_batch(params: K.ChainParams, cfg: SolverConfig,
             tgt_r: torch.Tensor,    # (B, 3, 3)
             tgt_t: torch.Tensor,    # (B, 3)
             x0: torch.Tensor,       # (B, A)
             ee_r: Optional[torch.Tensor] = None,
             ee_t: Optional[torch.Tensor] = None) -> IKResult:
    """Solve B poses x S = cfg.total_restarts restarts as one flat lane
    batch of B*S on the array path (``lm.solve``), then select per pose.

    Every lane runs one attempt (no reseeding): the independent oracle of
    :func:`build_batch_solver`'s SoA loop (tests/test_soa.py holds one
    against the other).  Restart seeds are pose-independent, as in the
    reference.
    """
    b, a = x0.shape
    s = cfg.total_restarts
    table = restart_seeds(params, x0[0], cfg.rng_seed, s)[1:]
    seeds = torch.cat([x0[:, None], table.expand(b, s - 1, a)], dim=1)
    res = lm.solve(params, seeds.reshape(b * s, a),
                   tgt_r.repeat_interleave(s, dim=0),
                   tgt_t.repeat_interleave(s, dim=0),
                   options_from_config(cfg), ee_r=ee_r, ee_t=ee_t,
                   wl=cfg.linear_weight, wa=cfg.angular_weight)
    out = select(cfg.solution_mode, res.x.reshape(b, s, a),
                 res.f.reshape(b, s), res.success.reshape(b, s), x0)
    return IKResult(found=out.found, x=out.x, cost=out.cost)
