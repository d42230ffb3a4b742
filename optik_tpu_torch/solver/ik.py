"""Restart scheduling and per-pose solution selection for the batched solver.

A port of ``optik_tpu/solver/ik.py`` (the single-program path that the JAX
package runs off a TPU):

  * restart 0 starts from the caller's seed ``x0``; restart i > 0 starts
    from row i of the deterministic seed table (:mod:`optik_tpu_torch.random`,
    bit-equal to ``fold_in(key(rng_seed), i)``), independent of the pose;
  * Speed mode's winner is the lowest restart index among successes;
  * Quality mode's winner is the success nearest to the caller's seed.

Both selections are batched reductions over the (B, S) lane grid.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SolutionMode, SolverConfig
from ..ops import soa
from .. import random as rnd
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
        dist = torch.linalg.vector_norm(xs - x0[:, None, :], dim=-1)
        key = torch.where(success, dist, float("inf"))
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


def build_batch_solver(spec, cfg: SolverConfig, dtype=torch.float64,
                       device="cpu"):
    """A batched IK solver for one robot+config on the plain torch loop.

    Returns ``fn(tgt_r (B,3,3), tgt_t (B,3), x0 (B,A) [, ee_r, ee_t])
    -> IKResult``.  Every pose runs S = min(seed_batch, total_restarts)
    lanes in one lockstep loop; the rest of the restart budget is consumed
    by continuous reseeding.  ``lane_iters`` is the loop's iteration count
    times B*S (every lane runs until the slowest lane stops).
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
    if r_total > 1:
        table_np = rnd.seed_table(cfg.rng_seed, r_total, spec.lower,
                                  spec.upper, np_dtype)
    else:
        table_np = np.zeros((1, a), np_dtype)
    table = torch.tensor(table_np, dtype=dtype, device=device)
    quality = cfg.solution_mode == SolutionMode.QUALITY

    def solve_batch(tgt_r, tgt_t, x0, ee_r=None, ee_t=None) -> IKResult:
        tgt_r = as_tensor(tgt_r, dtype, device)
        tgt_t = as_tensor(tgt_t, dtype, device)
        x0 = as_tensor(x0, dtype, device)
        b = tgt_r.shape[0]
        seeds = torch.cat([x0[:, None, :],
                           table[1:s].expand(b, s - 1, a)], dim=1)
        if ee_r is not None:
            ee_r = as_tensor(ee_r, dtype, device)
            ee_t = as_tensor(ee_t, dtype, device)
        res = lm_soa.solve_soa(
            consts, lower, upper, opts, seeds,
            tgt_r[:, None], tgt_t[:, None], ee_r=ee_r, ee_t=ee_t,
            wl=cfg.linear_weight, wa=cfg.angular_weight,
            seed_table=table if use_reseed else None,
            lane_index=torch.arange(s, dtype=torch.int32, device=device)
            if use_reseed else None,
            total_restarts=r_total,
            success_stops_group=not quality,
            explore_full_budget=quality,
            quality_x0=x0[:, None],
            group_success_cap=(cfg.quality_max_successes or None)
            if quality else None)
        out = select(cfg.solution_mode, res.x, res.f, res.success, x0,
                     res.restart_index, res.succ_iters)
        return out._replace(lane_iters=torch.tensor(
            res.iters * b * s, dtype=torch.int64, device=device))

    return solve_batch
