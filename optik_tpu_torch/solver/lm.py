"""LM solver options and per-lane results (``optik_tpu/solver/lm.py:40-65``).

Stopping-criterion semantics mirror NLopt's as configured by the reference
(lib.rs:345-356, success classification lib.rs:376-388):
  * ``f <= tol_f``                        -> stop, success (stopval)
  * ``|df| < tol_df`` on an accepted step -> stop; success only if the user
    set tol_df >= 0 (otherwise it is the stall heuristic, lib.rs:283-293)
  * ``max|dx| < tol_dx`` on an accepted step -> stop; success only if the
    user set tol_dx >= 0 (criterion disabled when tol_dx < 0, like NLopt)

The JAX package's array-path solver (``lm.solve``) is not ported: the SoA
loop in :mod:`optik_tpu_torch.solver.lm_soa` is the port's solver.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class LMOptions(NamedTuple):
    """Static solver options."""

    max_iters: int = 64
    tol_f: float = 1e-6
    tol_df: float = 1e-9       # effective value (stall heuristic applied)
    tol_dx: float = -1.0
    df_is_success: bool = False
    dx_is_success: bool = False
    f_is_success: bool = True  # tol_f >= 0 (lib.rs:376-377)
    lam_init: float = 1e-4
    lam_min: float = 1e-14
    lam_max: float = 1e10


class LMResult(NamedTuple):
    x: torch.Tensor        # (..., A) final iterates
    f: torch.Tensor        # (...,) final costs
    success: torch.Tensor  # (...,) bool
    iters: int             # loop iterations executed
    # Restart index each lane ended on (continuous-reseed path only);
    # None when each lane ran exactly one restart.
    restart_index: Optional[torch.Tensor] = None
    # Per-lane attempt iterations at first success, 0 if never.
    succ_iters: Optional[torch.Tensor] = None
    # Per-lane iterations executed before the lane stopped (int32); only
    # with ``track_active=True``.
    active_iters: Optional[torch.Tensor] = None
