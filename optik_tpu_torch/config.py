"""Solver configuration (a stdlib-only copy of ``optik_tpu/config.py``).

The port carries its own copy because importing ``optik_tpu`` pulls in jax.
The fields, defaults and derived properties are the same, so a config means
the same budget in both packages (pinned by tests/test_torch_models.py).

Mirrors the reference's ``SolverConfig`` (kylc/optik crates/optik/src/config.rs:22-65)
with the batch-device replacements for its wall-clock knobs:

  * ``max_time`` (reference default 0.1 s) has no deterministic meaning on a
    batch device; it is accepted for API compatibility but the actual budget
    is ``max_restarts`` total seeds x ``max_iters`` solver iterations, both
    static.  (The reference's own README sanctions this: determinism only
    holds there when time limits are disabled.)
  * the rayon thread count becomes ``seed_batch``: how many restart seeds
    advance in lockstep per round.

All fields are static (hashable) so a config keys the solver caches; arrays
never live here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class SolutionMode(enum.Enum):
    """How to pick the winner among converged restarts.

    Mirrors config.rs:3-8.  ``QUALITY`` minimizes distance to the caller's
    seed among all successes; ``SPEED`` takes the "first" success — which in
    the lockstep batched solver is the deterministic lowest restart index,
    replacing the reference's race-y cross-thread early exit.
    """

    QUALITY = 1
    SPEED = 2

    @staticmethod
    def parse(s: "str | SolutionMode") -> "SolutionMode":
        if isinstance(s, SolutionMode):
            return s
        try:
            return {"quality": SolutionMode.QUALITY,
                    "speed": SolutionMode.SPEED}[s]
        except KeyError:
            raise ValueError(f"invalid solution mode: {s!r}") from None


# Restart seeds consumed per ROUND when the caller asks for "unlimited"
# restarts (max_restarts=0).  The reference would spin threads until
# max_time expired (lib.rs:273-277); the deterministic replacement is
# rounds of this many restarts with an all-poses-converged check between
# rounds, up to ``unlimited_rounds_cap`` rounds (see Robot.ik_batch).
DEFAULT_RESTARTS = 64


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """IK solver configuration (static and hashable).

    Stopping criteria semantics follow NLopt's as used by the reference
    (lib.rs:345-356, 376-388):

      * ``tol_f``:  success when f(x) <= tol_f ("stopval").
      * ``tol_df``: lane stops when |f_{k+1} - f_k| < tol_df; counts as a
        *success* only when the user set tol_df >= 0.  When unset (< 0), the
        stall heuristic tol_df = 1e-3 * tol_f still stops the lane but the
        result is not a success (lib.rs:283-293).
      * ``tol_dx``: lane stops when every |x_{k+1,i} - x_{k,i}| < tol_dx;
        success only when the user set tol_dx >= 0.
    """

    solution_mode: SolutionMode = SolutionMode.SPEED
    # Accepted for reference API compatibility; not used as a stopping
    # criterion (see module docstring).  Setting a non-default value warns
    # once at construction: callers porting reference configs that rely on
    # a large max_time to grind hard poses should set max_restarts=0
    # (unlimited rounds) or raise max_restarts instead.
    max_time: float = 0.1
    # Total restart seeds.  0 means "unlimited": Robot.ik/ik_batch run
    # rounds of DEFAULT_RESTARTS seeds, re-solving only the unconverged
    # poses with the next slice of the deterministic restart stream, until
    # every pose converges or ``unlimited_rounds_cap`` rounds have run —
    # the deterministic analog of the reference's restart-until-max_time
    # loop (lib.rs:273-277).  Parity nuance: unlimited rounds target
    # FOUND-ness, not Quality refinement — a Quality-mode pose found in
    # round 1 keeps its best-of-DEFAULT_RESTARTS solution, whereas the
    # reference's max_time loop keeps refining every pose's best until
    # time expires; set max_restarts to a large explicit budget to widen
    # the Quality selection pool instead.  Entry points below the Robot
    # facade (ik_sharded, cascade solvers) treat 0 as a single round.
    max_restarts: int = 0
    tol_f: float = 1e-6
    tol_df: float = -1.0
    tol_dx: float = -1.0
    linear_weight: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    angular_weight: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    # --- batch-device extensions -----------------------------------------
    # Maximum Levenberg-Marquardt iterations per restart (the reference's
    # implicit budget was wall-clock time inside SLSQP).
    max_iters: int = 64
    # Seeds advanced in lockstep per round; the restart budget is consumed in
    # ceil(total_restarts / seed_batch) rounds with early exit between rounds.
    seed_batch: int = 64
    # Base RNG seed; restart i draws from fold_in(key(rng_seed), i), mirroring
    # the reference's ChaCha8 stream-per-restart scheme (lib.rs:360-362).
    rng_seed: int = 42
    # SEMANTIC EXTENSION (off by default): in Quality mode, stop a pose's
    # restart exploration once it has recorded this many *successful*
    # attempts, selecting the best (min ‖x - x0‖) among those instead of
    # among the full budget's successes.  0 preserves reference semantics
    # (lib.rs:398-408 always consumes the whole budget).  The reference has
    # no analog; this trades a bounded amount of solution quality (best-of-k
    # vs best-of-all) for early pose freezing.  Its speed on an H100 is not
    # measured (the CUDA kernel runs Speed mode only so far).
    quality_max_successes: int = 0
    # Hard cap on unlimited-restart rounds (max_restarts=0): at most
    # cap * DEFAULT_RESTARTS restarts per pose.  The reference's analog
    # bound is max_time; a deterministic machine needs a count.
    unlimited_rounds_cap: int = 16

    def __post_init__(self):
        # Note: the reference Python binding rejects (max_time=0,
        # max_restarts=0) because its solver would run forever
        # (optik-py/src/lib.rs:45-47).  Our budgets are always finite
        # (max_restarts=0 maps to DEFAULT_RESTARTS), so the combination is
        # legal here; only the mode needs validating.
        object.__setattr__(
            self, "solution_mode", SolutionMode.parse(self.solution_mode))
        if self.max_time not in (0.1, 0.0):
            import warnings

            warnings.warn(
                "SolverConfig.max_time is accepted for reference API "
                "parity but IGNORED: budgets here are deterministic "
                "(max_restarts x max_iters; max_restarts=0 runs rounds "
                "until convergence).  Raise max_restarts or use "
                "max_restarts=0 instead of a longer max_time.",
                stacklevel=2)

    @property
    def total_restarts(self) -> int:
        return self.max_restarts if self.max_restarts > 0 else DEFAULT_RESTARTS

    @property
    def effective_tol_df(self) -> float:
        """Stall heuristic: 1e-3 * tol_f when tol_df unset (lib.rs:283-293)."""
        return self.tol_df if self.tol_df > 0.0 else 1e-3 * self.tol_f

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def create(solution_mode="speed", **kw) -> "SolverConfig":
        """Keyword constructor accepting the reference's string mode names."""
        return SolverConfig(
            solution_mode=SolutionMode.parse(solution_mode), **kw)
