"""The LM solve as a hand-written Hopper kernel, and its plain torch version.

The counterpart of ``optik_tpu/ops/pallas/lm_kernel.py:build_kernel_solver``.
The kernel (``optik_tpu_torch/csrc/lm_kernel.cu``) runs the whole lockstep
projected-LM solve with one thread per lane, thread groups drawing poses
from a work queue; uncapped Quality instead runs a restart queue, each
thread drawing one (pose, restart) at a time (:func:`queued`).  It takes
the chain in one of two forms.  Up to ``MAX_DOF`` joints the chain is
folded into the code: this module writes its constants into a header
(:func:`chain_header`) and builds a library per robot.  Wider chains take the run-time-chain form: the chain is an array
(:func:`pack_runtime_chain`) and the per-lane vectors live in a scratch
buffer this module allocates, so one library per variant serves every
chain.  The module builds the kernel with ``nvcc`` at first use, binds its
plain C entry point with ``ctypes``, lays out the inputs, launches it, and
picks each pose's winner in torch, as the JAX package does outside its
Pallas kernel (``lm_kernel.py:345-377``).

Dispatch is by one predicate, :func:`kernel_runs`, decided before anything
is built: :func:`solve_lanes` sends what it accepts (CUDA, float32, at most
64 seed lanes per pose, any number of joints) to :func:`solve_kernel`,
which launches the kernel or raises, and everything else to
:func:`solve_plain` (the same function through
:func:`optik_tpu_torch.solver.lm_soa.lm_loop` in kernel math mode, on the
tensors' device): the CPU, a float64 solve (the JAX facade solves float64
through XLA, not its kernel), more seed lanes than a pose's two warps
hold.  No failure of a build or a launch turns into the plain version.

Scope: everything the Pallas kernel runs.  Speed and Quality mode (best
success by distance to the caller's seed, ``quality_max_successes`` cap),
with and without reseeding, per-axis weights, ``restart_offset`` and
``lane0_stream`` (both on the host: they only change the seed table and the
start points), a constant ``ee_offset`` folded into the chain tip, any
S = min(seed_batch, total_restarts) from 1 to 64, any DoF, float32.  One
library holds one instantiation (the robot chain for the folded form,
mode, weighted, two-warp poses, contraction) and is built when a solve
first needs it; joint limits, the tip and every option are run-time, so a
new ``ee_offset`` or config reuses the library.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...config import SolutionMode, SolverConfig
from ... import random as rnd
from ... import telemetry
from ...solver import ik as ik_mod
from ...solver import lm_soa
from .. import soa
from . import build

# Kernel launches made by launch_lanes since the last reset (set it to 0 to
# start a count).
LAUNCHES = 0

SOURCE = build.CSRC / "lm_kernel.cu"
# The widest chain folded into a library (csrc/lm_kernel.cu: kMaxDof).
# nvcc's time and the per-lane state, which spills to local memory, grow
# with the DoF (PERF.md), so wider chains take the run-time-chain form,
# which has no cap, as the Pallas kernel has none.
MAX_DOF = 32
MAX_SEED_LANES = 64
_NUM_OPTS = 19
CHAIN_HEADER = "optik_chain.h"
# The run-time chain's array (csrc/lm_kernel.cu: kRuntimeFloats,
# JointField): a head of RUNTIME_HEAD floats, JOINT_FLOATS per joint, then
# the limits.
RUNTIME_HEAD = 14
JOINT_FLOATS = 22
# The kernel addresses its scratch words in 32 bits.
_MAX_SCRATCH_WORDS = 2**31 - 1


class LaneResult(NamedTuple):
    """Per-lane solve outputs on the (B, S) lane grid."""

    x: torch.Tensor              # (B, S, A)
    f: torch.Tensor              # (B, S)
    success: torch.Tensor        # (B, S) bool
    restart_index: torch.Tensor  # (B, S) int32, local to the call (0..R-1)
    succ_iters: torch.Tensor     # (B, S) int32
    # 0-d int64.  From the kernel: the sum over poses of the iterations the
    # pose's group ran, times S (on the restart queue, the iterations the
    # restarts ran).  From the plain version: the lockstep loop's count
    # times B * S.
    lane_iters: torch.Tensor
    # (B, S) int32 iterations each lane ran before it stopped; only from
    # solve_plain(track_active=True).
    active_iters: Optional[torch.Tensor] = None
    # Only from the kernel, per launched warp: its loop trips ((warps,)
    # int32; :func:`exec_slots` sums them) and the %globaltimer nanoseconds
    # of its start, its last draw from the pose queue and its exit
    # ((warps, 3) int64; :func:`schedule_profile` reads them).
    warp_trips: Optional[torch.Tensor] = None
    warp_times: Optional[torch.Tensor] = None
    # Only from the kernel, per pose and warp of its group ((B, 1) or, for a
    # pose on a pair of warps, (B, 2) int32): the iterations the warp ran on
    # the pose times S, and, from the Quality build while telemetry
    # records, the iterations the warp's lanes spent inside an attempt,
    # summed (None otherwise).  From the restart queue (Quality, no cap)
    # both are the one (B, 1) count of the iterations the pose's restarts
    # ran (lane_busy only while telemetry records).
    pose_iters: Optional[torch.Tensor] = None
    lane_busy: Optional[torch.Tensor] = None
    # Only from the restart queue, per launched warp ((warps, 2) int32): the
    # restarts it drew, and the draws whose pose differs from the lane's
    # previous one (None from the pose groups).
    draws: Optional[torch.Tensor] = None


def chain_header(consts) -> str:
    """The text of ``optik_chain.h`` for one chain: the joints' constants
    the kernel folds at compile time.

    Per joint the origin rotation (row-major), the origin translation, the
    axis and whether it is prismatic, each value the exact double of the
    plain version's Python float (a C++17 hexadecimal literal), plus the
    DoF and whether the chain has a tip.  The tip's values, the joint
    limits and every solver option are run-time and not in here, so two
    ``ee_offset``s or configs of one robot share a header, hence a library.
    Each joint's comment counts its constants that are a static 0, +1 or
    -1: the terms ``soa.smul`` / ``sadd`` / ``ssub`` fold away.
    """
    org_r, org_t, axes, pris, _, _, has_tip = consts
    a = len(axes)

    def row(values):
        values = [float(v) for v in values]
        if not all(np.isfinite(values)):
            raise ValueError("a chain constant is not finite")
        return "{" + ", ".join(v.hex() for v in values) + "}"

    def table(name, width, rows):
        body = ",\n".join("      " + row(r) for r in rows)
        return (f"__host__ __device__ constexpr double {name}(int j, int i) "
                f"{{\n  constexpr double v[kDof][{width}] = {{\n{body}}};\n"
                "  return v[j][i];\n}\n")

    flat_r = [[v for r in org_r[j] for v in r] for j in range(a)]
    lines = [
        "// Joint constants of one serial chain for "
        "optik_tpu_torch/csrc/lm_kernel.cu,",
        "// written by optik_tpu_torch/ops/cuda/lm_kernel.py:chain_header.",
        "#pragma once",
        "namespace optik_chain {",
        f"constexpr int kDof = {a};",
        f"constexpr bool kHasTip = {'true' if has_tip else 'false'};"]
    for j in range(a):
        vals = flat_r[j] + list(org_t[j]) + list(axes[j])
        lines.append(f"// joint {j}: static 0 / +1 / -1 constants: "
                     f"{sum(v == 0.0 for v in vals)} / "
                     f"{sum(v == 1.0 for v in vals)} / "
                     f"{sum(v == -1.0 for v in vals)} of {len(vals)}")
    lines += [
        table("org_r", 9, flat_r), table("org_t", 3, org_t),
        table("axis", 3, axes),
        "__host__ __device__ constexpr bool prismatic(int j) {\n"
        "  constexpr bool v[kDof] = {"
        + ", ".join("true" if p else "false" for p in pris)
        + "};\n  return v[j];\n}",
        "}  // namespace optik_chain", ""]
    return "\n".join(lines)


_HEADERS = {}


def _header_of(spec, consts) -> str:
    """:func:`chain_header` of ``consts``, formatted once per chain (a
    plan is built per config, and the text is a quarter of a millisecond)."""
    key = (spec.origin_r.tobytes(), spec.origin_t.tobytes(),
           spec.axis.tobytes(), spec.prismatic.tobytes(), consts[6])
    if key not in _HEADERS:
        _HEADERS[key] = chain_header(consts)
    return _HEADERS[key]


def library_flags(header: Optional[str], quality: bool, weighted: bool,
                  wide: bool):
    """The ``-D`` flags of one instantiation (``header`` None: the run-time
    chain)."""
    flags = (f"-DOPTIK_QUALITY={int(quality)}",
             f"-DOPTIK_WEIGHTED={int(weighted)}",
             f"-DOPTIK_WIDE={int(wide)}")
    return flags if header is not None else flags + ("-DOPTIK_RUNTIME_CHAIN=1",)


@functools.lru_cache(maxsize=None)
def _load_library(header: Optional[str], quality: bool, weighted: bool,
                  wide: bool, fmad: bool):
    flags = library_flags(header, quality, weighted, wide)
    lib, info = build.build_library(
        SOURCE, flags, fmad,
        headers={} if header is None else {CHAIN_HEADER: header})
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # chain, chain_len, opts; n_opts .. freeze; seeds .. times, dev_chain,
    # scratch; scratch_words;
    # rows, rows_words, draw_counts; stream.
    lib.optik_lm_solve.argtypes = ([vp, ci, vp] + [ci] * 7 + [vp] * 16
                                   + [ctypes.c_longlong, vp,
                                      ctypes.c_longlong, vp, vp])
    lib.optik_lm_solve.restype = ci
    lib.optik_lm_error_string.argtypes = [ci]
    lib.optik_lm_error_string.restype = ctypes.c_char_p
    lib.optik_lm_grid.argtypes = [ci, ci]
    lib.optik_lm_grid.restype = ci
    lib.optik_lm_scratch_words.argtypes = [ci, ci, ci]
    lib.optik_lm_scratch_words.restype = ctypes.c_longlong
    lib.optik_lm_globaltimer.argtypes = [vp, vp]
    lib.optik_lm_globaltimer.restype = ci
    lib.optik_lm_record_words.argtypes = [ci]
    lib.optik_lm_record_words.restype = ci
    for name in ("optik_lm_block_threads", "optik_lm_runtime_floats",
                 "optik_lm_num_opts", "optik_lm_variant",
                 "optik_lm_blocks_per_sm", "optik_lm_joint_floats"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    want = int(quality) << 8 | int(weighted) << 9 | int(wide) << 10
    if header is None:
        layout = (RUNTIME_HEAD, JOINT_FLOATS)
        want |= 1 << 12
    else:
        dof = int(header.split("kDof = ")[1].split(";")[0])
        layout = (13 + 2 * dof, 0)
        want |= dof | int("kHasTip = true" in header) << 11
    if ((lib.optik_lm_runtime_floats(), lib.optik_lm_joint_floats())
            != layout or lib.optik_lm_num_opts() != _NUM_OPTS
            or lib.optik_lm_record_words(7) != record_words(7)
            or lib.optik_lm_variant() != want):
        raise RuntimeError(f"{info.path} does not match this wrapper's "
                           "layout or the requested instantiation")
    return lib, info


def load_library(header: Optional[str], quality: bool = False,
                 weighted: bool = False, wide: bool = False,
                 fmad: bool = True):
    """Build one instantiation of the kernel at first use and load it:
    ``(CDLL, build.BuildInfo)``.

    ``header`` is the folded chain's (:func:`chain_header`), or None for
    the run-time-chain form, whose one library serves every chain.
    ``quality`` compiles the Quality-mode loop (best tracking, success
    cap), ``weighted`` the per-axis objective weights, ``wide`` the exchange
    between the two warps of a 33..64-lane pose that Speed freeze and the
    Quality cap need.  ``fmad=False`` builds without multiply-add
    contraction: that build is bitwise equal to :func:`solve_plain` on the
    card (the parity check of chip_smoke.py and tests/test_torch_cuda.py;
    for the run-time chain where the plain version folds no constants of
    two joints together, ``csrc/lm_kernel.cu``).  The solver itself uses the
    contracted build.
    """
    return _load_library(header, bool(quality), bool(weighted), bool(wide),
                         bool(fmad))


def library_report(lib, info) -> dict:
    """Registers, spills, block size and resident warps per SM of a loaded
    LM library on the current device, and its nvcc seconds."""
    use = build.ptxas_usage(info.ptxas, "lm_solve_kernel")
    block = lib.optik_lm_block_threads()
    per_sm = lib.optik_lm_blocks_per_sm()
    return {"registers": use["registers"], "stack": use["stack"],
            "spill_bytes": use["spill_stores"] + use["spill_loads"],
            "block_threads": block, "blocks_per_sm": per_sm,
            "warps_per_sm": per_sm * block // 32, "nvcc_s": info.seconds,
            "path": str(info.path)}


def fold_ee_offset(consts, ee_offset):
    """Compose a constant EE offset into the chain's tip (``T' = T @ E``).

    ``ee_offset`` is a 4x4 matrix or an ``(R (3,3), t (3,))`` pair; the
    fold is done on the host in float64 (``lm_kernel.py:65-87``).
    """
    org_r, org_t, axes, pris, tip_r, tip_t, has_tip = consts
    if isinstance(ee_offset, tuple):
        er = np.asarray(ee_offset[0], np.float64)
        et = np.asarray(ee_offset[1], np.float64)
    else:
        m = np.asarray(ee_offset, np.float64)
        er, et = m[:3, :3], m[:3, 3]
    tr = np.asarray(tip_r, np.float64)
    tt = np.asarray(tip_t, np.float64)
    new_r = tr @ er
    new_t = tt + tr @ et
    new_tip_r = [[float(new_r[i, k]) for k in range(3)] for i in range(3)]
    new_tip_t = [float(new_t[i]) for i in range(3)]
    has = not (np.allclose(new_r, np.eye(3)) and np.allclose(new_t, 0.0))
    return org_r, org_t, axes, pris, new_tip_r, new_tip_t, has


def pack_chain(consts, lower, upper) -> np.ndarray:
    """What of the chain the kernel reads at run time, as its flat float32
    array: tip_r (9), tip_t (3), has_tip (1), lower (A), upper (A).  The
    joints' constants are compile-time (:func:`chain_header`)."""
    _, _, axes, _, tip_r, tip_t, has_tip = consts
    out = np.concatenate([np.ravel(tip_r), tip_t, [float(has_tip)], lower,
                          upper]).astype(np.float32)
    assert out.size == 13 + 2 * len(axes)
    return out


def pack_runtime_chain(consts, lower, upper,
                       dtype=np.float32) -> np.ndarray:
    """The chain as the run-time-chain kernel reads it: one flat array.

    A head of ``RUNTIME_HEAD``: tip_r (9), tip_t (3), has_tip (1), DoF (1).
    Then per joint ``JOINT_FLOATS``: the origin rotation (9, row-major),
    translation (3) and axis (3); its kind (bit 0 prismatic; bit 1 + i set
    where the axis lies in the plane of the other two components, so that
    Rodrigues' diagonal entry i is ``cos q``); and the products of two
    constants that ``soa.rodrigues`` forms before they meet a lane, each
    computed in double as the plain version does and rounded once:
    ``-(ky^2 + kz^2)``, ``-(kx^2 + kz^2)``, ``-(kx^2 + ky^2)``, then
    ``kx ky``, ``kx kz``, ``ky kz``.  Then lower (A), upper (A).
    ``dtype`` float64 keeps every constant exact (for a walk at f64).
    """
    org_r, org_t, axes, pris, tip_r, tip_t, has_tip = consts
    a = len(axes)
    rows = []
    for j in range(a):
        kx, ky, kz = axes[j]
        kk = (ky * ky + kz * kz, kx * kx + kz * kz, kx * kx + ky * ky)
        kind = int(pris[j]) | sum(1 << (1 + i) for i in range(3)
                                  if kk[i] == 1.0)
        rows.append([v for r in org_r[j] for v in r] + list(org_t[j])
                    + [kx, ky, kz, float(kind), -kk[0], -kk[1], -kk[2],
                       kx * ky, kx * kz, ky * kz])
    head = [v for r in tip_r for v in r] + list(tip_t) + [float(has_tip), a]
    out = np.concatenate([np.asarray(head, np.float64),
                          np.asarray(rows, np.float64).ravel(),
                          np.asarray(lower, np.float64),
                          np.asarray(upper, np.float64)]).astype(dtype)
    assert out.size == RUNTIME_HEAD + (JOINT_FLOATS + 2) * a
    return out


def lane_scratch_bytes(plan: "KernelPlan", lib) -> int:
    """Scratch bytes one lane of ``lib`` (the plan's library) holds for the
    plan's chain, by the library's own count: 0 for the folded chain,
    whose vectors are registers."""
    threads = lib.optik_lm_grid(1, plan.s_pad) * lib.optik_lm_block_threads()
    return 4 * lib.optik_lm_scratch_words(1, plan.s_pad, plan.a) // threads


def padded_lanes(s: int) -> int:
    """Threads a pose's ``s`` lanes occupy: the next divisor of 32, or 64."""
    for cand in (1, 2, 4, 8, 16, 32, 64):
        if s <= cand:
            return cand
    raise NotImplementedError(
        f"seed lanes S={s} > {MAX_SEED_LANES}: the CUDA kernel holds a pose "
        "in at most two warps (Robot.ik_batch runs such configs on the plain "
        "loop, as the JAX facade leaves its kernel for XLA there)")


def fp32_ops_per_lane_iter(plan: "KernelPlan", samples: int = 64) -> int:
    """FP32 operations one lane-iteration of the LM loop needs on the plan's
    chain with identity weights: the numerator of the roofline bound.

    It counts what the function needs, not what ``csrc/lm_kernel.cu``
    executes.  The fused residual and task Jacobian (FK, target-frame error,
    SE(3) log, right-Jacobian blocks, Jacobian columns) is traced on the
    chain's constants by :mod:`optik_tpu_torch.ops.opcount`: the chain's
    static 0 / +-1 terms are folded, only the selected side of each select
    is counted and a repeated subexpression once.  Which side is selected
    (the atan range reduction, the small-angle series) depends on the point,
    so the trace runs at ``samples`` random configurations and targets
    (numpy seed 0) and the least count is kept: the bound stays a lower
    bound.  The dense algebra around it is counted by hand from the loop
    body (an add, subtract, multiply, divide, sqrt, rsqrt or floor is 1, a
    fused multiply-add 2; compares, selects, abs and negations 0), with J
    taken as dense: ``J J^T + lam I`` ``21 (2a - 1) + 6``, the 6x6 Cholesky
    solve 163, the projected step ``13 a``, the cost 11, the Nielsen gain
    ratio ``6 (2a - 1) + 31``, the damping update 1 and the cost-change
    stopping test 1.
    """
    from .. import opcount

    a = plan.a
    rng = np.random.default_rng(0)
    lo = np.asarray(plan.spec.lower, np.float64)
    hi = np.asarray(plan.spec.upper, np.float64)
    traced = None
    for _ in range(samples):
        trace = opcount.Trace()

        def leaves(name, values):
            return [trace.leaf(f"{name}{i}", float(v))
                    for i, v in enumerate(values)]

        # A reachable target: FK of a second configuration, by value.
        _, r_t, t_t = soa.fk_joints(
            plan.consts, leaves("qt", rng.uniform(lo, hi)), approx=True)
        tgt_r = [leaves(f"r{i}", [opcount._val(v) for v in row])
                 for i, row in enumerate(r_t)]
        tgt_t = leaves("t", [opcount._val(v) for v in t_t])
        e, jt = soa.residual_and_jtask(
            plan.consts, leaves("q", rng.uniform(lo, hi)), tgt_r, tgt_t,
            approx=True)
        n = trace.cost(e + [v for row in jt for v in row])
        traced = n if traced is None else min(traced, n)
    dense = (21 * (2 * a - 1) + 6) + 163 + 13 * a + 11 \
        + (6 * (2 * a - 1) + 31) + 1 + 1
    return traced + dense


def check_supported(spec) -> None:
    """Raise for a chain the CUDA kernel does not take: one without joints
    (more seed lanes than it holds raise in :func:`padded_lanes`, when a
    plan is made)."""
    if spec.num_positions < 1:
        raise ValueError(
            f"the CUDA kernel needs at least one joint, got "
            f"{spec.num_positions}")


def kernel_runs(spec, cfg: SolverConfig, dtype: torch.dtype,
                device: "str | torch.device") -> bool:
    """Whether a solve of ``spec`` under ``cfg`` at ``dtype`` on ``device``
    runs the CUDA kernel: a CUDA device, float32, at most
    ``MAX_SEED_LANES`` seed lanes per pose and at least one joint (up to
    ``MAX_DOF`` the folded chain, above it the run-time chain).

    The one routing rule of the LM solve (:func:`solve_lanes`,
    ``Robot.ik_batch``, the seed-sharded solver): what it refuses runs the
    plain loop on the same device, as the JAX facade leaves its kernel
    for XLA (``optik_tpu/robot.py:90-157``).  It is decided from the
    config before anything is built.
    """
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and min(cfg.seed_batch, cfg.total_restarts) <= MAX_SEED_LANES
            and spec.num_positions >= 1)


class KernelPlan:
    """Everything one (robot, config, ee_offset) solve needs, built once.

    Holds the folded chain constants, the kernel's chain in its form (up to
    ``MAX_DOF`` joints the header of compile-time joints and the run-time
    array of tip and limits; above it, or with ``runtime_chain=True``, the
    run-time chain's array, uploaded once per device), the LM options, the
    mode, weights and success cap, and the restart seed tables: one per
    ``restart_offset``, made on the host and uploaded once per device; the
    kernel and :func:`solve_plain` read the same copy.
    """

    def __init__(self, spec, cfg: SolverConfig, ee_offset=None,
                 runtime_chain: Optional[bool] = None):
        self.s_pad = padded_lanes(min(cfg.seed_batch, cfg.total_restarts))
        self.cfg = cfg
        self.spec = spec
        consts = soa.chain_constants(spec)
        if ee_offset is not None:
            consts = fold_ee_offset(consts, ee_offset)
        self.consts = consts
        self.a = spec.num_positions
        self.lower, self.upper = ik_mod.chain_bounds(spec)
        self.opts = ik_mod.options_from_config(cfg)
        self.r_total = cfg.total_restarts
        self.s = min(cfg.seed_batch, self.r_total)
        self.reseed = self.r_total > self.s
        self.quality = cfg.solution_mode == SolutionMode.QUALITY
        # Speed freezes a pose at its first success; Quality never does.
        self.freeze = not self.quality
        self.cap = cfg.quality_max_successes if self.quality else 0
        self.lin_id = soa.weights_are_identity(cfg.linear_weight)
        self.ang_id = soa.weights_are_identity(cfg.angular_weight)
        self.weighted = not (self.lin_id and self.ang_id)
        if runtime_chain is None:
            runtime_chain = self.a > MAX_DOF
        elif not runtime_chain and self.a > MAX_DOF:
            raise ValueError(f"a folded chain has at most {MAX_DOF} joints, "
                             f"got {self.a}")
        self.runtime_chain = bool(runtime_chain)
        if self.runtime_chain:
            self.header = None
            self.chain = pack_runtime_chain(consts, self.lower, self.upper)
        else:
            self.header = _header_of(spec, consts)
            self.chain = pack_chain(consts, self.lower, self.upper)
        self._chains = {}
        o = self.opts
        self.opt_array = np.array(
            [o.max_iters, o.tol_f, o.tol_df, o.tol_dx, o.f_is_success,
             o.df_is_success, o.dx_is_success, o.lam_init, o.lam_min,
             o.lam_max, *cfg.linear_weight, *cfg.angular_weight,
             self.lin_id, self.ang_id, self.cap], np.float32)
        assert self.opt_array.size == _NUM_OPTS
        self._tables = {}

    def wide(self, freeze: bool) -> bool:
        """Whether a launch needs the two-warp exchange instantiation."""
        return self.s_pad == 64 and (self.cap > 0 if self.quality else freeze)

    def library(self, freeze: bool, fmad: bool = True):
        """The kernel library a launch of this plan uses:
        ``(CDLL, build.BuildInfo)``, built at first use: the chain's own
        folded library, or the run-time chain's, one per variant.  Raises
        for a chain the kernel does not take (:func:`check_supported`)."""
        check_supported(self.spec)
        return load_library(self.header, self.quality, self.weighted,
                            self.wide(freeze), fmad)

    def library_path(self, freeze: bool, fmad: bool = True):
        """The file :meth:`library` loads (nothing is built): one per
        robot for the folded chain, one per variant for the run-time
        chain."""
        flags = library_flags(self.header, self.quality, self.weighted,
                              self.wide(freeze))
        return build.library_path(
            SOURCE, flags, fmad,
            {} if self.header is None else {CHAIN_HEADER: self.header})

    def device_chain(self, device: torch.device) -> torch.Tensor:
        """The run-time chain's array on ``device`` (uploaded once)."""
        t = self._chains.get(device)
        if t is None:
            t = torch.tensor(self.chain, device=device)
            self._chains[device] = t
        return t

    def table(self, device: torch.device, off: int = 0,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The (R, A) seed table on ``device``: row i is the draw for
        restart index ``i + off`` (made and uploaded once per ``off``).
        The kernel reads float32; a float64 plain solve draws at float64,
        as the JAX kernel and the port's plain loop draw at their dtype."""
        key = (device, int(off), dtype)
        t = self._tables.get(key)
        if t is None:
            np_dtype = np.float64 if dtype == torch.float64 else np.float32
            host = rnd.seed_table(self.cfg.rng_seed, self.r_total,
                                  self.spec.lower, self.spec.upper,
                                  np_dtype, off=int(off))
            t = torch.tensor(host, dtype=dtype, device=device)
            self._tables[key] = t
        return t

    def seeds(self, x0: torch.Tensor, off: int = 0,
              lane0_stream: bool = False) -> torch.Tensor:
        """(B, S, A) start points: lane 0 = x0 (or table row 0 with
        ``lane0_stream``), lanes s > 0 = table[s]."""
        b = x0.shape[0]
        tab = self.table(x0.device, off, x0.dtype)
        if lane0_stream:
            return tab[:self.s].expand(b, self.s, self.a)
        return torch.cat([x0[:, None, :],
                          tab[1:self.s].expand(b, self.s - 1, self.a)], dim=1)


def _check_inputs(tgt_r, tgt_t, x0, a):
    b = tgt_r.shape[0]
    if (tgt_r.shape != (b, 3, 3) or tgt_t.shape != (b, 3)
            or x0.shape != (b, a)):
        raise ValueError(
            f"expected tgt_r (B,3,3), tgt_t (B,3), x0 (B,{a}); got "
            f"{tuple(tgt_r.shape)}, {tuple(tgt_t.shape)}, {tuple(x0.shape)}")
    if not (tgt_r.device == tgt_t.device == x0.device):
        raise ValueError("tgt_r, tgt_t and x0 must be on one device")
    if b == 0:
        raise ValueError("empty batch")


def _check_cuda_f32(**tensors) -> torch.device:
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"the CUDA kernel needs CUDA tensors on one "
                             f"device; {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is "
                            f"{t.dtype}")
    return device


def pack_targets(tgt_r: torch.Tensor, tgt_t: torch.Tensor) -> torch.Tensor:
    """(B,3,3), (B,3) -> the kernel's (12, B) component-major targets."""
    b = tgt_r.shape[0]
    return torch.cat([tgt_r.reshape(b, 9).T, tgt_t.T], dim=0).contiguous()


def record_words(a: int) -> int:
    """The restart queue's pose record in floats (``csrc/lm_kernel.cu``:
    record_words): 12 + A rounded up to a multiple of 4."""
    return (12 + a + 3) // 4 * 4


def pack_records(tgt_r: torch.Tensor, tgt_t: torch.Tensor,
                 x0: torch.Tensor) -> torch.Tensor:
    """(B,3,3), (B,3), (B,A) -> the restart queue's (B, W) pose records:
    the target's rotation (row-major) and translation, the caller's seed,
    zeros to :func:`record_words`, one row a pose."""
    b, a = x0.shape
    pad = x0.new_zeros(b, record_words(a) - 12 - a)
    return torch.cat([tgt_r.reshape(b, 9), tgt_t, x0, pad], dim=1)


def queued(plan: KernelPlan) -> bool:
    """Whether the plan's launches run the restart queue: Quality with no
    success cap, whose restarts are independent, so each lane draws
    (pose, restart) items on its own (``csrc/lm_kernel.cu``).  A cap
    counts successes in lockstep order, so capped Quality and Speed keep
    the pose groups."""
    return plan.quality and plan.cap == 0


def lane_busy_words(plan: KernelPlan, b: int) -> int:
    """The schedule probe's words for the lanes' busy iterations of a
    launch over ``b`` poses: one per pose and warp of its group from the
    Quality build while telemetry records, else 0 (off, the probe is what
    it always was; on the restart queue they are ``pose_iters``)."""
    if not (plan.quality and telemetry.enabled()) or queued(plan):
        return 0
    return b * (2 if plan.s_pad == 64 else 1)


def launch_lanes(plan: KernelPlan, seeds: torch.Tensor, tgt: torch.Tensor,
                 table: Optional[torch.Tensor] = None,
                 qx0: Optional[torch.Tensor] = None, *, reseed: bool,
                 freeze: bool, fmad: bool = True) -> LaneResult:
    """The low-level launch on explicit start points.

    ``seeds`` is (A, L) with lane l = pose * S + s, ``tgt`` (12, B),
    ``table`` (R, A) (read only when ``reseed``), ``qx0`` (A, B) the
    caller's seeds (read only in Quality mode with ``reseed``); all float32
    CUDA tensors.  On the restart queue (:func:`queued`) ``seeds`` is
    (L, A), ``tgt`` the (B, W) pose records of :func:`pack_records`, which
    hold the caller's seeds, and ``qx0`` is not taken.  ``freeze`` turns
    the Speed-mode group stop on.  Launches on the current stream and does
    not synchronise.

    ``lane_iters`` is the work the poses took: the sum over poses of the
    iterations the pose's group ran (until its last lane stopped), times S.
    It does not depend on how the queue packed poses into warps, and is
    the one reduction a launch pays (two for a pose across two warps); the
    schedule probe (``warp_trips``, ``warp_times``, ``pose_iters``) comes
    back as the kernel wrote it, for :func:`exec_slots` and
    :func:`schedule_profile` to reduce when someone asks; while telemetry
    records, the Quality build also writes ``lane_busy`` (in the probe's
    one allocation, which is that much longer), and :func:`probe_row`
    reduces the probe on the card into the telemetry's counters.

    Uncapped Quality (:func:`queued`) runs the restart queue: one thread
    an item of B * R (pose, restart) items, each restart's row in a
    (A + 4, B * R) float32 buffer of this launch, and a second kernel that
    picks the same lane outputs from the rows.  There ``lane_iters`` is
    the iterations the restarts ran, and ``draws`` comes back too.
    """
    global LAUNCHES
    a, s = plan.a, plan.s
    on_queue = queued(plan)
    tensors = {"seeds": seeds, "tgt": tgt}
    if reseed:
        if table is None:
            raise ValueError("reseeding needs the seed table")
        tensors["table"] = table
        if plan.quality and not on_queue:
            if qx0 is None:
                raise ValueError("Quality mode with reseeding needs qx0")
            tensors["qx0"] = qx0
    device = _check_cuda_f32(**tensors)
    b = tgt.shape[0] if on_queue else tgt.shape[1]
    n_lanes = b * s
    want = ((n_lanes, a), (b, record_words(a))) if on_queue \
        else ((a, n_lanes), (12, b))
    if (seeds.shape, tgt.shape) != want:
        raise ValueError(f"expected seeds {want[0]} and tgt {want[1]}; "
                         f"got {tuple(seeds.shape)}, {tuple(tgt.shape)}")
    if reseed and (table.shape != (plan.r_total, a)
                   or (plan.quality and not on_queue
                       and qx0.shape != (a, b))):
        raise ValueError("seed table must be (R, A) and qx0 (A, B)")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if plan.quality and freeze:
        raise ValueError("the group freeze is Speed mode's")
    lib, _ = plan.library(freeze, fmad)
    r_launch = plan.r_total if reseed else s
    halves = 2 if plan.s_pad == 64 and not on_queue else 1
    busy_words = lane_busy_words(plan, b)
    # The grid: a pose group a pose, or a thread a restart-queue item.
    units, pad = (b * r_launch, 1) if on_queue else (b, plan.s_pad)
    n_warps = lib.optik_lm_grid(units, pad) \
        * lib.optik_lm_block_threads() // 32
    if n_warps < 1:
        raise RuntimeError("the occupancy query of the LM kernel failed")
    words = lib.optik_lm_scratch_words(units, pad, a)
    if not 0 <= words <= _MAX_SCRATCH_WORDS:
        raise ValueError(
            f"the run-time-chain kernel's scratch for {a} joints is "
            f"{words} floats at B={b}: more than its 32-bit addressing "
            f"({_MAX_SCRATCH_WORDS})")
    with torch.cuda.device(device), telemetry.span("optik.lm.launch"):
        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)

        # The run-time chain's per-lane vectors (torch raises where the
        # card has no room for them); the folded chain needs none.
        scratch = empty(words, torch.float32) if words else None
        dev_chain = plan.device_chain(device) if plan.runtime_chain \
            else None

        x_out = empty((a, n_lanes), torch.float32)
        f_out = empty(n_lanes, torch.float32)
        succ = empty(n_lanes, torch.int8)
        ridx = empty(n_lanes, torch.int32)
        sit = empty(n_lanes, torch.int32)
        # The restart queue's rows (torch raises where the card has no room
        # for them).
        rows = empty((a + 4) * b * r_launch, torch.float32) if on_queue \
            else None
        # The queue's counter and the schedule probe, one allocation: times
        # (int64, so first), trips, the restart queue's draws, pose
        # iterations, lanes' busy iterations (Quality, telemetry on),
        # counter.
        n_draw = 2 * n_warps if on_queue else 0
        probe = empty(7 * n_warps + n_draw + b * halves + busy_words + 1,
                      torch.int32)
        times = probe[:6 * n_warps].view(torch.int64).view(n_warps, 3)
        trips = probe[6 * n_warps:7 * n_warps]
        at = 7 * n_warps + n_draw
        draws = probe[7 * n_warps:at].view(n_warps, 2) if on_queue else None
        pose_iters = probe[at:at + b * halves].view(b, halves)
        busy = probe[at + b * halves:-1].view(b, halves) \
            if busy_words else None
        queue = probe[-1:]
        stream = torch.cuda.current_stream(device).cuda_stream
        use_qx0 = reseed and plan.quality and not on_queue
        rc = lib.optik_lm_solve(
            plan.chain.ctypes.data, plan.chain.size,
            plan.opt_array.ctypes.data, plan.opt_array.size, b, s,
            plan.s_pad, plan.r_total if reseed else s, int(reseed),
            int(freeze), seeds.data_ptr(), tgt.data_ptr(),
            table.data_ptr() if reseed else None,
            qx0.data_ptr() if use_qx0 else None, x_out.data_ptr(),
            f_out.data_ptr(), succ.data_ptr(), ridx.data_ptr(),
            sit.data_ptr(), queue.data_ptr(), pose_iters.data_ptr(),
            None if busy is None else busy.data_ptr(),
            trips.data_ptr(), times.data_ptr(),
            None if dev_chain is None else dev_chain.data_ptr(),
            None if scratch is None else scratch.data_ptr(), words,
            None if rows is None else rows.data_ptr(),
            0 if rows is None else rows.numel(),
            None if draws is None else draws.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                "optik_lm_solve failed: "
                + lib.optik_lm_error_string(rc).decode())
        LAUNCHES += 1
        telemetry.count("lm.launches")
        # A pose across two warps ran until the later of the two was through.
        group_iters = pose_iters.amax(dim=1) if halves == 2 else pose_iters
        lane_iters = group_iters.sum(dtype=torch.int64)
        if on_queue and telemetry.enabled():
            busy = pose_iters
    lanes = LaneResult(
        x=x_out.reshape(a, b, s).permute(1, 2, 0),
        f=f_out.reshape(b, s), success=succ.reshape(b, s).bool(),
        restart_index=ridx.reshape(b, s), succ_iters=sit.reshape(b, s),
        lane_iters=lane_iters, warp_trips=trips, warp_times=times,
        pose_iters=pose_iters, lane_busy=busy, draws=draws)
    row = telemetry.launch_row(device, lib)
    if row is not None:
        probe_row(lanes, out=row)
    return lanes


def pick_plain(rows: torch.Tensor, a: int, b: int, s: int, r: int,
               reseed: bool) -> LaneResult:
    """The restart queue's pick (``csrc/lm_kernel.cu``:
    ``lm_solve_pick_kernel``) as plain torch, on any device.

    ``rows`` is the (A + 4, B * R) float32 buffer the queue writes, item
    q = pose * R + r: x (A), f, the distance to the caller's seed of a
    success (inf otherwise), and as int32 bits the success iteration (0:
    none) and the iterations the attempt ran.  Slot s of a pose takes the
    restarts r = s, s + S, ..., as a pose group's lane s runs them: with
    reseeding, x, f and the index of the nearest success (NaN never wins, a
    tie goes to the lower r), success where there is one, x 0, f inf and
    index 0 where there is none; without, its one restart as it ended.
    ``succ_iters`` is the lowest successful r's success iteration.
    ``lane_iters`` is the rows' iterations summed, ``pose_iters`` (B, 1) per
    pose."""
    rounds = -(-r // s)
    pad = rounds * s - r

    def per_slot(t, fill):
        """(B, R) -> (B, S, rounds): restart s + k S at [:, s, k]."""
        t = torch.cat([t, t.new_full((b, pad), fill)], dim=1)
        return t.view(b, rounds, s).transpose(1, 2)

    x = rows[:a].reshape(a, b, r)
    f = rows[a].reshape(b, r)
    d = rows[a + 1].reshape(b, r)
    sit = rows[a + 2].view(torch.int32).reshape(b, r)
    iters = rows[a + 3].view(torch.int32).reshape(b, r)
    slot = torch.arange(s, device=rows.device)
    hit = per_slot(sit, 0) > 0
    first = hit.to(torch.int8).argmax(dim=2, keepdim=True)
    succ_iters = torch.where(hit.any(dim=2),
                             per_slot(sit, 0).gather(2, first)[..., 0],
                             0).to(torch.int32)
    if reseed:
        ds = per_slot(d, float("inf"))
        ds = torch.where(torch.isnan(ds), float("inf"), ds)
        near, k = ds.min(dim=2)
        success = near < float("inf")
        pick = k * s + slot
    else:
        success = hit[..., 0]
        pick = slot.expand(b, s)
    take = success if reseed else torch.ones_like(success)
    pose = torch.arange(b, device=rows.device)[:, None]
    xs = x.permute(1, 2, 0)[pose, pick]
    x_out = torch.where(take[..., None], xs, torch.zeros_like(xs))
    f_out = torch.where(take, f[pose, pick], float("inf"))
    ridx = torch.where(take, pick, 0).to(torch.int32)
    per_pose = iters.sum(dim=1, dtype=torch.int64)
    return LaneResult(x=x_out, f=f_out, success=success, restart_index=ridx,
                      succ_iters=succ_iters, lane_iters=per_pose.sum(),
                      pose_iters=per_pose[:, None].to(torch.int32))


def pose_lane_iters(active_iters: torch.Tensor) -> torch.Tensor:
    """The kernel's ``lane_iters`` from the plain loop's ``track_active``
    probe: a pose's group runs until its last lane stops, so the sum over
    poses of the largest lane count, times S (0-d int64)."""
    s = active_iters.shape[1]
    return active_iters.amax(dim=1).sum(dtype=torch.int64) * s


def probe_row(lanes: LaneResult,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch's schedule probe reduced on its device, without a sync:
    (``telemetry.PROBE_WIDTH``,) int64 of the lane-iterations the pose
    groups ran (``lane_iters``), the warps' loop trips, the first warp
    start, the last draw from the pose queue and the last warp exit
    (``%globaltimer`` ns),
    the warp slots a pair's earlier warp waited for the later one (32 per
    iteration between them, summed over the poses on a pair of warps),
    the lanes' busy iterations (``lane_busy`` summed; 0 without it) and
    the restart queue's draws and pose switches (``draws`` summed; 0 from
    the pose groups), written into ``out`` where given (seven small
    launches, four more for poses on pairs of warps).  Rows of several
    launches add up to a row :func:`probe_counts` and :func:`draw_counts`
    read alike."""
    t = lanes.warp_times
    if out is None:
        out = torch.empty(telemetry.PROBE_WIDTH, dtype=torch.int64,
                          device=t.device)
    out[0].copy_(lanes.lane_iters)
    torch.sum(lanes.warp_trips, dim=0, dtype=torch.int64, out=out[1])
    torch.amin(t[:, 0], dim=0, out=out[2])
    torch.amax(t[:, 1:], dim=0, out=out[3:5])
    pi = lanes.pose_iters
    if pi is not None and pi.shape[1] == 2:
        # pose_iters holds iterations times S: a difference of d of them
        # is d * S, and the waiting warp idles 32 slots an iteration.
        gap = (pi[:, 0] - pi[:, 1]).abs_()
        torch.sum(gap, dim=0, dtype=torch.int64, out=out[5])
        out[5:6].mul_(32).floor_divide_(lanes.x.shape[1])
    else:
        out[5:6].zero_()
    if lanes.lane_busy is not None:
        torch.sum(lanes.lane_busy, dim=(0, 1), dtype=torch.int64,
                  out=out[6])
    else:
        out[6:7].zero_()
    if lanes.draws is not None:
        torch.sum(lanes.draws, dim=0, dtype=torch.int64, out=out[7:9])
    else:
        out[7:9].zero_()
    return out


def probe_counts(row) -> tuple:
    """``(lane_iters, slots, span_ns, tail_ns, pair_wait_slots,
    lane_busy_iters)`` of a :func:`probe_row` or a sum of them: the warp
    slots executed are the loop trips times 32 (a warp synchronises), the
    span is last warp exit less first warp start, the tail is last warp
    exit less the last draw (from then on the card only drains), the pair
    wait the slots an earlier warp of a pair idled at the pair's barrier
    until the later one was through, the busy iterations those the lanes
    spent inside an attempt.  The one definition of slot use, tail and the
    pair's wait: the telemetry's counters, :func:`exec_slots` and
    :func:`schedule_profile` read it."""
    ran, trips, start, draw, end, wait, busy = (int(v) for v in row[:7])
    return ran, 32 * trips, end - start, end - draw, wait, busy


def draw_counts(row) -> tuple:
    """``(restart_draws, pose_switch_draws)`` of a :func:`probe_row` or a
    sum of them: the restarts the restart queue handed out (B * R a
    launch; 0 from the pose groups) and the draws whose pose differs from
    the drawing lane's previous restart's."""
    return int(row[7]), int(row[8])


def exec_slots(lanes: LaneResult) -> int:
    """The warp slots a launch held (:func:`probe_counts`; it
    synchronises): the slots its warps executed, and those an earlier warp
    of a pair spent waiting at the pair's barrier for the later one.
    ``lane_iters`` over it is the occupied share of the slots, at most 1
    on every path (a pose on a pair of warps counts until the later warp
    is through, on both warps)."""
    counts = probe_counts(probe_row(lanes).tolist())
    return counts[1] + counts[4]


def schedule_profile(lanes: LaneResult) -> dict:
    """Where a launch's time went, from the kernel's ``%globaltimer`` probe
    (one fetch; call it after the launch, it synchronises).

    ``span_ms`` is first warp start to last warp exit.  ``tail_ms`` is what
    remains of it after the last piece of work was handed out (the last
    draw from the pose queue): from then on the card only drains
    (:func:`probe_counts` defines both).  ``exit_ms`` are the times, from
    the first start, by which 50%, 90%, 99% and all of the warps had left.
    Per solve: the lane-iterations the pose groups ran, the warp slots
    executed (32 per loop trip) and the slots held (:func:`exec_slots`:
    executed, and waited at a pair's barrier); ``occupied_share`` is the
    lane-iterations over the held slots, ``pair_wait_share``
    the waited slots over the held ones, and ``lane_busy_share`` the
    lanes' busy iterations over the held ones (None where the launch did
    not record them).
    """
    ran, executed, span, tail, wait, busy = probe_counts(
        probe_row(lanes).tolist())
    slots = executed + wait
    t = lanes.warp_times.cpu().numpy()
    end = t[:, 2]
    q = np.quantile(end - int(t[:, 0].min()), [0.5, 0.9, 0.99, 1.0])
    b = lanes.x.shape[0]
    return {"warps": int(t.shape[0]), "span_ms": span / 1e6,
            "tail_ms": tail / 1e6, "tail_share": tail / max(span, 1),
            "exit_ms": [float(v) / 1e6 for v in q],
            "lane_iters_per_solve": ran / b,
            "executed_slots_per_solve": executed / b,
            "held_slots_per_solve": slots / b,
            "occupied_share": ran / max(slots, 1),
            "pair_wait_share": wait / max(slots, 1),
            "lane_busy_share": None if lanes.lane_busy is None
            else busy / max(slots, 1)}


def solve_kernel(plan: KernelPlan, tgt_r: torch.Tensor, tgt_t: torch.Tensor,
                 x0: torch.Tensor, fmad: bool = True, restart_offset: int = 0,
                 lane0_stream: bool = False) -> LaneResult:
    """Launch the CUDA kernel on CUDA tensors (float32 only).

    ``fmad`` picks the library build (see :func:`load_library`).
    ``restart_offset`` shifts the restart stream (table row i is the draw
    for index ``i + off``; the restart indices returned stay local, and the
    caller adds the offset), and ``lane0_stream`` starts lane 0 from table
    row 0 instead of ``x0`` while Quality distances still measure against
    ``x0`` (``optik_tpu/ops/pallas/lm_kernel.py:238-271``).
    """
    _check_inputs(tgt_r, tgt_t, x0, plan.a)
    device = _check_cuda_f32(tgt_r=tgt_r, tgt_t=tgt_t, x0=x0)
    b, a = x0.shape[0], plan.a
    with torch.cuda.device(device):
        with telemetry.span("optik.ik.layout"):
            seeds = plan.seeds(x0, restart_offset, lane0_stream)
            table = plan.table(device, restart_offset) if plan.reseed \
                else None
            if queued(plan):
                # Lane-major start points and one record a pose.
                seeds = seeds.reshape(b * plan.s, a).contiguous()
                tgt = pack_records(tgt_r, tgt_t, x0)
                qx0 = None
            else:
                seeds = seeds.permute(2, 0, 1).reshape(a, b * plan.s) \
                    .contiguous()
                tgt = pack_targets(tgt_r, tgt_t)
                qx0 = x0.T.contiguous() if plan.reseed and plan.quality \
                    else None
        return launch_lanes(plan, seeds, tgt, table, qx0, reseed=plan.reseed,
                            freeze=plan.freeze, fmad=fmad)


def plain_lanes(plan: KernelPlan, seeds: torch.Tensor, tgt_r: torch.Tensor,
                tgt_t: torch.Tensor, table: Optional[torch.Tensor] = None,
                x0: Optional[torch.Tensor] = None, *, reseed: bool,
                freeze: bool, track_active: bool = False) -> LaneResult:
    """:func:`launch_lanes` as plain torch, on any device: (B, S, A) start
    points through :func:`lm_soa.lm_loop` in kernel math mode.

    ``lane_iters`` is the lockstep loop's count times B*S (every lane runs
    until the slowest stops); :func:`pose_lane_iters` of ``active_iters``
    is the kernel's count.
    """
    device = seeds.device
    b, s = seeds.shape[:2]
    res = lm_soa.solve_soa(
        plan.consts, plan.lower, plan.upper, plan.opts, seeds,
        tgt_r[:, None], tgt_t[:, None],
        wl=plan.cfg.linear_weight, wa=plan.cfg.angular_weight,
        seed_table=table if reseed else None,
        lane_index=torch.arange(s, dtype=torch.int32, device=device)
        if reseed else None,
        total_restarts=plan.r_total if reseed else s,
        success_stops_group=freeze, explore_full_budget=plan.quality,
        quality_x0=None if x0 is None else x0[:, None],
        group_success_cap=plan.cap or None, approx=True,
        track_active=track_active)
    ridx = res.restart_index
    if ridx is None:
        ridx = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    return LaneResult(
        x=res.x, f=res.f, success=res.success, restart_index=ridx,
        succ_iters=res.succ_iters,
        lane_iters=torch.tensor(res.iters * b * s, dtype=torch.int64,
                                device=device),
        active_iters=res.active_iters)


def solve_plain(plan: KernelPlan, tgt_r: torch.Tensor, tgt_t: torch.Tensor,
                x0: torch.Tensor, restart_offset: int = 0,
                lane0_stream: bool = False,
                track_active: bool = False) -> LaneResult:
    """The kernel's function as plain torch, on any device, with the same
    options as :func:`solve_kernel` and the plan's uploaded seed table
    (drawn at ``x0``'s dtype: a float32 solve reads the kernel's)."""
    _check_inputs(tgt_r, tgt_t, x0, plan.a)
    with telemetry.span("optik.ik.layout"):
        seeds = plan.seeds(x0, restart_offset, lane0_stream)
        table = plan.table(x0.device, restart_offset, x0.dtype) \
            if plan.reseed else None
    return plain_lanes(plan, seeds, tgt_r, tgt_t, table, x0,
                       reseed=plan.reseed, freeze=plan.freeze,
                       track_active=track_active)


def solve_lanes(plan: KernelPlan, tgt_r: torch.Tensor, tgt_t: torch.Tensor,
                x0: torch.Tensor, restart_offset: int = 0,
                lane0_stream: bool = False) -> LaneResult:
    """Dispatch by :func:`kernel_runs`: the kernel where it holds, else
    :func:`solve_plain` on the tensors' device (CPU or CUDA)."""
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LM solve for device {x0.device}")
    if kernel_runs(plan.spec, plan.cfg, x0.dtype, x0.device):
        return solve_kernel(plan, tgt_r, tgt_t, x0,
                            restart_offset=restart_offset,
                            lane0_stream=lane0_stream)
    return solve_plain(plan, tgt_r, tgt_t, x0, restart_offset, lane0_stream)


def select(plan: KernelPlan, lanes: LaneResult,
           x0: torch.Tensor) -> ik_mod.IKResult:
    """Per-pose winner in the plan's mode (Speed: lowest successful restart
    index; Quality: the success nearest to ``x0``) -> IKResult."""
    with telemetry.span("optik.ik.select"):
        out = ik_mod.select(plan.cfg.solution_mode, lanes.x, lanes.f,
                            lanes.success, x0, lanes.restart_index,
                            lanes.succ_iters)
        return out._replace(lane_iters=lanes.lane_iters)


def build_kernel_solver(spec, cfg: SolverConfig, ee_offset=None):
    """``fn(tgt_r (B,3,3), tgt_t (B,3), x0 (B,A), restart_offset=0,
    lane0_stream=False) -> IKResult`` for one robot+config, dispatching by
    the tensors' device (:func:`solve_lanes`).
    """
    plan = KernelPlan(spec, cfg, ee_offset)

    def solve(tgt_r, tgt_t, x0, restart_offset=0,
              lane0_stream=False) -> ik_mod.IKResult:
        lanes = solve_lanes(plan, tgt_r, tgt_t, x0, restart_offset,
                            lane0_stream)
        return select(plan, lanes, x0)

    return solve
