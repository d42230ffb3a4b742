"""The LM solve as a hand-written Hopper kernel, and its plain torch version.

The counterpart of ``optik_tpu/ops/pallas/lm_kernel.py:build_kernel_solver``.
The kernel (``optik_tpu_torch/csrc/lm_kernel.cu``) runs the whole lockstep
projected-LM solve with one thread per lane; this module builds it with
``nvcc`` at first use, binds its plain C entry point with ``ctypes``, lays
out the inputs, launches it, and picks each pose's winner in torch, as the
JAX package does outside its Pallas kernel (``lm_kernel.py:345-377``).

Dispatch is by device: :func:`solve_lanes` sends a CPU tensor to
:func:`solve_plain` (the same function through
:func:`optik_tpu_torch.solver.lm_soa.lm_loop` in kernel math mode) and a
CUDA tensor to :func:`solve_kernel`, which launches the kernel or raises.
Nothing falls back.

Scope: everything the Pallas kernel runs.  Speed and Quality mode (best
success by distance to the caller's seed, ``quality_max_successes`` cap),
with and without reseeding, per-axis weights, ``restart_offset`` and
``lane0_stream`` (both on the host: they only change the seed table and the
start points), a constant ``ee_offset`` folded into the chain tip, any
S = min(seed_batch, total_restarts) from 1 to 64, DoF 1..10, float32.  One
library holds one instantiation (DoF, mode, weighted, two-warp poses,
contraction) and is built when a solve first needs it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...config import SolutionMode, SolverConfig
from ... import random as rnd
from ...solver import ik as ik_mod
from ...solver import lm_soa
from .. import soa
from . import build

# Kernel launches made by launch_lanes since the last reset (set it to 0 to
# start a count).
LAUNCHES = 0

SOURCE = build.CSRC / "lm_kernel.cu"
MAX_DOF = 10
MAX_SEED_LANES = 64
_JOINT_FLOATS = 54
_TIP_FLOATS = 13
_NUM_OPTS = 19


class LaneResult(NamedTuple):
    """Per-lane solve outputs on the (B, S) lane grid."""

    x: torch.Tensor              # (B, S, A)
    f: torch.Tensor              # (B, S)
    success: torch.Tensor        # (B, S) bool
    restart_index: torch.Tensor  # (B, S) int32, local to the call (0..R-1)
    succ_iters: torch.Tensor     # (B, S) int32
    lane_iters: torch.Tensor     # 0-d int64, see launch_lanes / solve_plain
    # (B, S) int32 iterations each lane ran before it stopped; only from
    # solve_plain(track_active=True).
    active_iters: Optional[torch.Tensor] = None


@functools.lru_cache(maxsize=None)
def load_library(dof: int, quality: bool = False, weighted: bool = False,
                 wide: bool = False, fmad: bool = True):
    """Build one instantiation of the kernel at first use and load it:
    ``(CDLL, build.BuildInfo)``.

    ``quality`` compiles the Quality-mode loop (best tracking, success
    cap), ``weighted`` the per-axis objective weights, ``wide`` the exchange
    between the two warps of a 33..64-lane pose that Speed freeze and the
    Quality cap need.  ``fmad=False`` builds without multiply-add
    contraction: that build is bitwise equal to :func:`solve_plain` on the
    card (the parity check of chip_smoke.py and tests/test_torch_cuda.py).
    The solver itself uses the contracted build.
    """
    flags = (f"-DOPTIK_DOF={dof}", f"-DOPTIK_QUALITY={int(quality)}",
             f"-DOPTIK_WEIGHTED={int(weighted)}", f"-DOPTIK_WIDE={int(wide)}")
    lib, info = build.build_library(SOURCE, flags, fmad)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.optik_lm_solve.argtypes = ([vp, ci, vp] + [ci] * 7 + [vp] * 11)
    lib.optik_lm_solve.restype = ci
    lib.optik_lm_error_string.argtypes = [ci]
    lib.optik_lm_error_string.restype = ctypes.c_char_p
    for name in ("optik_lm_block_threads", "optik_lm_joint_floats",
                 "optik_lm_tip_floats", "optik_lm_max_dof",
                 "optik_lm_num_opts", "optik_lm_variant"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    want = dof | int(quality) << 8 | int(weighted) << 9 | int(wide) << 10
    if (lib.optik_lm_joint_floats() != _JOINT_FLOATS
            or lib.optik_lm_tip_floats() != _TIP_FLOATS
            or lib.optik_lm_max_dof() != MAX_DOF
            or lib.optik_lm_num_opts() != _NUM_OPTS
            or lib.optik_lm_variant() != want):
        raise RuntimeError(f"{info.path} does not match this wrapper's "
                           "layout or the requested instantiation")
    return lib, info


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


def _rodrigues_coeffs(axis):
    """(c0, cc, cs, c1) with R = c0 + cos*cc + sin*cs + (1-cos)*c1 entrywise,
    the same terms ``soa.rodrigues`` keeps after its static folding."""
    kx, ky, kz = axis
    c0, cc, cs, c1 = (np.zeros((3, 3)) for _ in range(4))
    for i, kk in enumerate((ky * ky + kz * kz, kx * kx + kz * kz,
                            kx * kx + ky * ky)):
        if kk == 1.0:
            cc[i, i] = 1.0
        else:
            c0[i, i], c1[i, i] = 1.0, -kk
    for (i, j), sk, kab in (((0, 1), -kz, kx * ky), ((0, 2), ky, kx * kz),
                            ((1, 0), kz, kx * ky), ((1, 2), -kx, ky * kz),
                            ((2, 0), -ky, kx * kz), ((2, 1), kx, ky * kz)):
        cs[i, j], c1[i, j] = sk, kab
    return c0, cc, cs, c1


def pack_chain(consts, lower, upper) -> np.ndarray:
    """The kernel's flat float32 chain array (layout: csrc/lm_kernel.cu)."""
    org_r, org_t, axes, pris, tip_r, tip_t, has_tip = consts
    rows = []
    for j in range(len(axes)):
        c0, cc, cs, c1 = _rodrigues_coeffs(axes[j])
        rows.append(np.concatenate([
            np.ravel(org_r[j]), org_t[j], axes[j], c0.ravel(), cc.ravel(),
            cs.ravel(), c1.ravel(), [lower[j], upper[j], float(pris[j])]]))
    rows.append(np.concatenate([np.ravel(tip_r), tip_t, [float(has_tip)]]))
    out = np.concatenate(rows).astype(np.float32)
    assert out.size == len(axes) * _JOINT_FLOATS + _TIP_FLOATS
    return out


def padded_lanes(s: int) -> int:
    """Threads a pose's ``s`` lanes occupy: the next divisor of 32, or 64."""
    for cand in (1, 2, 4, 8, 16, 32, 64):
        if s <= cand:
            return cand
    raise NotImplementedError(
        f"seed lanes S={s} > {MAX_SEED_LANES}: the CUDA kernel holds a pose "
        "in at most two warps (the JAX facade also leaves its kernel there)")


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


def check_supported(spec, cfg: SolverConfig) -> None:
    """Raise for what the CUDA kernel does not run."""
    padded_lanes(min(cfg.seed_batch, cfg.total_restarts))
    if not 1 <= spec.num_positions <= MAX_DOF:
        raise ValueError(
            f"the CUDA kernel is built for 1..{MAX_DOF} DoF, got "
            f"{spec.num_positions}")


class KernelPlan:
    """Everything one (robot, config, ee_offset) solve needs, built once.

    Holds the folded chain constants, the packed kernel chain, the LM
    options, the mode, weights and success cap, and the restart seed tables:
    one per ``restart_offset``, made on the host and uploaded once per
    device; the kernel and :func:`solve_plain` read the same copy.
    """

    def __init__(self, spec, cfg: SolverConfig, ee_offset=None):
        check_supported(spec, cfg)
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
        self.s_pad = padded_lanes(self.s)
        self.reseed = self.r_total > self.s
        self.quality = cfg.solution_mode == SolutionMode.QUALITY
        # Speed freezes a pose at its first success; Quality never does.
        self.freeze = not self.quality
        self.cap = cfg.quality_max_successes if self.quality else 0
        self.lin_id = soa.weights_are_identity(cfg.linear_weight)
        self.ang_id = soa.weights_are_identity(cfg.angular_weight)
        self.weighted = not (self.lin_id and self.ang_id)
        self.chain = pack_chain(consts, self.lower, self.upper)
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

    def table(self, device: torch.device, off: int = 0) -> torch.Tensor:
        """The (R, A) float32 seed table on ``device``: row i is the draw
        for restart index ``i + off`` (made and uploaded once per ``off``)."""
        key = (device, int(off))
        t = self._tables.get(key)
        if t is None:
            host = rnd.seed_table(self.cfg.rng_seed, self.r_total,
                                  self.spec.lower, self.spec.upper,
                                  np.float32, off=int(off))
            t = torch.tensor(host, dtype=torch.float32, device=device)
            self._tables[key] = t
        return t

    def seeds(self, x0: torch.Tensor, off: int = 0,
              lane0_stream: bool = False) -> torch.Tensor:
        """(B, S, A) start points: lane 0 = x0 (or table row 0 with
        ``lane0_stream``), lanes s > 0 = table[s]."""
        b = x0.shape[0]
        tab = self.table(x0.device, off)
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


def launch_lanes(plan: KernelPlan, seeds: torch.Tensor, tgt: torch.Tensor,
                 table: Optional[torch.Tensor] = None,
                 qx0: Optional[torch.Tensor] = None, *, reseed: bool,
                 freeze: bool, fmad: bool = True) -> LaneResult:
    """The low-level launch on explicit start points.

    ``seeds`` is (A, L) with lane l = pose * S + s, ``tgt`` (12, B),
    ``table`` (R, A) (read only when ``reseed``), ``qx0`` (A, B) the
    caller's seeds (read only in Quality mode with ``reseed``); all float32
    CUDA tensors.  ``freeze`` turns the Speed-mode group stop on.  Launches
    on the current stream and does not synchronise.

    ``lane_iters`` counts the lane-iterations the kernel executed: the sum
    over warps of the warp's loop count times its live lanes (a warp exits
    on its own; padding lanes of a pose are not counted).
    """
    global LAUNCHES
    a, s = plan.a, plan.s
    tensors = {"seeds": seeds, "tgt": tgt}
    if reseed:
        if table is None:
            raise ValueError("reseeding needs the seed table")
        tensors["table"] = table
        if plan.quality:
            if qx0 is None:
                raise ValueError("Quality mode with reseeding needs qx0")
            tensors["qx0"] = qx0
    device = _check_cuda_f32(**tensors)
    b = tgt.shape[1]
    n_lanes = b * s
    if seeds.shape != (a, n_lanes) or tgt.shape != (12, b):
        raise ValueError(f"expected seeds ({a}, {n_lanes}) and tgt (12, {b}); "
                         f"got {tuple(seeds.shape)}, {tuple(tgt.shape)}")
    if reseed and (table.shape != (plan.r_total, a)
                   or (plan.quality and qx0.shape != (a, b))):
        raise ValueError("seed table must be (R, A) and qx0 (A, B)")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if plan.quality and freeze:
        raise ValueError("the group freeze is Speed mode's")
    lib, _ = load_library(a, plan.quality, plan.weighted, plan.wide(freeze),
                          fmad)
    block = lib.optik_lm_block_threads()
    n_warps = -(-b * plan.s_pad // block) * block // 32
    with torch.cuda.device(device):
        x_out = torch.empty((a, n_lanes), dtype=torch.float32, device=device)
        f_out = torch.empty(n_lanes, dtype=torch.float32, device=device)
        succ = torch.empty(n_lanes, dtype=torch.int8, device=device)
        ridx = torch.empty(n_lanes, dtype=torch.int32, device=device)
        sit = torch.empty(n_lanes, dtype=torch.int32, device=device)
        work = torch.empty(n_warps, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        use_qx0 = reseed and plan.quality
        rc = lib.optik_lm_solve(
            plan.chain.ctypes.data, plan.chain.size,
            plan.opt_array.ctypes.data, plan.opt_array.size, b, s,
            plan.s_pad, plan.r_total if reseed else s, int(reseed),
            int(freeze), seeds.data_ptr(), tgt.data_ptr(),
            table.data_ptr() if reseed else None,
            qx0.data_ptr() if use_qx0 else None, x_out.data_ptr(),
            f_out.data_ptr(), succ.data_ptr(), ridx.data_ptr(),
            sit.data_ptr(), work.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                "optik_lm_solve failed: "
                + lib.optik_lm_error_string(rc).decode())
        LAUNCHES += 1
        lane_iters = work.sum(dtype=torch.int64)
    return LaneResult(
        x=x_out.reshape(a, b, s).permute(1, 2, 0),
        f=f_out.reshape(b, s), success=succ.reshape(b, s).bool(),
        restart_index=ridx.reshape(b, s), succ_iters=sit.reshape(b, s),
        lane_iters=lane_iters)


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
        seeds = plan.seeds(x0, restart_offset, lane0_stream)
        seeds = seeds.permute(2, 0, 1).reshape(a, b * plan.s).contiguous()
        return launch_lanes(
            plan, seeds, pack_targets(tgt_r, tgt_t),
            plan.table(device, restart_offset) if plan.reseed else None,
            x0.T.contiguous() if plan.reseed and plan.quality else None,
            reseed=plan.reseed, freeze=plan.freeze, fmad=fmad)


def plain_lanes(plan: KernelPlan, seeds: torch.Tensor, tgt_r: torch.Tensor,
                tgt_t: torch.Tensor, table: Optional[torch.Tensor] = None,
                x0: Optional[torch.Tensor] = None, *, reseed: bool,
                freeze: bool, track_active: bool = False) -> LaneResult:
    """:func:`launch_lanes` as plain torch, on any device: (B, S, A) start
    points through :func:`lm_soa.lm_loop` in kernel math mode.

    ``lane_iters`` is the lockstep loop's count times B*S (every lane runs
    until the slowest stops).
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
    options as :func:`solve_kernel` and the plan's uploaded seed table."""
    _check_inputs(tgt_r, tgt_t, x0, plan.a)
    return plain_lanes(
        plan, plan.seeds(x0, restart_offset, lane0_stream), tgt_r, tgt_t,
        plan.table(x0.device, restart_offset) if plan.reseed else None, x0,
        reseed=plan.reseed, freeze=plan.freeze, track_active=track_active)


def solve_lanes(plan: KernelPlan, tgt_r: torch.Tensor, tgt_t: torch.Tensor,
                x0: torch.Tensor, restart_offset: int = 0,
                lane0_stream: bool = False) -> LaneResult:
    """Dispatch by device: CPU -> :func:`solve_plain`, CUDA -> the kernel."""
    if x0.device.type == "cpu":
        return solve_plain(plan, tgt_r, tgt_t, x0, restart_offset,
                           lane0_stream)
    if x0.device.type == "cuda":
        return solve_kernel(plan, tgt_r, tgt_t, x0,
                            restart_offset=restart_offset,
                            lane0_stream=lane0_stream)
    raise ValueError(f"no LM solve for device {x0.device}")


def select(plan: KernelPlan, lanes: LaneResult,
           x0: torch.Tensor) -> ik_mod.IKResult:
    """Per-pose winner in the plan's mode (Speed: lowest successful restart
    index; Quality: the success nearest to ``x0``) -> IKResult."""
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
