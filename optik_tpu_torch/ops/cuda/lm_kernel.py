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

Scope (ROADMAP Queue 2, K1): Speed mode, with and without reseeding,
identity weights, a constant ``ee_offset`` folded into the chain tip,
S = min(seed_batch, total_restarts) dividing 32, DoF 1..10, float32.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from ...config import SolutionMode, SolverConfig
from ... import random as rnd
from ...solver import ik as ik_mod
from ...solver import lm_soa
from .. import soa

# Kernel launches made by solve_kernel since the last reset (set it to 0 to
# start a count).
LAUNCHES = 0

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "csrc" / "lm_kernel.cu"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "optik_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_DOF = 10
_JOINT_FLOATS = 54
_TIP_FLOATS = 13


class BuildInfo(NamedTuple):
    seconds: float       # nvcc wall time (0.0 when the library was cached)
    cached: bool
    ptxas: str           # the -Xptxas -v report (registers, spills)


class LaneResult(NamedTuple):
    """Per-lane solve outputs on the (B, S) lane grid."""

    x: torch.Tensor              # (B, S, A)
    f: torch.Tensor              # (B, S)
    success: torch.Tensor        # (B, S) bool
    restart_index: torch.Tensor  # (B, S) int32
    succ_iters: torch.Tensor     # (B, S) int32
    lane_iters: torch.Tensor     # 0-d int64, see solve_kernel / solve_plain


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "toolkit is needed to build optik_tpu_torch/csrc/lm_kernel.cu")
    return found


@functools.lru_cache(maxsize=2)
def load_library(fmad: bool = True):
    """Build the kernel library at first use and load it: (CDLL, BuildInfo).

    The library goes to ``build/optik_tpu_torch/<hash>/`` at the repository
    root, keyed by a hash of the source and the flags, so an edit rebuilds
    and a second process reuses the build.  ``fmad=False`` adds
    ``--fmad=false``: without multiply-add contraction the kernel rounds
    every operation as torch's elementwise CUDA kernels do, and its results
    are bitwise equal to :func:`solve_plain` on the card (the parity check
    of chip_smoke.py and tests/test_torch_cuda.py).  The solver itself uses
    the contracted build.
    """
    flags = NVCC_FLAGS if fmad else NVCC_FLAGS + ("--fmad=false",)
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib_path = out_dir / "liboptik_lm.so"
    log_path = out_dir / "ptxas.txt"
    seconds, cached = 0.0, lib_path.exists()
    if not cached:
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_lib = pathlib.Path(tmp) / lib_path.name
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", str(tmp_lib), str(SOURCE)],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
                    f"{proc.stdout}\n{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp_lib, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.optik_lm_solve.argtypes = [ci, vp, ci, vp, ci, ci, ci, ci,
                                   vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.optik_lm_solve.restype = ci
    lib.optik_lm_error_string.argtypes = [ci]
    lib.optik_lm_error_string.restype = ctypes.c_char_p
    for name in ("optik_lm_block_threads", "optik_lm_joint_floats",
                 "optik_lm_tip_floats", "optik_lm_max_dof"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    if (lib.optik_lm_joint_floats() != _JOINT_FLOATS
            or lib.optik_lm_tip_floats() != _TIP_FLOATS
            or lib.optik_lm_max_dof() != MAX_DOF):
        raise RuntimeError(f"{lib_path} does not match this wrapper's layout")
    ptxas = log_path.read_text() if log_path.exists() else ""
    return lib, BuildInfo(seconds, cached, ptxas)


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


def check_supported(spec, cfg: SolverConfig) -> None:
    """Raise for what the CUDA kernel (K1) does not run yet."""
    if cfg.solution_mode != SolutionMode.SPEED:
        raise NotImplementedError(
            "Quality mode on the CUDA kernel is ROADMAP Queue 2 K3")
    if not (soa.weights_are_identity(cfg.linear_weight)
            and soa.weights_are_identity(cfg.angular_weight)):
        raise NotImplementedError(
            "per-axis weights on the CUDA kernel are ROADMAP Queue 2 K2")
    s = min(cfg.seed_batch, cfg.total_restarts)
    if 32 % s:
        raise NotImplementedError(
            f"seed lanes S={s} must divide 32 on the CUDA kernel; other S "
            "are ROADMAP Queue 2 K2")
    if not 1 <= spec.num_positions <= MAX_DOF:
        raise ValueError(
            f"the CUDA kernel is built for 1..{MAX_DOF} DoF, got "
            f"{spec.num_positions}")


class KernelPlan:
    """Everything one (robot, config, ee_offset) solve needs, built once.

    Holds the folded chain constants, the packed kernel chain, the LM
    options and the restart seed table; the table is uploaded once per
    device and both the kernel and :func:`solve_plain` read that copy.
    """

    def __init__(self, spec, cfg: SolverConfig, ee_offset=None):
        check_supported(spec, cfg)
        self.cfg = cfg
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
        self.chain = pack_chain(consts, self.lower, self.upper)
        o = self.opts
        self.opt_array = np.array(
            [o.max_iters, o.tol_f, o.tol_df, o.tol_dx, o.f_is_success,
             o.df_is_success, o.dx_is_success, o.lam_init, o.lam_min,
             o.lam_max], np.float32)
        self.table_host = rnd.seed_table(cfg.rng_seed, self.r_total,
                                         spec.lower, spec.upper, np.float32)
        self._tables = {}

    def table(self, device: torch.device) -> torch.Tensor:
        """The (R, A) float32 seed table on ``device`` (uploaded once)."""
        t = self._tables.get(device)
        if t is None:
            t = torch.tensor(self.table_host, dtype=torch.float32,
                             device=device)
            self._tables[device] = t
        return t

    def seeds(self, x0: torch.Tensor) -> torch.Tensor:
        """(B, S, A) start points: lane 0 = x0, lanes s > 0 = table[s]."""
        b = x0.shape[0]
        tab = self.table(x0.device)
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


def solve_kernel(plan: KernelPlan, tgt_r: torch.Tensor, tgt_t: torch.Tensor,
                 x0: torch.Tensor, fmad: bool = True) -> LaneResult:
    """Launch the CUDA kernel on CUDA tensors (float32 only).

    ``fmad`` picks the library build (see :func:`load_library`).

    ``lane_iters`` counts the lane-iterations the kernel executed:
    the sum over warps of the warp's loop count times its lanes below
    L = B*S.  (The JAX kernel counts per pose block, ``lm_kernel.py:374``;
    a warp here exits on its own, so its count is per warp.)
    """
    global LAUNCHES
    _check_inputs(tgt_r, tgt_t, x0, plan.a)
    device = x0.device
    if device.type != "cuda":
        raise ValueError(f"solve_kernel needs CUDA tensors, got {device}")
    for name, t in (("tgt_r", tgt_r), ("tgt_t", tgt_t), ("x0", x0)):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32; {name} is "
                            f"{t.dtype}")
    lib, _ = load_library(fmad)
    b, s, a = x0.shape[0], plan.s, plan.a
    n_lanes = b * s
    block = lib.optik_lm_block_threads()
    n_warps = -(-n_lanes // block) * block // 32
    with torch.cuda.device(device):
        table = plan.table(device)
        seeds = plan.seeds(x0).permute(2, 0, 1).reshape(a, n_lanes)
        seeds = seeds.contiguous()
        tgt = torch.cat([tgt_r.reshape(b, 9).T, tgt_t.T], dim=0).contiguous()
        x_out = torch.empty((a, n_lanes), dtype=torch.float32, device=device)
        f_out = torch.empty(n_lanes, dtype=torch.float32, device=device)
        succ = torch.empty(n_lanes, dtype=torch.int8, device=device)
        ridx = torch.empty(n_lanes, dtype=torch.int32, device=device)
        sit = torch.empty(n_lanes, dtype=torch.int32, device=device)
        warp_it = torch.empty(n_warps, dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.optik_lm_solve(
            a, plan.chain.ctypes.data, plan.chain.size,
            plan.opt_array.ctypes.data, n_lanes, s, plan.r_total,
            int(plan.reseed), seeds.data_ptr(), tgt.data_ptr(),
            table.data_ptr(), x_out.data_ptr(), f_out.data_ptr(),
            succ.data_ptr(), ridx.data_ptr(), sit.data_ptr(),
            warp_it.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                "optik_lm_solve failed: "
                + lib.optik_lm_error_string(rc).decode())
        LAUNCHES += 1
        active = (n_lanes - 32 * torch.arange(n_warps, device=device)
                  ).clamp(0, 32)
        lane_iters = (warp_it.to(torch.int64) * active).sum()
    return LaneResult(
        x=x_out.reshape(a, b, s).permute(1, 2, 0),
        f=f_out.reshape(b, s), success=succ.reshape(b, s).bool(),
        restart_index=ridx.reshape(b, s), succ_iters=sit.reshape(b, s),
        lane_iters=lane_iters)


def solve_plain(plan: KernelPlan, tgt_r: torch.Tensor, tgt_t: torch.Tensor,
                x0: torch.Tensor) -> LaneResult:
    """The kernel's function as plain torch, on any device.

    Runs :func:`lm_soa.lm_loop` in kernel math mode on the (B, S) lane grid,
    reading the plan's uploaded seed table.  ``lane_iters`` is the lockstep
    loop's count times B*S (every lane runs until the slowest stops).
    """
    _check_inputs(tgt_r, tgt_t, x0, plan.a)
    device = x0.device
    b, s = x0.shape[0], plan.s
    table = plan.table(device)
    res = lm_soa.solve_soa(
        plan.consts, plan.lower, plan.upper, plan.opts, plan.seeds(x0),
        tgt_r[:, None], tgt_t[:, None],
        seed_table=table if plan.reseed else None,
        lane_index=torch.arange(s, dtype=torch.int32, device=device)
        if plan.reseed else None,
        total_restarts=plan.r_total, success_stops_group=True, approx=True)
    ridx = res.restart_index
    if ridx is None:
        ridx = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    return LaneResult(
        x=res.x, f=res.f, success=res.success, restart_index=ridx,
        succ_iters=res.succ_iters,
        lane_iters=torch.tensor(res.iters * b * s, dtype=torch.int64,
                                device=device))


def solve_lanes(plan: KernelPlan, tgt_r: torch.Tensor, tgt_t: torch.Tensor,
                x0: torch.Tensor) -> LaneResult:
    """Dispatch by device: CPU -> :func:`solve_plain`, CUDA -> the kernel."""
    if x0.device.type == "cpu":
        return solve_plain(plan, tgt_r, tgt_t, x0)
    if x0.device.type == "cuda":
        return solve_kernel(plan, tgt_r, tgt_t, x0)
    raise ValueError(f"no LM solve for device {x0.device}")


def select(plan: KernelPlan, lanes: LaneResult,
           x0: torch.Tensor) -> ik_mod.IKResult:
    """Per-pose winner (lowest successful restart index) -> IKResult."""
    out = ik_mod.select(SolutionMode.SPEED, lanes.x, lanes.f, lanes.success,
                        x0, lanes.restart_index, lanes.succ_iters)
    return out._replace(lane_iters=lanes.lane_iters)


def build_kernel_solver(spec, cfg: SolverConfig, ee_offset=None):
    """``fn(tgt_r (B,3,3), tgt_t (B,3), x0 (B,A)) -> IKResult`` for one
    robot+config, dispatching by the tensors' device (:func:`solve_lanes`).
    """
    plan = KernelPlan(spec, cfg, ee_offset)

    def solve(tgt_r, tgt_t, x0) -> ik_mod.IKResult:
        return select(plan, solve_lanes(plan, tgt_r, tgt_t, x0), x0)

    return solve
