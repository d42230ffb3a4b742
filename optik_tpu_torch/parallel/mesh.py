"""Multi-device IK over ``torch.distributed``: the port of
``optik_tpu/parallel/mesh.py``.

The scaling axes are the JAX package's:

  * ``data``  — pose queries: a rank solves its shard of the batch;
  * ``seed``  — restart seeds: the restarts of a pose are split over ranks.

A :class:`Mesh` is a (data, seed) grid of the ranks of the default process
group, each rank driving one device (``distributed.local_device()``, or the
CPU).  Where the JAX package lets XLA partition one program and lowers the
winner selection to a collective, each rank here runs the port's own solve
on its part and meets the others in explicit collectives:

  * the **seed group** (one row of the grid: the ranks that share a pose
    shard) merges each pose's winner: the least key by ``all_reduce(MIN)``,
    ties to the lowest seed index (the first lane in lane order; folded into
    an integer key, a second MIN after a float one), then the winner's x,
    cost and iterations by a masked ``all_reduce(SUM)``;
  * the **data group** (one column) assembles the full batch: ``all_gather``
    where the backend has one for the tensors' device, else an
    ``all_reduce(SUM)`` of zero-padded shards (gloo takes CUDA tensors for
    ``broadcast`` and ``all_reduce`` only);
  * the **mesh group** (every rank of the grid) sums the work counter and,
    in :func:`ik_sharded`, decides when the lockstep loop stops.

Every rank receives the full inputs, takes its pose shard (as the JAX
``to_global`` does) and returns the full (B, ...) result.  The caller brings
the process group up first (``distributed.initialize``, or ``launch.spawn``
on one host); every rank of the world creates every mesh, since a process
group is created collectively.

Which entry to use (as in the JAX package): :func:`build_seed_sharded_solver`
is the main path (each rank runs the Hopper kernel on its slice of the
restart stream, one merge per solve); :func:`build_sharded_cascade` is pure
data parallelism on the single-shot kernel path (no solve-time collective);
:func:`ik_sharded` partitions the lanes of one plain lockstep loop, any
(data, seed) factorization, at the plain loop's speed.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry
from ..config import SolutionMode, SolverConfig
from ..ops.cuda import lm_kernel
from ..solver import ik as ik_mod
from ..solver import lm_soa

ReduceOp = dist.ReduceOp


class _MeshReduce(lm_soa.LaneReduce):
    """:class:`lm_soa.LaneReduce` over a mesh: a pose's lanes meet over the
    seed group, the stop test over the whole mesh."""

    def __init__(self, mesh: "Mesh"):
        self.mesh = mesh

    def group_any(self, t, dim):
        v = t.any(dim=dim, keepdim=True).to(torch.int32)
        dist.all_reduce(v, op=ReduceOp.MAX, group=self.mesh.groups["seed"])
        return v > 0

    def group_sum(self, t, dim):
        v = t.sum(dim=dim, keepdim=True)
        dist.all_reduce(v, op=ReduceOp.SUM, group=self.mesh.groups["seed"])
        return v

    def all_stopped(self, stopped):
        v = stopped.all().to(torch.int32).reshape(1)
        dist.all_reduce(v, op=ReduceOp.MIN, group=self.mesh.groups["mesh"])
        return bool(v)


class Mesh:
    """A (data, seed) grid of process-group ranks and its groups.

    ``devices`` is the (data, seed) array of ranks, ``shape`` maps the axis
    names to their sizes (as ``jax.sharding.Mesh.shape`` does), ``coord``
    is this rank's (data, seed) index, or None when the rank is not in the
    grid.  Made by :func:`make_mesh`.
    """

    axis_names = ("data", "seed")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"data": devices.shape[0], "seed": devices.shape[1]}
        rows = [dist.new_group([int(r) for r in row]) for row in devices]
        cols = [dist.new_group([int(r) for r in col]) for col in devices.T]
        whole = dist.new_group([int(r) for r in devices.flat])
        hit = np.argwhere(devices == dist.get_rank())
        self.coord = self.groups = None
        if len(hit):
            i, d = (int(v) for v in hit[0])
            self.coord = (i, d)
            self.groups = {"seed": rows[i], "data": cols[d], "mesh": whole}
        # Solvers built on this mesh, keyed by (chain, dtype, device, config).
        self.solvers = {}

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                             f"{self.devices.tolist()}")
        return self.coord[self.axis_names.index(axis)]

    def shard(self, b: int) -> slice:
        """The rows of a B-pose batch this rank solves."""
        n = self.shape["data"]
        if b % n:
            raise ValueError("pose batch not divisible by mesh 'data' axis")
        k = b // n
        i = self.index("data")
        return slice(i * k, (i + 1) * k)

    def lane_reduce(self) -> lm_soa.LaneReduce:
        return _MeshReduce(self)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of a counter over every rank of the mesh."""
        with telemetry.span("optik.mesh.total"):
            t = t.clone().reshape(1)
            dist.all_reduce(t, op=ReduceOp.SUM, group=self.groups["mesh"])
            return t.reshape(())

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Pose shards (b, ...) of the data group -> the full (n*b, ...)."""
        group, n, i = self.groups["data"], self.shape["data"], \
            self.index("data")
        t = t.contiguous()
        if t.device.type == "cpu" or dist.get_backend(group) == "nccl":
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=group)
            return torch.cat(parts)
        full = t.new_zeros((n * t.shape[0],) + tuple(t.shape[1:]))
        full[i * t.shape[0]:(i + 1) * t.shape[0]] = t
        dist.all_reduce(full, op=ReduceOp.SUM, group=group)
        return full

    def merge(self, out: ik_mod.IKResult, key: torch.Tensor):
        """Each pose's winner over the seed group, assembled over the data
        group: (found, x, cost, iters) of the full batch.

        ``out`` is this rank's per-pose pick and ``key`` its selection key
        (an integer restart index, ``INT32_MAX`` for not found, or a float
        distance, +inf for not found): the least key wins, ties go to the
        lowest seed index, as ``argmin`` over the unsharded lanes does.
        Where no rank found the pose, the winner is the first lane's pick.
        """
        with telemetry.span("optik.mesh.merge"):
            group, d, n = self.groups["seed"], self.index("seed"), \
                self.shape["seed"]
            if key.is_floating_point():
                kmin = key.clone()
                dist.all_reduce(kmin, op=ReduceOp.MIN, group=group)
                cand = key == kmin
                first = torch.where(cand, d, n).to(torch.int32)
                dist.all_reduce(first, op=ReduceOp.MIN, group=group)
                mine = cand & (first == d)
                found = torch.isfinite(kmin)
            else:
                # An integer key and the seed index fold into one key: one
                # MIN.
                key = key.to(torch.int64) * n + d
                kmin = key.clone()
                dist.all_reduce(kmin, op=ReduceOp.MIN, group=group)
                mine = key == kmin
                found = kmin < ik_mod.INT32_MAX * n
            dtype = out.x.dtype
            # One masked sum and one gather carry every per-pose field (the
            # iteration counts and the flag are exact in the float dtype).
            picked = torch.cat([out.x, out.cost[:, None],
                                out.iters[:, None].to(dtype)], dim=1)
            picked = torch.where(mine[:, None], picked, 0)
            dist.all_reduce(picked, op=ReduceOp.SUM, group=group)
            full = self.gather(torch.cat([found[:, None].to(dtype), picked],
                                         1))
            a = out.x.shape[1]
            return (full[:, 0] > 0, full[:, 1:1 + a], full[:, 1 + a],
                    full[:, 2 + a].to(torch.int32))


def make_mesh(devices: Optional[Sequence[int]] = None,
              data: Optional[int] = None, seed: int = 1) -> Mesh:
    """Build a (data, seed) mesh over the given (default: all) ranks of the
    default process group.

    ``data * seed`` must equal the rank count; ``data`` defaults to
    ``len(devices) // seed``.  Every rank of the world calls this, in the
    same order (the groups are created collectively); a rank outside
    ``devices`` gets a mesh it cannot solve on.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "optik_tpu_torch.parallel.distributed.initialize "
                           "first")
    world = dist.get_world_size()
    devices = list(range(world) if devices is None
                   else (int(r) for r in devices))
    if any(not 0 <= r < world for r in devices) \
            or len(set(devices)) != len(devices):
        raise ValueError(f"mesh devices {devices} are not distinct ranks of "
                         f"a world of {world}")
    n = len(devices)
    if data is None:
        data = n // seed
    if data * seed != n:
        raise ValueError(f"mesh shape {data}x{seed} != {n} devices")
    return Mesh(np.array(devices, dtype=np.int64).reshape(data, seed))


def _inputs(robot, tgt_r, tgt_t, x0):
    return tuple(ik_mod.as_tensor(v, robot.dtype, robot.device)
                 for v in (tgt_r, tgt_t, x0))


def ik_sharded(robot, cfg: SolverConfig, tgt_r, tgt_t, x0,
               mesh: Mesh) -> ik_mod.IKResult:
    """Solve B poses x S seeds sharded over a (data, seed) mesh.

    ``robot`` is an optik_tpu_torch.Robot.  B must be divisible by
    mesh.shape['data'] and S (cfg.total_restarts, and the lane count
    min(seed_batch, total_restarts)) by mesh.shape['seed'].  The lanes run
    the plain lockstep loop (``solver/lm_soa.py``) on every rank, on the
    CPU and on the card alike: :func:`ik_sharded` is the fully general,
    slower entry (the JAX package's XLA path; see
    ``solver/ik.build_batch_solver`` for the partition).  Its results equal
    the unsharded ``build_batch_solver``'s, ``lane_iters`` included.

    For kernel-speed solves use :func:`build_seed_sharded_solver` (seed axis
    > 1: each rank runs the Hopper kernel on its restart-stream slice, one
    merge per solve) or :func:`build_sharded_cascade` (pure data
    parallelism, no solve-time collective).
    """
    if tgt_r.shape[0] % mesh.shape["data"]:
        raise ValueError("pose batch not divisible by mesh 'data' axis")
    if cfg.total_restarts % mesh.shape["seed"]:
        raise ValueError("restart count not divisible by mesh 'seed' axis")
    key = ("lockstep", robot.spec.content_key(), robot.dtype, robot.device,
           cfg)
    fn = mesh.solvers.get(key)
    if fn is None:
        fn = mesh.solvers[key] = ik_mod.build_batch_solver(
            robot.spec, cfg, robot.dtype, device=robot.device, mesh=mesh)
    return fn(*_inputs(robot, tgt_r, tgt_t, x0))


def build_seed_sharded_solver(robot, cfg: SolverConfig, mesh: Mesh):
    """Kernel-speed IK sharded over BOTH mesh axes: the main path.

    Rank (i, d) runs ``robot``'s LM solve (``lm_kernel.solve_lanes``: the
    Hopper kernel of ``ops/cuda/lm_kernel.py`` where ``kernel_runs`` holds,
    its plain version on the rank's device otherwise: on the CPU, for a
    float64 robot, for more than 32 joints) on pose shard
    i with restart-stream slice ``[d*R/n, (d+1)*R/n)`` (R =
    cfg.total_restarts, n = mesh.shape['seed']) through the kernel's
    ``restart_offset``; ranks d > 0 swap the caller-x0 lane for the
    stream's own draw (``lane0_stream``), so the union of the ranks'
    attempts is exactly the single-device restart stream.  One merge over
    the seed group then picks each pose's winner:

      * Speed: the lowest global restart index among every rank's
        registered successes (the ranks' index ranges are disjoint, so
        exactly one rank claims each found pose);
      * Quality: the least seed distance to the caller's x0 over every
        success in the budget, float-equal ties to the lowest seed index.
        Quality explores its full budget (no pose freezing), so the result
        is bitwise the single-device full-budget solve's.

    The found mask is bitwise the single-device full-budget solve's in both
    modes (an attempt's outcome is a function of its seed alone).  The
    Speed winner can differ from the single-device one where per-rank pose
    freezing truncates different attempts, but every winner meets the same
    tolerances and selection is deterministic for a fixed mesh shape.
    ``iters`` is the winning rank's iterations-to-converge.  Not-found
    poses return ``x = x0`` and ``cost = +inf``.  ``lane_iters`` is summed
    over the whole mesh, ``found_count`` over the data shards.

    ``cfg.quality_max_successes`` is rejected (its truncation is per rank
    and would change the selection pool across mesh shapes).

    Returns ``solve(tgt_r (B,3,3), tgt_t (B,3), x0 (B,A)) -> IKResult``
    with B divisible by the data axis.
    """
    n_seed = int(mesh.shape["seed"])
    n_data = int(mesh.shape["data"])
    r_total = cfg.total_restarts
    if r_total % n_seed:
        raise ValueError(
            f"total_restarts {r_total} not divisible by mesh 'seed' axis "
            f"{n_seed}")
    speed = cfg.solution_mode == SolutionMode.SPEED
    if not speed and cfg.quality_max_successes:
        raise ValueError(
            "quality_max_successes truncates per chip and is unsupported "
            "with seed sharding; use the unsharded kernel or cap=0")
    r_sub = r_total // n_seed
    plan = lm_kernel.KernelPlan(robot.spec, cfg.replace(max_restarts=r_sub))
    d = mesh.index("seed")
    off = d * r_sub

    def solve(tgt_r, tgt_t, x0) -> ik_mod.IKResult:
        with telemetry.span("optik.mesh.solve"):
            b = tgt_r.shape[0]
            if b % n_data:
                raise ValueError(
                    f"batch {b} must be a multiple of data_axis = {n_data}")
            tr, tt, x0 = _inputs(robot, tgt_r, tgt_t, x0)
            rows = mesh.shard(b)
            x0_rows = x0[rows]
            lanes = lm_kernel.solve_lanes(plan, tr[rows], tt[rows], x0_rows,
                                          off, d > 0)
            res = lm_kernel.select(plan, lanes, x0_rows)
            key = res.sel_key
            if speed:
                # This rank's winner as a global restart index.
                key = torch.where(res.found, key.to(torch.int64) + off,
                                  ik_mod.INT32_MAX)
            found, x, cost, iters = mesh.merge(res, key)
            x = torch.where(found[:, None], x, x0)
            cost = torch.where(found, cost, torch.inf)
            iters = torch.where(found, iters, 0)
            return ik_mod.IKResult(found=found, x=x, cost=cost, iters=iters,
                                   lane_iters=mesh.total(res.lane_iters),
                                   found_count=found.sum())

    return solve


def build_sharded_cascade(robot, cfg: SolverConfig, mesh: Mesh):
    """IK sharded over the mesh's ``data`` axis: pure data parallelism.

    The port has no cascade (``solver/ik.py``'s module docstring says why),
    so each rank runs the port's own single-shot path, ``robot.ik_batch``
    (the Hopper kernel on the card), on ITS OWN pose shard; ranks of one
    seed group solve the same shard.  No pose crosses a rank, so the solve
    needs no collective; the only ones are the sums of ``lane_iters`` and
    ``overflow_count`` over the data shards (``found_count`` is the
    assembled batch's) and the assembly of the result.

    Per-pose results are bitwise those of ``robot.ik_batch`` on the shard,
    which are those on the whole batch (a pose's result does not depend on
    its batch).  Returns ``fn(tgt_r (B,3,3), tgt_t (B,3), x0 (B,A)) ->
    IKResult`` with B divisible by the data axis.
    """
    data_n = int(mesh.shape["data"])

    def solve(tgt_r, tgt_t, x0) -> ik_mod.IKResult:
        b = tgt_r.shape[0]
        if b % data_n:
            raise ValueError(
                f"batch {b} must be a multiple of data_axis * block_unit "
                f"= {data_n} * 1 (the single-shot kernel takes any batch; "
                f"pad the batch)")
        tr, tt, x0 = _inputs(robot, tgt_r, tgt_t, x0)
        rows = mesh.shard(b)
        res = robot.ik_batch(cfg, tr[rows], tt[rows], x0[rows],
                             validate_seeds=False, rescue_overflow=False)
        dtype = res.x.dtype
        full = mesh.gather(torch.cat(
            [res.found[:, None].to(dtype), res.x, res.cost[:, None],
             res.iters[:, None].to(dtype)], dim=1))
        counts = torch.stack([res.lane_iters.to(torch.int64),
                              res.overflow_count.to(torch.int64)])
        dist.all_reduce(counts, op=ReduceOp.SUM, group=mesh.groups["data"])
        a = res.x.shape[1]
        found = full[:, 0] > 0
        return ik_mod.IKResult(
            found=found, x=full[:, 1:1 + a], cost=full[:, 1 + a],
            iters=full[:, 2 + a].to(torch.int32), lane_iters=counts[0],
            found_count=found.sum(), overflow_count=counts[1].to(torch.int32))

    return solve
