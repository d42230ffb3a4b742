"""Run a function on N ranks of a fresh process group on this host.

    results = launch.spawn(fn, world_size, *args, backend="gloo")

Plumbing with no counterpart in the JAX package (whose multi-process test
starts its workers by hand).  Each rank is a process started with the
``spawn`` method (never ``fork``: the parent may hold a CUDA context); it
brings the group up through :func:`distributed.initialize` on a free
localhost port, runs ``fn(*args)`` and sends back the result with every
tensor moved to the CPU.  ``fn`` must be importable in a fresh interpreter:
a module-level function of a module that imports torch, not jax (the test
suite's ``conftest.py`` imports jax, so never a test module), or of the
script being run.  Each rank runs on one CPU thread: the ranks are the
parallelism.  A rank that fails ends the whole run: the others are killed
and the rank's traceback is raised.

Build the CUDA libraries a run needs in the parent before spawning: the
build cache is on disk (``ops/cuda/build.py``), so the ranks load what the
parent built instead of each paying nvcc.

:func:`solve` is a rank function for the sharded entry points: it builds
a Robot on the rank's device and runs a list of :class:`Case` s, each on a
mesh over the first ``data * seed`` ranks.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
from typing import Any, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from . import distributed

# Extra seconds the collectives wait beyond the run's own limit.
_GRACE_S = 30.0


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def to_cpu(obj):
    """``obj`` with every tensor inside tuples, lists and dicts on the CPU
    (named tuples keep their type)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_cpu(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, world_size, port, backend, timeout, fn, args, out):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    torch.set_num_threads(1)
    try:
        distributed.initialize(f"tcp://localhost:{port}", world_size, rank,
                               backend=backend, timeout=timeout + _GRACE_S)
        # Pickled here, by value: the queue's own pickler would pass CPU
        # tensors as shared-memory handles, which die with this process.
        out.put((rank, pickle.dumps(to_cpu(fn(*args))), None))
        dist.barrier()
    except BaseException:
        out.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, backend: str = "gloo",
          timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks; returns each rank's
    result (tensors on the CPU), in rank order.

    Raises ``RuntimeError`` with the traceback of the first rank that
    fails, or of a rank that exits without a result, and ``TimeoutError``
    when the ranks have not all answered within ``timeout`` seconds; every
    rank is stopped before it returns or raises.
    """
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world_size, port, backend, timeout, fn,
                               args, results))
             for rank in range(world_size)]
    answers, failure = {}, None
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(answers) < world_size and failure is None:
            try:
                rank, value, err = results.get(timeout=1.0)
            except queue.Empty:
                gone = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in answers]
                if gone:
                    failure = (f"rank {gone[0]} exited with code "
                               f"{procs[gone[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world_size - len(answers)} of {world_size} ranks "
                        f"gave no result within {timeout} s")
                continue
            if err is not None:
                failure = f"rank {rank} failed:\n{err}"
            answers[rank] = None if value is None else pickle.loads(value)
        if failure is None:
            for p in procs:
                p.join(timeout=_GRACE_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [answers[r] for r in range(world_size)]


class Case(NamedTuple):
    """One sharded solve for :func:`solve`."""

    entry: str                  # "seed_sharded", "cascade" or "ik_sharded"
    cfg: Any                    # SolverConfig
    data: int                   # mesh shape, over ranks 0 .. data*seed - 1
    seed: int
    inputs: tuple               # (tgt_r, tgt_t, x0): arrays or CPU tensors
    repeat: int = 1             # solves of the same inputs
    dtype: torch.dtype = torch.float32


def solve(cases, spec, device: Optional[str] = None) -> list:
    """Rank function: run every :class:`Case` on a Robot of ``spec`` and
    return, per case, the list of its ``repeat`` results on this rank
    (None on a rank outside the case's mesh).

    ``device`` None is the rank's card (:func:`distributed.local_device`);
    ``"cpu"`` runs the plain versions.  A mesh is made once per shape, by
    every rank, in the order the cases first use it (a shape larger than
    the world is asked of the whole world, which rejects it).  A case whose inputs
    the entry rejects (``ValueError``, raised on every rank of its mesh
    before any collective) gives that error as its result.
    """
    from ..robot import Robot
    from . import mesh as mesh_mod

    if device is None:
        device = distributed.local_device()
    robots, meshes, out = {}, {}, []
    for case in cases:
        if case.dtype not in robots:
            robots[case.dtype] = Robot(spec, dtype=case.dtype, device=device)
        robot = robots[case.dtype]
        try:
            shape = (case.data, case.seed)
            if shape not in meshes:
                n = case.data * case.seed
                meshes[shape] = mesh_mod.make_mesh(
                    range(n) if n <= dist.get_world_size() else None,
                    data=case.data, seed=case.seed)
            mesh = meshes[shape]
            if mesh.coord is None:
                out.append(None)
                continue
            if case.entry == "ik_sharded":
                def fn(*inputs, cfg=case.cfg, mesh=mesh):
                    return mesh_mod.ik_sharded(robot, cfg, *inputs, mesh)
            elif case.entry == "seed_sharded":
                fn = mesh_mod.build_seed_sharded_solver(robot, case.cfg,
                                                        mesh)
            elif case.entry == "cascade":
                fn = mesh_mod.build_sharded_cascade(robot, case.cfg, mesh)
            else:
                raise ValueError(f"unknown entry {case.entry!r}")
            out.append([fn(*case.inputs) for _ in range(case.repeat)])
        except ValueError as e:
            out.append(e)
    return out
