"""Multi-host runtime helpers: the port of
``optik_tpu/parallel/distributed.py``.

The engine is topology-agnostic: the sharded entry points of
:mod:`optik_tpu_torch.parallel.mesh` take any mesh.  Across hosts the only
extra steps are bringing up the ``torch.distributed`` process group and
building a mesh whose ``data`` axis spans hosts (pose shards never
communicate; the network carries the result assembly only) while the
``seed`` axis stays within a host's cards (the winner merge runs there).
This module wraps that recipe.  Nothing on a machine tells a program of
its cluster: pass the coordinator's address, the world size and this
process's rank, or launch under ``torchrun``, whose environment
(``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``) ``initialize()`` reads when given no address.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "nccl",
               timeout: Optional[float] = None) -> None:
    """Bring up the default ``torch.distributed`` process group
    (idempotent: a second call does nothing).

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of rank
    0; None reads the launcher's environment (``env://``).  ``backend`` is
    ``"nccl"`` for ranks on cards (one card per rank) and ``"gloo"`` for
    ranks on the CPU, or for several ranks sharing one card (NCCL refuses
    two ranks on one device; gloo takes CUDA tensors for ``all_reduce`` and
    ``broadcast``, which is all the mesh's solves use on the card).
    ``timeout`` (seconds) bounds every collective.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kw)


def local_device() -> torch.device:
    """The card this rank drives: ``cuda:{local_rank % device_count}``, the
    local rank being the launcher's ``LOCAL_RANK`` (else the global rank:
    one host), so ranks that outnumber a host's cards share them."""
    if not torch.cuda.is_available():
        raise RuntimeError("local_device: torch.cuda.is_available() is "
                           "False; build the Robot on the CPU instead")
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device(f"cuda:{local_rank % torch.cuda.device_count()}")


def pod_mesh(seed_per_host: int = 1) -> Mesh:
    """A (data, seed) mesh for the whole world: data spans hosts, seed stays
    within each host's local ranks.

    ``seed_per_host`` local ranks per host are assigned to the seed axis;
    the rest extend the data axis.  The launcher numbers a host's ranks
    contiguously (``torchrun`` does), so each row of the mesh lies on one
    host.
    """
    n_total = dist.get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", n_total))
    if n_local % seed_per_host:
        raise ValueError("seed_per_host must divide local device count")
    seed = seed_per_host
    data = n_total // seed
    return make_mesh(data=data, seed=seed)
