"""Multi-device IK over ``torch.distributed`` (the port of
``optik_tpu/parallel``): :mod:`.mesh` (the (data, seed) mesh and the sharded
entry points), :mod:`.distributed` (process-group bring-up, the pod mesh)
and :mod:`.launch` (N ranks on one host)."""

from .distributed import initialize, local_device, pod_mesh
from .mesh import (Mesh, build_seed_sharded_solver, build_sharded_cascade,
                   ik_sharded, make_mesh)

__all__ = ["Mesh", "build_seed_sharded_solver", "build_sharded_cascade",
           "ik_sharded", "initialize", "local_device", "make_mesh",
           "pod_mesh"]
