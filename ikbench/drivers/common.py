"""What the drivers share: the program's objects for a configuration, the
inputs made from the seed, the sample the check judges, the record's
device fields."""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..reference.chain import Chain


def seed_int(seed: int) -> int:
    """The seed as the 63-bit number both generators take."""
    return int(seed) & (2 ** 63 - 1)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed_int(seed))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """Host-side draws (which answers the check samples), apart from the
    device's stream of inputs."""
    return np.random.default_rng([seed_int(seed), stream])


def chain_of(ctx) -> Chain:
    return Chain(ctx.urdf, ctx.config["base_link"], ctx.config["ee_link"])


def robot_of(ctx, device):
    """The program's Robot for the configuration, on ``device``."""
    from optik_tpu_torch import Robot

    if ctx.config["dtype"] != "float32":
        raise ValueError("ikbench runs float32 configurations")
    return Robot.from_urdf_str(ctx.urdf, ctx.config["base_link"],
                               ctx.config["ee_link"], dtype=torch.float32,
                               device=device)


def solver_of(ctx):
    from optik_tpu_torch import SolverConfig

    return SolverConfig.create(**ctx.config["solver"])


def uniform(chain: Chain, g: torch.Generator, n: int, device):
    """(n, A) float64 configurations uniform in the joint limits."""
    lo, hi = (torch.tensor(v, dtype=torch.float64, device=device)
              for v in chain.sample_box())
    u = torch.rand((n, chain.dof), generator=g, dtype=torch.float64,
                   device=device)
    return lo + (hi - lo) * u


def ik_inputs(chain: Chain, g: torch.Generator, b: int, device):
    """One IK batch: targets are the reference's float64 FK of uniform
    configurations, seeds uniform; all rounded to float32."""
    r, p = chain.fk(uniform(chain, g, b, device))
    x0 = uniform(chain, g, b, device)
    return (r.float().contiguous(), p.float().contiguous(),
            x0.float().contiguous())


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def memory_peak(device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def note(tag: str, **fields) -> None:
    """A diagnostic line on standard error, before the result."""
    print(f"ikbench {tag}: {json.dumps(fields)}", file=sys.stderr,
          flush=True)


def sample_rows(seed: int, slots: int, rows: int, n: int):
    """``n`` (slot, row) pairs drawn from the seed: which answers the check
    judges."""
    rng = host_rng(seed, 1)
    return rng.integers(slots, size=n), rng.integers(rows, size=n)


def gather(tensors, slot_idx, row_idx, device):
    """The sampled rows of per-slot tensors: ``tensors[slot][row]``."""
    out = []
    for s in np.unique(slot_idx):
        sel = np.nonzero(slot_idx == s)[0]
        rows = torch.as_tensor(row_idx[sel], device=device)
        out.append((sel, tensors[int(s)].index_select(0, rows)))
    order = np.concatenate([sel for sel, _ in out])
    cat = torch.cat([t for _, t in out])
    return cat[torch.as_tensor(np.argsort(order), device=device)]
