"""What the measuring scripts share: the card's name, the host CPU's model,
the device fields of a result row, a CUDA-event timer and the host-clock
protocol of the JAX package's scripts (``benchmarks/bench_workloads.py:
28-83``).

A sync is the fetch of one element of a result (on the card that waits for
everything queued before it on the stream, as ``torch.cuda.synchronize``
does; on the CPU the work is done when the call returns).
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..native.host import cpu_model


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def host_cpu() -> str:
    """The host CPU's model name and its logical core count: what a native
    latency stands beside."""
    return f"{cpu_model()}, {os.cpu_count()} logical cores"


def engine_dtype(device) -> torch.dtype:
    """The solvers' dtype on ``device``: the kernel's float32 on the card,
    float64 on the CPU (the JAX package's parity and golden runs are f64
    there)."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


def device_fields(device) -> dict:
    """What a result row says about where it ran: on the card its name,
    the number of cards and the ``nvidia-smi`` name and power limit; on the
    CPU ``{"device": "cpu"}`` and nothing else."""
    if torch.device(device).type == "cuda":
        return {"device": torch.cuda.get_device_name(0),
                "chips": torch.cuda.device_count(), "card": card_line()}
    return {"device": "cpu"}


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (CUDA
    events), after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _first_tensor(out: Any) -> Optional[torch.Tensor]:
    """The first tensor in ``out`` (a tensor, or tuples and lists of them,
    named tuples included; depth first), or None."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(out: Any) -> None:
    """Wait for ``out``: fetch one element of its first tensor."""
    t = _first_tensor(out)
    if t is None:
        raise ValueError(f"nothing to sync on in {type(out).__name__}")
    t.reshape(-1)[0].item()


def timed(fn: Callable[[], Any]) -> Tuple[Any, float]:
    """One warm call, then one call timed on the host clock up to its sync:
    ``(its output, seconds)``."""
    sync(fn())
    t0 = time.perf_counter()
    out = fn()
    sync(out)
    return out, time.perf_counter() - t0


def timed_piped(fn: Callable[[], Any], depth: int = 8, sets: int = 3
                ) -> Tuple[Any, float, float, List[float]]:
    """Chained calls with one sync: one warm call, one warm pass, then
    ``sets`` passes of ``depth`` calls each ending in one sync.

    Returns ``(the last output, median seconds per call, spread, the
    passes' ms per call sorted)``; ``spread`` is (max - min) / median.
    """
    out = fn()
    sync(out)

    def one():
        nonlocal out
        t0 = time.perf_counter()
        for _ in range(depth):
            out = fn()
        sync(out)
        return (time.perf_counter() - t0) / depth

    one()
    vals = sorted(one() for _ in range(sets))
    med = vals[len(vals) // 2]
    spread = (vals[-1] - vals[0]) / med if med > 0 else 0.0
    return out, med, spread, [round(v * 1e3, 2) for v in vals]
