"""What the probe and parity scripts and ``chip_smoke.py`` share: the card's
name and power limit, the host CPU's model, the solvers' dtype on a device
and a CUDA-event timer.  The port's benchmark is ``ikbench/``, which reads
nothing from here."""

from __future__ import annotations

import os
import subprocess

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
