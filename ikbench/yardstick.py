"""The roofline's yardstick, frozen: the card's published peaks, the least
time a batch can take, and the bytes an IK batch must move.

Copied from the port's ``utils/roofline.py`` (the peaks and ``bound_ms``)
and ``benchmarks/bench.py`` (``ik_batch_bytes``) so that a change to the
program cannot move them.  The operations a batch needs are not counted
here at run time: the configuration's file freezes the FP32 operations
per lane-iteration and the cell's file the lane-iterations per solve
(``ikbench/workcount/`` recounts both).
"""

from __future__ import annotations

from typing import Optional, Tuple

# Published peaks by device-name substring: (FP32 FLOP/s outside the
# tensor cores, a fused multiply-add as 2; device-memory bytes/s), NVIDIA
# H100 SXM at its 700 W limit.
PEAKS = {
    "H100": (66.9e12, 3.35e12),
}


def peaks(device_name: str) -> Optional[Tuple[float, float]]:
    """``(FP32 FLOP/s, bytes/s)`` of a card, or None for one the table
    does not know."""
    for key, val in PEAKS.items():
        if key in device_name:
            return val
    return None


def bound_ms(ops: float, nbytes: float, device_name: str
             ) -> Optional[Tuple[float, str]]:
    """``(least milliseconds, "operations" or "bytes")``: the larger of
    ``ops`` over the FP32 peak and ``nbytes`` over the memory rate; None
    for an unknown card."""
    pk = peaks(device_name)
    if pk is None:
        return None
    t_ops, t_bytes = ops / pk[0], nbytes / pk[1]
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def ik_batch_bytes(b: int, a: int, r: int) -> int:
    """Bytes one ``ik_batch`` call must move: targets, seeds and the
    restart table read once; found, x, cost and iterations written once
    (float32, int8 and int32)."""
    return 4 * (12 * b + a * b + r * a) + b * (1 + 4 * a + 4 + 4)
