"""Roofline and utilization accounting for the LM solver on an NVIDIA card:
the port of ``optik_tpu/utils/roofline.py``.

    util = lane_iters * flops_per_lane_iter / seconds / fp32_peak

* ``lane_iters`` comes from the solve itself (``IKResult.lane_iters``; on
  the card the lane-iterations the pose groups ran).
* ``flops_per_lane_iter`` is counted, not read from a compiler: the JAX
  package reads XLA's cost analysis of its loop body, the port counts the
  FP32 operations one lane-iteration needs on the robot's chain
  (``ops/cuda/lm_kernel.fp32_ops_per_lane_iter``: the residual and Jacobian
  traced by ``ops/opcount.py`` with the chain's static terms folded, the
  dense algebra by hand; a fused multiply-add counts 2).
* The peaks are the NVIDIA H100 SXM's published figures (dense, at its
  700 W limit): 66.9 TFLOP/s FP32 outside the tensor cores and 3.35 TB/s of
  HBM3.  No TPU figure carries over; a card this table does not know has
  no peak (None), and :func:`bound_ms` refuses it.

The JAX package's VPU issue-slot model (``op_histogram``,
``speed_of_light``) is specific to the TPU's vector unit and has no
counterpart here: on the card the bound is :func:`bound_ms`, the larger of
operations over the FP32 peak and bytes over the memory rate.
"""

from __future__ import annotations

from typing import Optional, Tuple

# Published peaks by device-name substring: (FP32 FLOP/s outside the tensor
# cores, a fused multiply-add as 2; device-memory bytes/s).
_PEAKS = {
    "H100": (66.9e12, 3.35e12),
}


def _peaks(device_name: str) -> Optional[Tuple[float, float]]:
    for key, peaks in _PEAKS.items():
        if key in device_name:
            return peaks
    return None


def fp32_peak_flops(device_name: str) -> Optional[float]:
    """Published FP32 peak FLOP/s of a card (``torch.cuda.get_device_name``),
    or None for a card the table does not know."""
    peaks = _peaks(device_name)
    return None if peaks is None else peaks[0]


def memory_peak_bytes(device_name: str) -> Optional[float]:
    """Published device-memory bytes/s of a card, or None."""
    peaks = _peaks(device_name)
    return None if peaks is None else peaks[1]


def lane_iter_cost(spec, cfg) -> dict:
    """FP32 operations one lane-iteration of the LM loop needs for one
    robot+config: ``{"flops": n}``."""
    from ..ops.cuda import lm_kernel

    return {"flops": float(lm_kernel.fp32_ops_per_lane_iter(
        lm_kernel.KernelPlan(spec, cfg)))}


def utilization(lane_iters: float, seconds: float, flops_per_iter: float,
                device_name: str) -> dict:
    """Achieved model FLOP/s and FP32 utilization for a timed solve."""
    achieved = lane_iters * flops_per_iter / max(seconds, 1e-12)
    peak = fp32_peak_flops(device_name)
    out = {"model_gflops_per_s": achieved / 1e9}
    if peak:
        out["fp32_peak_gflops"] = peak / 1e9
        out["fp32_util"] = achieved / peak
    return out


def bound_ms(ops: float, nbytes: float,
             device_name: str) -> Tuple[float, str]:
    """(least milliseconds, what bounds it): the larger of ``ops`` FP32
    operations over the card's peak and ``nbytes`` over its memory rate,
    with "operations" or "bytes"."""
    peaks = _peaks(device_name)
    if peaks is None:
        raise ValueError(f"no published peaks for {device_name!r}")
    t_ops, t_bytes = ops / peaks[0], nbytes / peaks[1]
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")
