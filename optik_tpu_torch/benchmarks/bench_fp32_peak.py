#!/usr/bin/env python3
"""FP32 throughput brackets for the solver's instruction profile on the card.

The counterpart of ``benchmarks/bench_vpu_peak.py``.  Three register-resident
loops, each applying one elementwise body ``n_it`` times to C = 8 arrays per
element (``optik_tpu_torch/csrc/fp32_peak.cu``):

  * ``ilp8``   - 8 independent multiply-add chains: the practical upper
                 bound for packable elementwise code;
  * ``serial`` - one fully dependent multiply-add chain, 16 deep: the
                 latency-bound floor of one thread (the card hides it only
                 with other warps);
  * ``mix``    - a solver-shaped blend (multiply-adds across neighbouring
                 arrays, compares and selects, one IEEE division).

The LM kernel's achieved FP32 rate lands between these; ``achieved / mix``
is its share of what dependent code of that shape reaches.  A contracted
multiply-add is one instruction and counts as two operations, as in the
original's operation counts.

The function is shape-free.  The TPU original ran (8, 8, 512): 4,096
elements, which would leave this card empty, so the timed run uses enough
elements to fill every SM several times over.

Run on a machine with an NVIDIA card, from the repository root:

    python3 -m optik_tpu_torch.benchmarks.bench_fp32_peak

It prints one JSON line per body.  :func:`run_body` dispatches by device:
a CPU tensor goes through the plain torch version, a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys
import time

import numpy as np
import torch

from ..ops.cuda import build

# Kernel launches made by run_kernel since the last reset.
LAUNCHES = 0

SOURCE = build.CSRC / "fp32_peak.cu"
C = 8
BODIES = ("ilp8", "serial", "mix")
# Operations per element and trip (a multiply-add is 2; the division 1, as
# in the original's count).
OPS_PER_TRIP = {"ilp8": 2 * C, "serial": 32, "mix": C * 4 + (C // 4) * 2 + 2}
# The timed shape: 132 SMs x 2,048 resident threads x 4 waves, and trip
# counts that keep a launch above 10 ms at the card's FP32 peak.
N_TIMED = 132 * 2048 * 4
N_IT_TIMED = {"ilp8": 65536, "serial": 32768, "mix": 16384}
# The TPU original's element count, used for the parity check, and a trip
# count at which contraction stays inside 1e-5: a fused multiply-add rounds
# once where the plain version rounds twice, at most one ulp (2^-23
# relative) apart, and `serial` chains 16 of them per trip, so 4 trips give
# at most 64 x 2^-23 = 7.6e-6.  The difference is systematic, not a random
# walk (chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W: 7.2e-6 after
# 4 trips, 1.4e-5 after 8).
N_CHECK = 8 * 512
N_IT_CHECK = 4
RTOL_CONTRACTED = 1e-5

_MUL, _ADD, _NEIGHBOUR = 1.000001, 1e-7, 1e-9


def plain_body(name: str, xs):
    """One trip of body ``name`` over the list of C arrays ``xs``."""
    if name == "ilp8":
        return [x * _MUL + _ADD for x in xs]
    if name == "serial":
        y = xs[0]
        for _ in range(16):
            y = y * _MUL + _ADD
        return [y] + list(xs[1:])
    if name == "mix":
        out = []
        for i, x in enumerate(xs):
            y = x * _MUL + _ADD
            y = y + xs[(i + 1) % C] * _NEIGHBOUR
            if i % 4 == 0:
                y = torch.where(y > x, y, x)
            out.append(y)
        out[0] = out[0] / (out[1] + 2.0)
        return out
    raise ValueError(f"no body named {name!r}; one of {BODIES}")


def run_plain(name: str, x: torch.Tensor, n_it: int) -> torch.Tensor:
    """``n_it`` trips of body ``name`` over the (C, n) array ``x`` in plain
    torch, on any device."""
    xs = [x[c] for c in range(C)]
    for _ in range(n_it):
        xs = plain_body(name, xs)
    return torch.stack(xs)


@functools.lru_cache(maxsize=None)
def load_library(fmad: bool = True):
    """Build the probe at first use and load it: ``(CDLL, BuildInfo)``.
    ``fmad=False`` builds without multiply-add contraction, which is bitwise
    equal to :func:`run_plain` on the card."""
    lib, info = build.build_library(SOURCE, (), fmad)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.optik_fp32_peak.argtypes = [ci, vp, vp, ci, ci, vp]
    lib.optik_fp32_peak.restype = ci
    lib.optik_fp32_peak_error_string.argtypes = [ci]
    lib.optik_fp32_peak_error_string.restype = ctypes.c_char_p
    lib.optik_fp32_peak_arrays.argtypes = []
    lib.optik_fp32_peak_arrays.restype = ci
    if lib.optik_fp32_peak_arrays() != C:
        raise RuntimeError(f"{info.path} was built for another array count")
    return lib, info


def run_kernel(name: str, x: torch.Tensor, n_it: int,
               fmad: bool = True) -> torch.Tensor:
    """Launch body ``name`` on the (C, n) float32 CUDA array ``x``; launches
    on the current stream and does not synchronise."""
    global LAUNCHES
    if name not in BODIES:
        raise ValueError(f"no body named {name!r}; one of {BODIES}")
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("the probe kernel takes a float32 CUDA tensor; got "
                         f"{x.dtype} on {x.device}")
    if x.dim() != 2 or x.shape[0] != C or not x.is_contiguous():
        raise ValueError(f"expected a contiguous ({C}, n) array, got "
                         f"{tuple(x.shape)}")
    n = x.shape[1]
    if n < 1 or C * n > 2**31 - 1 or n_it < 0:
        raise ValueError(f"n={n}, n_it={n_it} out of range")
    lib, _ = load_library(fmad)
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        rc = lib.optik_fp32_peak(
            BODIES.index(name), x.data_ptr(), out.data_ptr(), n, int(n_it),
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError("optik_fp32_peak failed: " +
                               lib.optik_fp32_peak_error_string(rc).decode())
        LAUNCHES += 1
    return out


def run_body(name: str, x: torch.Tensor, n_it: int) -> torch.Tensor:
    """Dispatch by device: CPU -> :func:`run_plain`, CUDA -> the kernel."""
    if x.device.type == "cpu":
        return run_plain(name, x, n_it)
    if x.device.type == "cuda":
        return run_kernel(name, x, n_it)
    raise ValueError(f"no FP32 probe for device {x.device}")


def make_input(n: int, device) -> torch.Tensor:
    """The original's input: uniform [0.5, 1) from numpy seed 0, (C, n)."""
    x = np.random.default_rng(0).uniform(0.5, 1.0, (C, n))
    return torch.tensor(x, dtype=torch.float32, device=device)


def check_parity(n: int = N_CHECK, n_it=N_IT_CHECK,
                 rtol=RTOL_CONTRACTED) -> dict:
    """Hold every body against its plain version on ``n`` elements after
    ``n_it`` trips (one count, or one per body): the uncontracted build
    bitwise, the contracted one within ``rtol`` (``None``: not held, at a
    depth where contraction has drifted past any fixed limit).  Returns
    ``{"max_abs_err", "max_rel_err", "plain_ms"}``: the contracted build's
    largest differences and the host-clock time of the plain versions."""
    x = make_input(n, "cuda")
    out = {"max_abs_err": 0.0, "max_rel_err": 0.0, "plain_ms": 0.0}
    for name in BODIES:
        trips = n_it[name] if isinstance(n_it, dict) else n_it
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        want = run_plain(name, x, trips)
        torch.cuda.synchronize(x.device)
        out["plain_ms"] += 1e3 * (time.perf_counter() - t0)
        exact = run_kernel(name, x, trips, fmad=False)
        got = run_kernel(name, x, trips)
        if not torch.equal(exact, want):
            raise AssertionError(f"fp32_peak {name}: the uncontracted build "
                                 f"differs from the plain version after "
                                 f"{trips} trips")
        if rtol is not None:
            torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)
        diff = (got - want).abs()
        out["max_abs_err"] = max(out["max_abs_err"], float(diff.max()))
        out["max_rel_err"] = max(out["max_rel_err"],
                                 float((diff / want.abs()).max()))
    return out


def measure(device="cuda", reps: int = 3) -> dict:
    """Time every body at the timed shape with CUDA events: ``{name:
    {"gops_per_s", "ms", "ops_per_trip", "n", "n_it"}}`` (best of ``reps``
    after one warm launch)."""
    x = make_input(N_TIMED, device)
    out = {}
    for name in BODIES:
        n_it = N_IT_TIMED[name]
        run_body(name, x, n_it)
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run_body(name, x, n_it)
            end.record()
            torch.cuda.synchronize(x.device)
            best = min(best, start.elapsed_time(end))
        ops = OPS_PER_TRIP[name] * N_TIMED * n_it
        out[name] = {"gops_per_s": ops / (best * 1e-3) / 1e9, "ms": best,
                     "ops_per_trip": OPS_PER_TRIP[name], "n": N_TIMED,
                     "n_it": n_it}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_fp32_peak: needs an NVIDIA card", file=sys.stderr)
        return 2
    err = check_parity()["max_abs_err"]
    device = torch.cuda.get_device_name(0)
    for name, row in measure().items():
        print(json.dumps({
            "metric": f"fp32_{name}_gops_per_s", "value": row["gops_per_s"],
            "unit": "Gop/s", "ops_per_iter_per_elem": row["ops_per_trip"],
            "ms": row["ms"], "elements": row["n"], "n_it": row["n_it"],
            "parity_max_abs_err": err, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
