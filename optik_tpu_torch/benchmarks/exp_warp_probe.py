#!/usr/bin/env python3
"""Primitive probes: seven tiny kernels, each writing one (8, 256) array.

The counterpart of ``benchmarks/exp_mosaic_probe.py``, which asked of the
TPU compiler whether a primitive lowers at all.  Here each case asks the
same of ``nvcc`` (``optik_tpu_torch/csrc/warp_probe.cu``) and, beyond that,
compares the value it writes exactly with a plain torch version:

  iota_dim0, iota_dim1   an iota along each axis
  iota_s1_broadcast      an (8, 1) iota broadcast along the row
  zeros_i32              int32 zeros
  int8_store             an int8 store of a compare
  while_i32_carry        a 4-trip loop carrying an int32
  while_mask_all_exit    a loop that carries a float, an int32 flag and the
                         trip count and exits once every element's flag is
                         set (a block-wide vote on the card)

Run on a machine with an NVIDIA card, from the repository root:

    python3 -m optik_tpu_torch.benchmarks.exp_warp_probe

It prints one JSON line per case.  :func:`run_case` dispatches by device:
``"cpu"`` gives the plain version, a CUDA device launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys

import torch

from ..ops.cuda import build

# Kernel launches made by run_kernel since the last reset.
LAUNCHES = 0

SOURCE = build.CSRC / "warp_probe.cu"
S, P = 8, 256
CASES = ("iota_dim0", "iota_dim1", "iota_s1_broadcast", "zeros_i32",
         "int8_store", "while_i32_carry", "while_mask_all_exit")
# The cases one PyTorch call computes (:func:`library_case`); the others
# are loops or a compare followed by a cast.
LIBRARY_CASES = CASES[:4]


def _case_index(name: str) -> int:
    if name not in CASES:
        raise ValueError(f"no probe case named {name!r}; one of {CASES}")
    return CASES.index(name)


def plain_case(name: str, device="cpu") -> torch.Tensor:
    """Case ``name`` in plain torch: an (8, 256) int32 (int8 for
    ``int8_store``) tensor on ``device``."""
    _case_index(name)
    i32 = dict(dtype=torch.int32, device=device)
    if name in ("iota_dim0", "iota_s1_broadcast"):
        return torch.arange(S, **i32)[:, None].expand(S, P).contiguous()
    if name == "iota_dim1":
        return torch.arange(P, **i32)[None, :].expand(S, P).contiguous()
    if name == "zeros_i32":
        return torch.zeros((S, P), **i32)
    if name == "int8_store":
        zero = torch.zeros((S, P), dtype=torch.float32, device=device)
        return (zero > 1).to(torch.int8)
    if name == "while_i32_carry":
        x, it = torch.zeros((S, P), **i32), 0
        while it < 4:
            x, it = x + 1, it + 1
        return x
    x = torch.zeros((S, P), dtype=torch.float32, device=device)
    m, it = torch.zeros((S, P), **i32), 0
    while it < 8 and not bool((m > 0).all()):
        m = m | (x > 2.0).to(torch.int32)
        x = torch.where(m > 0, x, x + 1.0)
        it += 1
    return m


def library_case(name: str, device="cpu") -> torch.Tensor:
    """One of ``LIBRARY_CASES`` as a single PyTorch call: ``torch.zeros``,
    or ``torch.arange`` seen through a broadcast view."""
    if name not in LIBRARY_CASES:
        raise ValueError(f"no single call computes {name!r}")
    if name == "zeros_i32":
        return torch.zeros((S, P), dtype=torch.int32, device=device)
    if name == "iota_dim1":
        return torch.arange(P, dtype=torch.int32, device=device).expand(S, P)
    return torch.arange(S, dtype=torch.int32,
                        device=device)[:, None].expand(S, P)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build the probes at first use and load them: ``(CDLL, BuildInfo)``."""
    lib, info = build.build_library(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.optik_warp_probe.argtypes = [ci, vp, vp]
    lib.optik_warp_probe.restype = ci
    lib.optik_warp_probe_error_string.argtypes = [ci]
    lib.optik_warp_probe_error_string.restype = ctypes.c_char_p
    lib.optik_warp_probe_cases.argtypes = []
    lib.optik_warp_probe_cases.restype = ci
    if lib.optik_warp_probe_cases() != len(CASES):
        raise RuntimeError(f"{info.path} holds another set of cases")
    return lib, info


def run_kernel(name: str, device="cuda") -> torch.Tensor:
    """Launch case ``name`` on a CUDA device; launches on the current stream
    and does not synchronise."""
    global LAUNCHES
    which = _case_index(name)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probe kernels run on a CUDA device, not "
                         f"{device}")
    lib, _ = load_library()
    dtype = torch.int8 if name == "int8_store" else torch.int32
    with torch.cuda.device(device):
        out = torch.empty((S, P), dtype=dtype, device=device)
        rc = lib.optik_warp_probe(
            which, out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError("optik_warp_probe failed: " +
                               lib.optik_warp_probe_error_string(rc).decode())
        LAUNCHES += 1
    return out


def run_case(name: str, device="cuda") -> torch.Tensor:
    """Dispatch by device: CPU -> :func:`plain_case`, CUDA -> the kernel."""
    device = torch.device(device)
    if device.type == "cpu":
        return plain_case(name, device)
    if device.type == "cuda":
        return run_kernel(name, device)
    raise ValueError(f"no probe for device {device}")


def run_all(device="cuda", cases=CASES) -> dict:
    """The ``cases`` on ``device`` against their plain versions there:
    ``{name: {"exact", "max_abs_err"}}``, the largest ``|got - want|`` and
    whether type, shape and every value agree."""
    out = {}
    for name in cases:
        got = run_case(name, device)
        want = plain_case(name, device)
        same = got.dtype == want.dtype and got.shape == want.shape
        err = float((got.double() - want.double()).abs().max()) if same \
            else float("inf")
        out[name] = {"exact": same and err == 0.0, "max_abs_err": err}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_warp_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    results = run_all("cuda")
    for name, row in results.items():
        print(json.dumps({"case": name, "ok": row["exact"],
                          "max_abs_err": row["max_abs_err"]}), flush=True)
    return 0 if all(r["exact"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
