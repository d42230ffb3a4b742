"""The benchmark's one command: find a cell's files by name, run it, print
its result line.

    python3 ikbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
Everything else is found by name under ``ikbench/``:

* ``configs/<config>.json``: the robot (a frozen URDF beside it), the
  solver's settings, the frozen work per lane-iteration;
* ``traffic/<mix>.json``: the mix's parameters; its ``kind`` names the
  generic driver, ``drivers/<kind>.py``, which makes the inputs from the
  seed, drives the window and hands back the run's record;
* ``cells/<cell>.json``: what belongs to the pair, such as the frozen
  lane-iterations per solve and the limits of the correctness check;
* ``metrics/<metric>.py``: one metric's arithmetic, ``read(rec)``, which
  returns None where the record holds nothing to read.

A later cell, mix, configuration or metric is a new file and a new entry
in ``BENCHMARK.json``; no file here names one.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# Whole top-level module names the measured process must not hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "optik_tpu")


@dataclasses.dataclass
class Ctx:
    """One run of one cell, as the driver sees it."""

    workload: str
    cell: dict
    config: dict
    traffic: dict
    frozen: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    # A test's "module:function" that breaks the timed path on purpose; it
    # runs in every process of the run after the program is imported.
    patch: Optional[str] = None

    @property
    def urdf(self) -> str:
        return (HERE / "configs" / self.config["urdf"]).read_text()


def load(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load(ROOT / "BENCHMARK.json")


def context(workload: str, seed: int, seconds: float, trace: bool,
            device: str, t0: float, overrides: Optional[dict] = None,
            patch: Optional[str] = None, cell: Optional[dict] = None) -> Ctx:
    """The cell's files, found by name; ``overrides`` replace traffic
    parameters (the CPU rehearsals shrink the batch).  ``cell`` stands in
    for a ``BENCHMARK.json`` entry (a cell whose files exist but which the
    benchmark does not run)."""
    if cell is None:
        cells = {w["name"]: w for w in benchmark()["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        cell = cells[workload]
    config = load(HERE / "configs" / f"{cell['config']}.json")
    traffic = dict(load(HERE / "traffic" / f"{cell['traffic']}.json"))
    traffic.update(overrides or {})
    frozen_path = HERE / "cells" / f"{workload}.json"
    frozen = load(frozen_path) if frozen_path.exists() else {}
    return Ctx(workload, cell, config, traffic, frozen, int(seed),
               float(seconds), bool(trace), device, t0, patch)


def apply_patch(ctx: Ctx) -> None:
    if ctx.patch:
        mod, fn = ctx.patch.split(":")
        getattr(importlib.import_module(mod), fn)()


def reader(name: str) -> Callable[[dict], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ikbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list it, or list no cells and move one it
    reports."""
    bench = benchmark()
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def driver(ctx: Ctx):
    return importlib.import_module(f"ikbench.drivers.{ctx.traffic['kind']}")


def result(ctx: Ctx, rec: dict) -> dict:
    """The result line: metrics read from the record, the device, the
    check's numbers beside their limits (last)."""
    limits = ctx.frozen.get("limits", {})
    check = {}
    for name, value in rec["check"].items():
        if name not in limits:
            raise RuntimeError(f"no limit for {name!r} in "
                               f"cells/{ctx.workload}.json")
        check[name] = {"value": value, "limit": limits[name]}
    correct = all(c["value"] <= c["limit"] for c in check.values())
    metrics: Dict[str, dict] = {}
    for m in metrics_of(ctx.workload, ctx.trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device != "cpu" else "cpu",
              "kind": rec["device_name"], "count": rec["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if ctx.trace and rec.get("trace"):
        tr = rec["trace"]
        device["busy_s"] = tr.get("busy_us_cards", tr["busy_us"]) * 1e-6
        device["window_s"] = tr["window_us"] * 1e-6
        out["breakdown"] = {"device_ops": tr["top_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["check"] = check
    return out


def run(ctx: Ctx) -> dict:
    """Drive the cell and return its result line (no printing)."""
    rec = driver(ctx).run(ctx)
    return result(ctx, rec)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="ikbench: one cell, one run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda", t0)
    import torch

    # One process, one thread of host work: the steadiest load.
    torch.set_num_threads(1)
    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ikbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    print(f"ikbench: card {torch.cuda.get_device_name(0)}; nvidia-smi "
          f"{card_line()}; {torch.cuda.device_count()} visible, "
          f"{chips} used", file=sys.stderr, flush=True)
    out = run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"ikbench: the measured process holds {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
