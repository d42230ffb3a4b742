"""The harness finds every configuration, traffic mix, cell file and
metric by name, and a new one added as files alone is picked up."""

import ast
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys


from ikbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_name_resolves():
    bench = harness.benchmark()
    for w in bench["workloads"]:
        ctx = harness.context(w["name"], 1, 1.0, False, "cpu", 0.0)
        assert ctx.config["name"] == w["config"]
        assert (harness.HERE / "configs" / ctx.config["urdf"]).exists()
        assert harness.driver(ctx).run
        assert "limits" in ctx.frozen and ctx.frozen["limits"]
        for trace in (False, True):
            for m in harness.metrics_of(w["name"], trace):
                assert callable(harness.reader(m["name"]))
        assert harness.metrics_of(w["name"], True), w["name"]
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).exists()


def test_benchmark_file_shape():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 0.01 <= e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)


def _hashes(root: pathlib.Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


ADD = r'''
import json, sys, time
from ikbench import harness
ctx = harness.context("arm6.ik-burst", 5, 0.3, True, "cpu",
                      time.perf_counter(), {"fetch_every": 1,
                      "check_sample": 8, "trace_batches": 1})
assert ctx.config["name"] == "arm6" and ctx.traffic["batch"] == 8
names = [m["name"] for m in harness.metrics_of("arm6.ik-burst", True)]
assert "poses_per_call" in names, names
out = harness.run(ctx)
print(json.dumps(out))
'''


def test_new_config_mix_and_metric_are_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added to a
    copy as new files and BENCHMARK.json entries run with no existing file
    of the benchmark edited."""
    shutil.copytree(harness.HERE, tmp_path / "ikbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    before = _hashes(tmp_path / "ikbench")
    cfg = tmp_path / "ikbench" / "configs"
    base = json.loads((cfg / "panda7.json").read_text())
    base.update(name="arm6", urdf="arm6.urdf", base_link="base",
                ee_link="tool", dof=6)
    (cfg / "arm6.json").write_text(json.dumps(base))
    links = "".join(f'<link name="l{i}"/>' for i in range(1, 6))
    joints = "".join(
        f'<joint name="j{i}" type="revolute"><parent link="'
        f'{"base" if i == 0 else f"l{i}"}"/><child link="'
        f'{"tool" if i == 5 else f"l{i + 1}"}"/>'
        f'<origin xyz="0 0 0.2" rpy="0 0 0"/><axis xyz='
        f'"{"0 0 1" if i % 2 == 0 else "0 1 0"}"/>'
        f'<limit lower="-2" upper="2"/></joint>' for i in range(6))
    (cfg / "arm6.urdf").write_text(
        f'<robot name="arm6"><link name="base"/>{links}'
        f'<link name="tool"/>{joints}</robot>')
    (tmp_path / "ikbench" / "traffic" / "ik-burst.json").write_text(
        json.dumps({"kind": "ik_stream", "batch": 8, "pool": 2,
                    "fetch_every": 1, "check_sample": 8,
                    "trace_batches": 1}))
    (tmp_path / "ikbench" / "cells" / "arm6.ik-burst.json").write_text(
        json.dumps({"limits": {"mismatch_share": 0.5}}))
    (tmp_path / "ikbench" / "metrics" / "poses_per_call.py").write_text(
        "def read(rec):\n    return float(rec['batch'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "arm6", "source": "synthetic",
                             "file": "ikbench/configs/arm6.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "arm6.ik-burst", "config": "arm6",
                               "traffic": "ik-burst", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "solves_per_s":
            m["workloads"].append("arm6.ik-burst")
    bench["per_layer"].append({
        "name": "poses_per_call", "unit": "poses", "better": "higher",
        "source": "program_counter", "layer": "Facade",
        "moves": "solves_per_s", "workloads": ["arm6.ik-burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(harness.ROOT)]))
    out = subprocess.run([sys.executable, "-c", ADD], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["poses_per_call"]["value"] == 8.0
    after = _hashes(tmp_path / "ikbench")
    assert {k: v for k, v in after.items() if k in before} == before


def _imports(path: pathlib.Path):
    """The modules a file imports (absolute names; relative imports are
    the benchmark's own)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "optik_tpu",
                           "optik_tpu_torch"}, path


def test_nothing_imports_jax_or_the_old_harness():
    for path in harness.HERE.rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optik_tpu",
                               "bench", "benchmarks"), (path, mod)
            assert not mod.startswith("optik_tpu_torch.benchmarks"), path
