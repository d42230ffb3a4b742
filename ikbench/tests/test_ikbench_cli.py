"""The command fails without a card and without the program, and names no
module of JAX or of the JAX package in a run's process."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from ikbench import harness

CLI = ["ikbench/run.py", "--workload", "panda7.ik-stream", "--seed",
       "2147483999", "--seconds", "1", "--trace", "0"]


def _run(cwd, args, timeout=300, env=None):
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(harness.ROOT, CLI, env=env)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "needs 1 CUDA card" in out.stderr


def test_fails_with_only_its_own_files(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "ikbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(tmp_path, CLI, env=env)
    assert out.returncode != 0 and not out.stdout.strip()


REHEARSE = r'''
import json, sys, time
from ikbench import harness
from ikbench.tests.common import small_context, DIFFIK
# A CPU profile of the plain loop is large: trace one IK cell only.
for wl, cell, trace in [("panda7.ik-stream", None, True),
                        ("mobile_panda11.ik-stream", None, False),
                        ("panda7.ik-stream.4chip", None, False),
                        ("panda7.diffik-calls", DIFFIK, True)]:
    out = harness.run(small_context(wl, trace=trace, cell=cell))
    assert out["correct"], (wl, out["check"])
print(json.dumps(harness.forbidden_modules()))
'''


def test_rehearsal_loads_no_jax():
    """Every cell's code path on the CPU, then the process's modules: no
    top-level name is jax, jaxlib, flax or optik_tpu (optik_tpu_torch is
    the program)."""
    out = _run(harness.ROOT, ["-c", REHEARSE], timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "optik_tpu")


@pytest.mark.card
def test_a_run_on_the_card(card):
    out = _run(harness.ROOT, CLI, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check"
