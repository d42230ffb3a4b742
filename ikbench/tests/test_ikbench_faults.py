"""The check fails the control and every fault the cells can have, at a
size a CPU run holds; a sound run passes it.

The control is the reference in bfloat16 put in the program's place; the
faults are planted under the timed path (``tests/faults.py``)."""

import pytest
import torch

from ikbench import harness
from optik_tpu_torch import Robot
from optik_tpu_torch.parallel import mesh as mesh_mod

from .common import DIFFIK, small_context


@pytest.fixture
def restore():
    saved = (Robot.ik_batch, Robot.diff_ik_batch, mesh_mod.Mesh.merge)
    yield
    Robot.ik_batch, Robot.diff_ik_batch, mesh_mod.Mesh.merge = saved


def _correct(workload, patch=None, cell=None):
    out = harness.run(small_context(workload, patch=patch, cell=cell))
    return out["correct"], out["check"]


@pytest.mark.parametrize("workload, cell", [
    ("panda7.ik-stream", None), ("mobile_panda11.ik-stream", None),
    ("panda7.diffik-calls", DIFFIK)])
def test_sound_run_is_correct(workload, cell):
    ok, numbers = _correct(workload, cell=cell)
    assert ok, numbers


@pytest.mark.parametrize("fault", ["ik_state_unchanged", "ik_half_batch",
                                   "ik_answer_altered"])
def test_ik_faults_are_not_correct(fault, restore):
    ok, numbers = _correct("panda7.ik-stream",
                           f"ikbench.tests.faults:{fault}")
    assert not ok, numbers


@pytest.mark.parametrize("fault", ["diffik_state_unchanged",
                                   "diffik_half_batch",
                                   "diffik_answer_altered"])
def test_diffik_faults_are_not_correct(fault, restore):
    ok, numbers = _correct("panda7.diffik-calls",
                           f"ikbench.tests.faults:{fault}", DIFFIK)
    assert not ok, numbers


def test_mesh_exchange_left_out_is_not_correct():
    """Four gloo ranks on the CPU; each rank's merge skips its
    collectives."""
    ok, numbers = _correct("panda7.ik-stream.4chip",
                           "ikbench.tests.faults:mesh_exchange_left_out")
    assert not ok, numbers


@pytest.mark.parametrize("workload, cell", [
    ("panda7.ik-stream", None), ("panda7.diffik-calls", DIFFIK),
    ("panda7.ik-stream.4chip", None)])
def test_control_is_not_correct(workload, cell):
    ctx = small_context(workload, cell=cell)
    numbers, _ = harness.driver(ctx).control(ctx, torch.device("cpu"))
    limits = ctx.frozen["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
