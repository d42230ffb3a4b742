"""The port's public surface is annotated, and the annotations evaluate.

The four checks of tests/test_typing.py on ``optik_tpu_torch``:
``typing.get_type_hints`` resolves every public annotation of ``Robot``,
``SolverConfig`` and ``solver/ik`` at run time (undefined names, typos and
broken forward references raise), every reference ``SolverConfig`` field is
annotated, and the package exports its names, ``__version__`` and the PEP 561
``py.typed`` marker.
"""

import inspect
import pathlib
import typing

import pytest

import optik_tpu_torch
from optik_tpu_torch import config as config_mod
from optik_tpu_torch import robot as robot_mod
from optik_tpu_torch.solver import ik as ik_mod


def _check_callable(fn, where):
    try:
        return typing.get_type_hints(fn)
    except Exception as exc:  # an annotation that does not evaluate
        pytest.fail(f"{where}: annotation failed to evaluate: {exc!r}")


def test_public_robot_annotations_evaluate():
    checked = 0
    for name, member in inspect.getmembers(robot_mod.Robot):
        if not name.startswith("_") and inspect.isfunction(member):
            hints = _check_callable(member, f"Robot.{name}")
            checked += 1
            if name in ("ik", "ik_batch", "fk", "diff_ik", "diff_ik_batch"):
                assert "return" in hints, f"Robot.{name} has no return type"
    assert checked >= 10


def test_config_annotations_evaluate():
    hints = typing.get_type_hints(config_mod.SolverConfig)
    for field in ("solution_mode", "max_time", "max_restarts", "tol_f",
                  "tol_df", "tol_dx", "linear_weight", "angular_weight",
                  "max_iters", "seed_batch", "rng_seed"):
        assert field in hints, f"SolverConfig.{field} missing annotation"


def test_module_surface_annotations_evaluate():
    for mod, names in ((robot_mod, ("_parse_pose",)),
                       (ik_mod, ("build_batch_solver", "ik_one",
                                 "ik_batch", "restart_seeds", "select"))):
        for name in names:
            fn = getattr(mod, name)
            target = getattr(fn, "__wrapped__", fn)
            assert inspect.isfunction(target), f"{mod.__name__}.{name}"
            _check_callable(target, f"{mod.__name__}.{name}")


def test_package_exports_exist():
    for name in ("Robot", "SolverConfig", "SolutionMode", "__version__"):
        assert hasattr(optik_tpu_torch, name)
        assert name in optik_tpu_torch.__all__
    assert optik_tpu_torch.__version__ == "0.1.0"
    root = pathlib.Path(optik_tpu_torch.__file__).parent
    assert (root / "py.typed").exists()
